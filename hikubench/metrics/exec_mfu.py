"""exec_mfu: the served model step's share of the card's peak, the model
operations of the requests served with the profiler off (``counts.
request_flops``: their prefills and decode steps) over the sum of their
``exec_ms``, against the TF32 peak (495 TFLOP/s), in %."""

from hikubench import counts


def read(run):
    rs = run.untraced()
    if not rs:
        return None
    ops = sum(counts.request_flops(run.model, r.prompt_len, r.gen_len, run.max_cache_len)
              for r in rs)
    return 100.0 * ops / (sum(r.exec_ms for r in rs) * 1e-3) / counts.PEAK_F32_OPS_PER_S
