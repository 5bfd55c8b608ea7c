"""flash_attention_roofline: the prefill's attention kernel, one call an
attention application.  The least time of the traced requests'
calls (each call's bytes and operations from the frozen counts at the
shapes and lengths the request implies, against 3.35 TB/s and the TF32
495 TFLOP/s) over the device time of the kernels named so that ran inside
those requests' ``Instance.generate`` spans, in %.  None where no such
kernel ran."""

from hikubench import counts, trace

KERNEL = "flash_attention"
PATTERN = r"flash_attention_kernel"


def read(run):
    if run.trace is None:
        return None
    spans = trace.span_intervals(run.trace, "generate")
    seconds, n = trace.kernel_seconds(run.trace, PATTERN, spans)
    if not n:
        return None
    least = sum(counts.bound_s(b, o) for r in run.requests if r.traced
                for b, o in counts.kernel_work(run.model, r.prompt_len, r.gen_len,
                                          run.max_cache_len).get(KERNEL, []))
    return 100.0 * least / seconds
