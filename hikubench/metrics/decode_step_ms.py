"""decode_step_ms: one decode step on the card, the mean over the warm
requests served with the profiler off of the device interval of their
decode replays (CUDA events the program records in ``Instance.generate``,
after the prefill's argmax to after the last replay) over the number of
replays, from the program's own request records."""

from hikubench import program_spans


def read(run):
    recs = program_spans.untraced(run, cold=False)
    if recs is None:
        return None
    return program_spans.mean(r.decode_ms / r.replays for r in recs
                              if r.decode_ms is not None and r.replays)
