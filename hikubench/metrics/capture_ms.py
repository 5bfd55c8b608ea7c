"""capture_ms: a cold start's decode-graph capture, the mean of the
program's ``capture`` span (``Instance.prepare``: the decode cache, one
eager call on a side stream, the CUDA graph capture, a synchronise) over
the cold requests served with the profiler off, from the program's own
request records."""

from hikubench import program_spans


def read(run):
    recs = program_spans.untraced(run, cold=True)
    return None if recs is None else program_spans.mean(r.span_ms("capture") for r in recs)
