"""capture_idle_share: from the device trace, the share of the union of
the traced cold requests' ``capture`` spans (the program's own, stamped on
the profiler's clock) in which no operation ran on the card, in %.  None
where the trace holds no device operation or no such span."""

from hikubench import program_spans, trace


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    spans = program_spans.traced_spans_s(run, "capture", cold=True)
    share = trace.idle_share(run.trace, spans) if spans else None
    return None if share is None else 100.0 * share
