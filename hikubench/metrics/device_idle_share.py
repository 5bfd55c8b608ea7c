"""device_idle_share: from the traced requests' device trace, the share of
the union of their spans (``submit`` called to returned) in which no
operation ran on the card, in %.  Arrival gaps between requests are not in
it.  None where the trace holds no device operation at all (a run without
a card)."""

from hikubench import trace


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    share = trace.idle_share(run.trace, trace.span_intervals(run.trace, "request"))
    return None if share is None else 100.0 * share
