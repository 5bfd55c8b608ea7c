"""materialise_ms: a cold start's materialisation, the mean of the
program's ``materialise`` span (``Instance.__init__``: the model built, its
weights drawn on the card, a synchronise) over the cold requests served
with the profiler off, from the program's own request records."""

from hikubench import program_spans


def read(run):
    recs = program_spans.untraced(run, cold=True)
    return None if recs is None else program_spans.mean(r.span_ms("materialise") for r in recs)
