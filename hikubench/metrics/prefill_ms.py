"""prefill_ms: the served prefill on the card, the mean device interval
from before the prefill to after its argmax (CUDA events the program
records in ``Instance.generate``) over the warm requests served with the
profiler off, from the program's own request records."""

from hikubench import program_spans


def read(run):
    recs = program_spans.untraced(run, cold=False)
    return None if recs is None else program_spans.mean(r.prefill_ms for r in recs)
