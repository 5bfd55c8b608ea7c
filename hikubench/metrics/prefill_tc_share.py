"""prefill_tc_share: the share, in %, of the dense products of the warm
requests served with the profiler off that ran on the tensor-core kernel
(``linear_tf32x3``): the sum of their records' ``products_tc`` over the sum
of ``products_tc`` and ``products_other``, from the program's own request
records.  None where the records do not count products (a program without
the counts) or count none."""

from hikubench import program_spans


def read(run):
    recs = program_spans.untraced(run, cold=False)
    if not recs or not all(hasattr(r, "products_tc") and hasattr(r, "products_other")
                           for r in recs):
        return None
    tc = sum(r.products_tc for r in recs)
    total = tc + sum(r.products_other for r in recs)
    return 100.0 * tc / total if total else None
