"""cold_start_pct: the share of the window's requests in which the harness
saw an instance built (the check holds each to the reference cluster's
cold or warm outcome)."""


def read(run):
    return 100.0 * sum(r.built > 0 for r in run.requests) / len(run.requests)
