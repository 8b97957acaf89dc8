"""suff_calls: calls of the counts' `suff_stats` a job makes (one for
each EM iteration of a fit, whatever the number of restarts it
carries, and the doublet phase's genotype refresh), counted by the
harness's wrapper of the counts class in the traced window, per job."""


def read(ctx):
    if ctx.trace is None or not ctx.jobs:
        return None
    n = sum(1 for c in ctx.trace.calls if c[0] == "suff_stats")
    return n / len(ctx.jobs)
