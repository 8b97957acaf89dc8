"""contraction_roofline: the share of their least time that the count
contractions take, in %: the sum over the traced window's contraction
calls of the least time the inputs' nonzeros need
(`work/contraction.py`, at the card's published peaks), over the sum
of the device time of the same calls."""


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    calls = [c for c in ctx.trace.calls if c[4] > 0]
    if not calls:
        return None
    work = ctx.work("contraction")
    least = sum(work.least_seconds(kind, n, v, c, ctx.pool["nnz_ad"],
                                   ctx.pool["nnz_dp"], ctx.peaks)[0]
                for kind, n, v, c, _, _ in calls)
    return 100.0 * least / sum(c[4] for c in calls)
