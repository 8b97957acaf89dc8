"""contraction_ms: device milliseconds of the count contractions a job
makes: every device operation launched inside a call of the counts'
`suff_stats` or `cell_loglik`, from the profiler's trace, per job."""


def read(ctx):
    if ctx.trace is None or not ctx.jobs \
            or not any(c[5] for c in ctx.trace.calls):
        return None
    return 1e3 * sum(c[4] for c in ctx.trace.calls) / len(ctx.jobs)
