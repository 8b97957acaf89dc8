"""device_idle: the share of the traced window, in %, in which no
device operation (kernel, memcpy, memset) runs: one less the union of
the profiler's device intervals over the window's length. Nothing when
the trace holds no device operation (a run on the CPU)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
