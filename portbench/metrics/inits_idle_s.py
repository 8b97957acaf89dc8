"""inits_idle_s: seconds a job leaves the device idle while the host is
in the program's seeded inits: the traced window's idle gaps whose
innermost host span is `vireo.inits` or one of its sub-spans
(`vireo.inits.plan`, `.stream`, `.normalise`, `.host`), per job.
Nothing when the trace holds no device operation (a run on the CPU),
or when no idle gap lies under those spans (a program without them)."""

SPAN = "vireo.inits"


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0 or not ctx.jobs:
        return None
    mine = [t for name, t in ctx.trace.idle_gaps
            if name == SPAN or name.startswith(SPAN + ".")]
    return sum(mine) / len(ctx.jobs) if mine else None
