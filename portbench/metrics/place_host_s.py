"""place_host_s: seconds a job leaves the device idle while the host
does placement's work before its first upload: the traced window's
idle gaps whose innermost host span is the program's
`vireo.place.union` (the union of AD's and DP's patterns) or
`vireo.place.rung` (the value range, the budget and the rung), per job.
Nothing when the trace holds no device operation (a run on the CPU),
or when no idle gap lies under those spans (a program without them)."""

SPANS = ("vireo.place.union", "vireo.place.rung")


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0 or not ctx.jobs:
        return None
    mine = [t for name, t in ctx.trace.idle_gaps if name in SPANS]
    return sum(mine) / len(ctx.jobs) if mine else None
