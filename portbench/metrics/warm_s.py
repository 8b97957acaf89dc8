"""warm_s: seconds a job spends in `vireo_wrap`'s `warm_restarts` phase
(the seeded inits and the batched warm fits of every restart), the mean
over the traced window's jobs. Source: the program's phase timer."""


def read(ctx):
    vals = [j["phases"]["warm_restarts"] for j in ctx.jobs
            if "warm_restarts" in j["phases"]]
    return sum(vals) / len(vals) if vals else None
