"""placement_s: seconds a job spends in `vireo_wrap`'s `data_placement`
phase (host matrices to counts on the card, `counts_from_scipy`; a
counts object placed beforehand passes straight through), the mean
over the traced window's jobs. Source: the program's phase timer, each
phase ending in a device sync."""


def read(ctx):
    vals = [j["phases"]["data_placement"] for j in ctx.jobs
            if "data_placement" in j["phases"]]
    return sum(vals) / len(vals) if vals else None
