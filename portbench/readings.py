"""The readings that a cell's limits are set from: on each seed, the
numbers compared for the program's sound run and for the control.

    python3 portbench/readings.py --workload <cell> --seeds 11,12,13 \
        [--arith tf32,float32]

The program runs one job of the cell on the seed's pool, as the
benchmark's window does (placing its own counts under host traffic),
and is compared with the plain reference (float64), its placement and
its contractions at each width too (`harness/sampled.py`). Each seed
starts on an emptied card, and its job must place its counts as a
placement alone does (`run_cell.layout`).
The control is the reference itself put in the program's place in the
nearest precision below the configuration's (float32 with TF32 off):
float32 with the contractions' operands rounded to TF32. It is compared
with the float64 reference in the same way, and repeats the program's
kept contractions on the same weights. One JSON line per seed and side;
nothing is timed. Needs a CUDA card (or VIREO_PLATFORM=cpu and --device
cpu for a rehearsal at a tiny size through --root).

    python3 portbench/readings.py --peak --workload <cell> --seeds 11,12

prints instead, for each seed, the peak device memory of one job as
`run_cell` measures it (`peak_mem_gib`): the seed's pool and placement,
one warm-up job, the peak statistics reset, one job,
`torch.cuda.max_memory_allocated`. It runs no reference and no control.
Beside the peak it gives the placed layout and, for each fit of several
restarts in the job, how many restarts it had, the iteration at which
the first of them stopped, how many ran past it and how many ran each
iteration from then on (each such iteration copies the running
restarts). On the CPU the peak reads 0.
`run_spread` and `widest_run_spread` give the spread of such peaks as
the benchmark's check reads it, over a set of runs.
"""

import argparse
import gc
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(workload, seed, arith=("tf32",), device=None, root=None,
             log=print):
    """[(side, numbers)] of one seed: the program's, then the
    reference's in each arithmetic of `arith` in its place ("tf32": the
    control)."""
    import torch
    from portbench.harness.manifest import Manifest
    from portbench.harness.pool import make_pool, to_host
    from portbench.harness.run_cell import (_HeldPlacement,
                                            _placement_mismatch, layout)
    from portbench.harness.sampled import Sampled, widest_gap
    from portbench.reference.counts import Arith, RefCounts
    from vireo_tpu_torch.ops.counts import counts_from_scipy

    def free():
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    manifest = Manifest(root)
    cell = manifest.cell(workload)
    config, traffic = cell["config"], cell["traffic"]
    entry = manifest.entry(config["entry"])
    fit_seed = int(seed) % (1 << 32)
    # the program picks its layout from the card's free memory: every
    # seed finds the card as the first seed did
    free()
    pool = make_pool(seed=seed, device=device, **config["pool"])
    AD, DP = to_host(pool)
    del pool

    placed = counts_from_scipy(AD, DP, device=device)
    placed_layout = layout(placed)
    sampled = Sampled()
    sampled.install(type(placed))
    held = _HeldPlacement()
    with held:
        if traffic["input"] == "placed":
            inputs = (placed, None)
            held.counts = placed
        else:
            # the job places its own counts, as the window's jobs do;
            # the placement above only tells their layout
            inputs, placed = (AD, DP), None
            free()
        t0 = time.perf_counter()
        try:
            result, _ = entry.job(inputs, config, fit_seed)
        finally:
            sampled.remove()
    log("[readings] seed %d: the program's job %.3f s, counts placed as %s"
        % (seed, time.perf_counter() - t0, layout(held.counts)))
    if layout(held.counts) != placed_layout:
        raise RuntimeError("the job placed its counts as %s, a placement "
                           "alone as %s" % (layout(held.counts),
                                            placed_layout))
    counts = RefCounts(AD, DP, device)
    mismatch = _placement_mismatch(held.counts, counts)
    inputs = placed = held.counts = None
    free()

    f64 = Arith("float64")
    out = []
    t0 = time.perf_counter()
    want = entry.reference(counts, config, fit_seed, f64, device)
    out.append(("program", dict(
        entry.compare(result, want), placement=mismatch,
        contraction=widest_gap(sampled.calls, counts))))
    for name in arith:
        other = entry.reference(counts, config, fit_seed, Arith(name),
                                device)
        out.append((name, dict(
            entry.compare(other, want),
            contraction=widest_gap(sampled.calls, counts, Arith(name)))))
    log("[readings] seed %d: reference and control %.3f s"
        % (seed, time.perf_counter() - t0))
    return out


def run_spread(values):
    """The spread of one set of runs: max minus min over the median,
    leaving out the run farthest from the median where that narrows
    it."""
    med = statistics.median(values)
    far = max(values, key=lambda v: abs(v - med))
    rest = list(values)
    rest.remove(far)
    return min(max(values) - min(values), max(rest) - min(rest)) / med


def widest_run_spread(values, n=6):
    """The widest `run_spread` over every run of `n` consecutive
    values."""
    return max(run_spread(values[i:i + n])
               for i in range(len(values) - n + 1))


class _FitWatch:
    """Notes, for each fit of several restarts, how many restarts it
    had, the iteration at which the first stopped, how many ran past it
    and how many ran each iteration from then on; keeps no tensor of
    the fit."""

    def __init__(self):
        self.fits = []

    def __enter__(self):
        from vireo_tpu_torch.models import vireo
        self._owner, self._real = vireo, vireo.converge
        watch = self

        def converge(*args, **kwargs):
            out = watch._real(*args, **kwargs)
            it = out[3]
            if getattr(it, "ndim", 0) == 1:
                first = int(it.min())
                running = [int((it > k).sum())
                           for k in range(first, int(it.max()))]
                watch.fits.append(dict(restarts=int(it.size),
                                       first_stop=first,
                                       past_first_stop=running[0]
                                       if running else 0,
                                       running=running))
            return out
        vireo.converge = converge
        return self

    def __exit__(self, *exc):
        self._owner.converge = self._real
        return False


def peak_readings(workload, seeds, device=None, root=None, log=print):
    """For each seed, the peak device memory of one job of the cell, as
    `run_cell` measures it over its window: set up as it does, one
    warm-up job, the peak reset, one job."""
    import torch
    from portbench.harness.manifest import Manifest
    from portbench.harness.pool import make_pool, to_host
    from portbench.harness.run_cell import _HeldPlacement, _sync, layout

    manifest = Manifest(root)
    cell = manifest.cell(workload)
    config, traffic = cell["config"], cell["traffic"]
    entry = manifest.entry(config["entry"])
    card = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    for seed in seeds:
        fit_seed = int(seed) % (1 << 32)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        pool = make_pool(seed=seed, device=device, **config["pool"])
        # the truth stays on the device through the job, as in a run
        truth = {k: pool[k] for k in ("donor", "donor2", "GT")}
        AD, DP = to_host(pool)
        del pool
        _sync(device)
        held = _HeldPlacement()
        with held:
            if traffic["input"] == "placed":
                from vireo_tpu_torch.ops.counts import counts_from_scipy
                held.counts = counts_from_scipy(AD, DP, device=device)
                inputs = (held.counts, None)
            else:
                inputs = (AD, DP)
            entry.job(inputs, config, fit_seed)
            _sync(device)
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            with _FitWatch() as watch:
                entry.job(inputs, config, fit_seed)
                _sync(device)
            peak = torch.cuda.max_memory_allocated(device) \
                if device.type == "cuda" else 0
            placed_layout = layout(held.counts)
        log("[readings] seed %d: the job %.3f s, peak %d bytes"
            % (seed, time.perf_counter() - t0, peak))
        inputs = held.counts = truth = None
        yield dict(workload=workload, seed=seed, peak_mem_gib=peak / 2**30,
                   peak_bytes=int(peak), device=card,
                   layout=list(placed_layout),
                   fits=watch.fits)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--arith", default="tf32",
                        help="the arithmetics put in the program's place, "
                        "comma-separated (tf32: the control; float32: "
                        "float32 without TF32, for comparison); none: "
                        "the program alone")
    parser.add_argument("--peak", action="store_true",
                        help="the peak device memory of one job a seed, "
                        "and nothing compared")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--root", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.peak:
        for line in peak_readings(args.workload, seeds, device, args.root,
                                  log=lambda m: print(m, file=sys.stderr)):
            print(json.dumps(line), flush=True)
        return 0
    for seed in seeds:
        arith = [] if args.arith == "none" else args.arith.split(",")
        for side, numbers in readings(args.workload, seed, arith, device,
                                      args.root):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, "numbers": numbers}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
