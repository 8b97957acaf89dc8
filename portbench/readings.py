"""The readings that a cell's limits are set from: on each seed, the
numbers compared for the program's sound run and for the control.

    python3 portbench/readings.py --workload <cell> --seeds 11,12,13 \
        [--arith tf32,float32]

The program runs one job of the cell on the seed's pool, as the
benchmark's window does, and is compared with the plain reference
(float64), its contractions at each width too (`harness/sampled.py`).
The control is the reference itself put in the program's place in the
nearest precision below the configuration's (float32 with TF32 off):
float32 with the contractions' operands rounded to TF32. It is compared
with the float64 reference in the same way, and repeats the program's
kept contractions on the same weights. One JSON line per seed and side;
nothing is timed. Needs a CUDA card (or VIREO_PLATFORM=cpu and --device
cpu for a rehearsal at a tiny size through --root).
"""

import argparse
import gc
import json
import os
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
    from portbench.harness.run_cell import _placement_mismatch
    from portbench.harness.sampled import Sampled, widest_gap
    from portbench.reference.counts import Arith, RefCounts

    manifest = Manifest(root)
    cell = manifest.cell(workload)
    config, traffic = cell["config"], cell["traffic"]
    entry = manifest.entry(config["entry"])
    fit_seed = int(seed) % (1 << 32)
    pool = make_pool(seed=seed, device=device, **config["pool"])
    AD, DP = to_host(pool)
    del pool

    from vireo_tpu_torch.ops.counts import counts_from_scipy
    placed = counts_from_scipy(AD, DP, device=device)
    inputs = (placed, None) if traffic["input"] == "placed" else (AD, DP)
    sampled = Sampled()
    sampled.install(type(placed))
    t0 = time.perf_counter()
    try:
        result, _ = entry.job(inputs, config, fit_seed)
    finally:
        sampled.remove()
    log("[readings] seed %d: the program's job %.3f s"
        % (seed, time.perf_counter() - t0))
    counts = RefCounts(AD, DP, device)
    mismatch = _placement_mismatch(placed, counts)
    inputs = placed = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--arith", default="tf32",
                        help="the arithmetics put in the program's place, "
                        "comma-separated (tf32: the control; float32: "
                        "float32 without TF32, for comparison); none: "
                        "the program alone")
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
    for seed in (int(s) for s in args.seeds.split(",")):
        arith = [] if args.arith == "none" else args.arith.split(",")
        for side, numbers in readings(args.workload, seed, arith, device,
                                      args.root):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, "numbers": numbers}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
