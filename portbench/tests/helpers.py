"""A small checkout for the benchmark's CPU tests: `BENCHMARK.json` and a
copy of `portbench/` in a temporary directory, with tiny cells added as
files and entries, the way a later change adds a cell."""

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

TINY_POOL = {"n_var": 120, "n_cell": 400, "n_donor": 4, "doublet_rate": 0.08,
             "density": 0.3, "mean_extra_depth": 0.6}
# a heavy-tailed pool: 5% of the covered entries 200-1999 reads deeper
TINY_HEAVY_POOL = {"n_var": 120, "n_cell": 400, "n_donor": 4,
                   "doublet_rate": 0.08, "density": 0.3,
                   "mean_extra_depth": 3.0, "max_depth": 16,
                   "hot_share": 0.05, "hot_depth": [200, 2000],
                   "theta": [0.02, 0.5, 0.98]}
TINY_FITS = {
    "vireo_wrap": {"n_donor": 4, "n_init": 8, "max_iter_init": 20,
                   "delay_fit_theta": 3, "check_doublet": True},
    "sweep_n_donor": {"n_donor_list": [3, 4, 5], "n_init": 4,
                      "max_iter_init": 20, "delay_fit_theta": 3},
}


def tiny_checkout(tmp, entry="vireo_wrap", traffic="from_host",
                  cell="tiny.cell", pool=TINY_POOL):
    """A checkout under `tmp` with the cell `cell` of a tiny pool (the
    configuration's `pool` keys) run by `entry` under `traffic`, added
    as a configuration, a workload file and entries of BENCHMARK.json;
    returns its root."""
    root = Path(tmp) / "checkout"
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    name = cell.split(".")[0] + "_cfg"
    (root / "portbench" / "configs" / (name + ".json")).write_text(
        json.dumps({"name": name, "pool": pool, "entry": entry,
                    "fit": TINY_FITS[entry]}))
    like = "ksweep16.placed" if entry == "sweep_n_donor" \
        else "pool16.from_host"
    limits = json.loads((BENCH / "workloads" / (like + ".json")).read_text())
    (root / "portbench" / "workloads" / (cell + ".json")).write_text(
        json.dumps(limits))
    spec["configs"].append({"name": name, "source": "tests",
                            "file": "portbench/configs/%s.json" % name,
                            "reduced": [], "why": "a tiny pool"})
    spec["workloads"].append({"name": cell, "config": name,
                              "traffic": traffic, "chips": 1,
                              "why": "a tiny pool on the CPU"})
    for m in spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root
