"""What the harness reads by name: `BENCHMARK.json` at the checkout's
root, and under `portbench/` each configuration, traffic mix, cell,
entry, metric reader and work function in a file of its own.

- `configs/<config>.json`: the deployment (the pool's shape, the entry
  it runs and that entry's arguments);
- `traffic/<traffic>.json`: how the jobs are fed (`"input"`: `host`
  scipy matrices, or counts `placed` once in set-up);
- `workloads/<cell>.json`: the cell's limits on the numbers compared;
- `entries/<entry>.py`: the job, its reference and its comparison;
- `metrics/<metric>.py`: a per-layer metric's reader, `read(ctx)`.
"""

import importlib.util
import json
from pathlib import Path

__all__ = ["BENCH_DIR", "Manifest", "load_module"]

BENCH_DIR = Path(__file__).resolve().parent.parent


def load_module(path):
    """The Python file `path` as a module of its own."""
    path = Path(path)
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.parent.name + "_" + path.stem.replace(".", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path):
    with open(path) as f:
        return json.load(f)


class Manifest:
    """`BENCHMARK.json` under `root` (default: this checkout) and the
    benchmark's files beside it."""

    def __init__(self, root=None):
        self.root = Path(root) if root else BENCH_DIR.parent
        self.bench_dir = self.root / BENCH_DIR.name
        self.spec = _json(self.root / "BENCHMARK.json")

    def cell(self, name):
        """The cell `name`: dict(name, config, traffic, chips, limits,
        end_to_end, per_layer), its metrics the ones that apply to it."""
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError("no workload %r in BENCHMARK.json (%s)"
                           % (name, ", ".join(sorted(cells))))
        w = cells[name]
        configs = {c["name"]: c for c in self.spec["configs"]}
        config = _json(self.root / configs[w["config"]]["file"])
        traffic = _json(self.bench_dir / "traffic" / (w["traffic"] + ".json"))
        limits = _json(self.bench_dir / "workloads" / (name + ".json"))

        def applies(m):
            return name in m.get("workloads", [name])
        return dict(name=name, config=config, traffic=traffic,
                    chips=int(w["chips"]), limits=limits["limits"],
                    end_to_end=[m for m in self.spec["end_to_end"]
                                if applies(m)],
                    per_layer=[m for m in self.spec["per_layer"]
                               if applies(m)])

    def entry(self, name):
        return load_module(self.bench_dir / "entries" / (name + ".py"))

    def reader(self, metric):
        return load_module(self.bench_dir / "metrics" / (metric + ".py"))

    def work(self, name):
        return load_module(self.bench_dir / "work" / (name + ".py"))

    def peaks(self, card_name):
        """The published peaks of the card named `card_name`."""
        table = _json(self.bench_dir / "work" / "peaks.json")["cards"]
        for key, peaks in table.items():
            if key in card_name:
                return peaks
        return None
