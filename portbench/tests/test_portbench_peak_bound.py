"""The bound of `peak_mem_gib` against the program's peak read seed by
seed (`readings.py --peak`, kept in `portbench/readings/peak_mem.jsonl`):

- `run_spread` is the check's spread of a set of runs: max minus min
  over the median, the run farthest from the median left out where
  that narrows it; `widest_run_spread` the widest over every six
  consecutive seeds;
- the bound in `BENCHMARK.json` is at least twice the widest six-run
  spread of each cell's kept peaks, so that runs of one commit do not
  spread past half of it;
- `readings.py --peak` prints one line a seed, here on the CPU at a tiny
  size (the peak reads 0 there). The harness refuses a process that
  holds JAX, so the readings run in a child process.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from helpers import tiny_checkout
from portbench.readings import run_spread, widest_run_spread

ROOT = Path(__file__).resolve().parent.parent.parent
PEAKS = ROOT / "portbench" / "readings" / "peak_mem.jsonl"
# the bounds the peak may take, and the seeds a cell needs to set one
STEPS = (0.05, 0.06, 0.08, 0.10)
SEEDS = {"pool16.from_host": 24, "pool16.placed": 24}


def _bound():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    return next(m["bound"] for m in spec["end_to_end"]
                if m["name"] == "peak_mem_gib")


def _peaks():
    """{cell: [peak in GiB, in the order of the seeds]}"""
    rows = [json.loads(line) for line in PEAKS.read_text().splitlines()
            if line.strip()]
    cells = {}
    for r in sorted(rows, key=lambda r: r["seed"]):
        cells.setdefault(r["workload"], []).append(r["peak_mem_gib"])
    return cells


def test_run_spread_leaves_out_the_farthest_run():
    # one far run: left out
    assert run_spread([10.0, 10.1, 10.05, 10.1, 10.0, 11.0]) == \
        pytest.approx(0.1 / 10.075)
    # left out only where that narrows the spread: not where the other
    # end is held twice
    assert run_spread([9.0, 9.0, 10.0, 11.0, 11.0]) == pytest.approx(0.2)
    assert run_spread([8.0] * 6) == 0.0


def test_widest_run_spread_takes_every_six_consecutive_seeds():
    flat = [10.0] * 6
    # two far runs in one six: the farthest goes, the other stays
    values = flat + [10.0, 10.5, 10.0, 10.0, 9.5, 10.0] + flat
    assert widest_run_spread(values) == pytest.approx(0.5 / 10.0)
    assert widest_run_spread(flat + flat) == 0.0
    assert widest_run_spread(values, n=5) == pytest.approx(0.05)
    assert widest_run_spread(values, n=3) == 0.0


def test_the_bound_holds_the_kept_peaks():
    bound = _bound()
    assert bound in STEPS
    cells = _peaks()
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(cells) == {w["name"] for w in spec["workloads"]}
    for cell, peaks in cells.items():
        assert len(peaks) >= SEEDS.get(cell, 6), cell
        assert min(peaks) > 0, cell
        assert bound >= 2 * widest_run_spread(peaks), cell
    # the smallest step that holds them
    widest = max(widest_run_spread(p) for p in cells.values())
    assert bound == min(s for s in STEPS if s >= 2 * widest)


def test_the_peak_readings_print_one_line_a_seed(tmp_path):
    root = tiny_checkout(tmp_path)
    seeds = [2**31 + 5, 7]
    env = dict(os.environ, VIREO_PLATFORM="cpu")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "readings.py"), "--peak",
         "--workload", "tiny.cell", "--seeds", ",".join(map(str, seeds)),
         "--device", "cpu", "--root", str(root)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [r["seed"] for r in lines] == seeds
    for r in lines:
        assert r["workload"] == "tiny.cell" and r["device"] == "cpu"
        assert r["peak_mem_gib"] == 0.0 and r["peak_bytes"] == 0
        assert r["layout"][0] == "DenseCounts"
        # the warm fit of the tiny cell's 8 restarts
        warm = r["fits"][0]
        assert warm["restarts"] == 8
        assert 0 <= warm["past_first_stop"] < warm["restarts"]
