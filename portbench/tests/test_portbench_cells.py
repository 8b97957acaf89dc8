"""A cell added as files and entries alone runs: a configuration, a
workload file and entries of BENCHMARK.json, no edit of a file the
benchmark has. Run here on the CPU at a tiny size, the harness's look
for a card skipped."""

import json
import time

import pytest
import torch

from helpers import tiny_checkout
from portbench.harness.manifest import Manifest
from portbench.harness.run_cell import run_cell


def _run(root, trace, seed=2**31 + 5):
    return run_cell("tiny.cell", seed, 0.3, trace, torch.device("cpu"),
                    time.perf_counter(), root=root, log=lambda m: None)


@pytest.mark.parametrize("entry,traffic", [
    ("vireo_wrap", "from_host"), ("vireo_wrap", "placed"),
    ("sweep_n_donor", "placed")])
@pytest.mark.parametrize("trace", [False, True])
def test_an_added_cell_runs(tmp_path, entry, traffic, trace):
    root = tiny_checkout(tmp_path, entry=entry, traffic=traffic)
    out, lines = _run(root, trace)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    cell = Manifest(root).cell("tiny.cell")
    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    names = [m["name"] for m in wanted]
    # on the CPU the device readers find nothing to read
    expect = {"answer_s", "setup_s", "peak_mem_gib"} if not trace else (
        {"suff_calls"} | ({"placement_s", "warm_s"}
                          if entry == "vireo_wrap" else set()))
    assert set(out["metrics"]) == expect & set(names)
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(cell["limits"])
    assert lines[-1] == "[check] correct True"
    json.dumps(out)
    if trace:
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_every_declared_file_is_there():
    m = Manifest()
    for w in m.spec["workloads"]:
        cell = m.cell(w["name"])
        m.entry(cell["config"]["entry"])
        assert set(cell["limits"]), w["name"]
    for metric in m.spec["per_layer"]:
        assert hasattr(m.reader(metric["name"]), "read")
