"""A cell added as files and entries alone runs: a configuration, a
workload file and entries of BENCHMARK.json, no edit of a file the
benchmark has, a heavy-tailed pool's too. Run here on the CPU at a tiny
size, the harness's look for a card skipped."""

import json
import time

import pytest
import torch

from helpers import TINY_HEAVY_POOL, tiny_checkout
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


@pytest.mark.parametrize("traffic", ["from_host", "placed"])
def test_an_added_heavy_cell_runs(tmp_path, monkeypatch, traffic):
    """Counts above 256: the program places them dense in float32, and
    the reference holds them exactly."""
    from vireo_tpu_torch.ops import counts
    placed = []

    def place(*args, **kwargs):
        out = real(*args, **kwargs)
        placed.append(out)
        return out
    real = counts.counts_from_scipy
    monkeypatch.setattr(counts, "counts_from_scipy", place)
    root = tiny_checkout(tmp_path, traffic=traffic, pool=TINY_HEAVY_POOL)
    out, lines = _run(root, False)
    assert out["correct"] and out["failed"] == 0, lines
    assert out["checks"]["placement"]["value"] == 0
    assert placed and all(isinstance(c, counts.DenseCounts)
                          and c.ad.dtype == c.dp.dtype == torch.float32
                          for c in placed)
    assert max(float(c.dp.max()) for c in placed) > 256


def test_a_check_job_on_another_layout_is_refused(tmp_path, monkeypatch):
    """The check's job must place its counts as the window's jobs did:
    here it is sent to the COO rung by a budget of one byte."""
    from portbench.harness import run_cell as rc
    from vireo_tpu_torch.ops import counts
    squeezed = []
    real_place, real_install = counts.counts_from_scipy, rc.Sampled.install

    def place(*args, **kwargs):
        if squeezed:
            kwargs["dense_budget"] = 1
        return real_place(*args, **kwargs)

    def install(self, cls):
        squeezed.append(True)
        return real_install(self, cls)
    monkeypatch.setattr(counts, "counts_from_scipy", place)
    monkeypatch.setattr(rc.Sampled, "install", install)
    root = tiny_checkout(tmp_path)
    with pytest.raises(RuntimeError, match="the check's job placed"):
        _run(root, False)


def test_every_declared_file_is_there():
    m = Manifest()
    for w in m.spec["workloads"]:
        cell = m.cell(w["name"])
        m.entry(cell["config"]["entry"])
        assert set(cell["limits"]), w["name"]
    for metric in m.spec["per_layer"]:
        assert hasattr(m.reader(metric["name"]), "read")
