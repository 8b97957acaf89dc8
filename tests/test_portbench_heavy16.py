"""The benchmark's cell `heavy16.default`, a pool whose counts reach the
thousands, on the CPU at a tiny size:

- the manifest resolves the cell: its configuration, traffic, limits and
  per-layer metrics;
- on an 80 GiB card its full-size pool takes the dense float32 rung;
- the tiny heavy pool through the program's `vireo_wrap` on that rung
  matches the benchmark's plain reference in float64;
- a tiny checkout under the cell's limits reads `correct` from host
  counts, and each fault of `portbench/tests/test_portbench_faults.py`
  that reaches `vireo_wrap` is judged under those limits. The limits
  let a single altered call pass (they hold hundreds of calls apart for
  float32's other optima on this pool): PERF.md names it.

The harness refuses a run whose process holds JAX, which this suite's
conftest imports, so the checkout's runs go in one child process:
`python tests/test_portbench_heavy16.py <dir>` prints their results as
one JSON object.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
BENCH_TESTS = ROOT / "portbench" / "tests"
CELL = "heavy16.default"
TINY = "heavy16.tiny"
# the faults of test_portbench_faults.py that reach `vireo_wrap`, and
# whether heavy16's limits catch each
CAUGHT = {"stale_step": True, "half_the_cells": True, "tail_restarts": True,
          "altered_call": False}


@pytest.fixture(autouse=True)
def _program_on_cpu(monkeypatch):
    monkeypatch.setenv("VIREO_PLATFORM", "cpu")


def test_the_manifest_resolves_the_cell():
    from portbench.harness.manifest import Manifest
    m = Manifest(ROOT)
    cell = m.cell(CELL)
    assert cell["chips"] == 1 and cell["traffic"]["input"] == "host"
    config = cell["config"]
    assert config["entry"] == "vireo_wrap" and config["reduced"] == []
    assert config["pool"] == {
        "n_var": 30000, "n_cell": 100000, "n_donor": 16,
        "doublet_rate": 0.08, "density": 0.01, "mean_extra_depth": 3.0,
        "max_depth": 16, "hot_share": 0.002, "hot_depth": [200, 2000],
        "theta": [0.02, 0.5, 0.98]}
    assert config["fit"] == {"n_donor": 16, "n_init": 20,
                             "max_iter_init": 20, "delay_fit_theta": 3,
                             "check_doublet": True}
    assert set(cell["limits"]) == set(m.cell("pool16.from_host")["limits"])
    assert cell["limits"]["placement"] == 0
    assert cell["limits"]["contraction"] == 1e-4
    assert {e["name"] for e in cell["end_to_end"]} == {
        "answer_s", "peak_mem_gib", "setup_s"}
    assert [p["name"] for p in cell["per_layer"]] == [
        p["name"] for p in m.spec["per_layer"]]
    m.entry(config["entry"])
    for metric in cell["per_layer"]:
        assert hasattr(m.reader(metric["name"]), "read")


def test_the_full_pool_is_dense_float32_on_an_80_gib_card():
    from vireo_tpu_torch.ops.counts import exact_count_dtype, ladder_rung
    assert ladder_rung((30000, 100000), 2007, 0.55 * 80 * 2**30) == "dense"
    assert exact_count_dtype(2007) == torch.float32


def test_the_tiny_heavy_pool_matches_the_reference():
    sys.path.insert(0, str(BENCH_TESTS))
    try:
        from helpers import TINY_FITS, TINY_HEAVY_POOL
    finally:
        sys.path.remove(str(BENCH_TESTS))
    from portbench.entries import vireo_wrap as entry
    from portbench.harness.pool import make_pool, to_host
    from portbench.reference import vireo as ref
    from portbench.reference.counts import Arith, RefCounts
    from vireo_tpu_torch.engine.wrap import vireo_wrap
    from vireo_tpu_torch.ops.counts import DenseCounts, counts_from_scipy

    AD, DP = to_host(make_pool(seed=2**31 + 21, device=torch.device("cpu"),
                               **TINY_HEAVY_POOL))
    assert DP.max() > 256
    counts = counts_from_scipy(AD, DP, device="cpu")
    assert isinstance(counts, DenseCounts)
    assert counts.ad.dtype == counts.dp.dtype == torch.float32
    fit = TINY_FITS["vireo_wrap"]
    got = vireo_wrap(counts, random_seed=7, verbose=False, device="cpu",
                     **fit)
    want = ref.vireo_wrap(RefCounts(AD, DP, "cpu"), fit["n_donor"],
                          fit["n_init"], 7, Arith("float64"),
                          max_iter_init=fit["max_iter_init"],
                          delay_fit_theta=fit["delay_fit_theta"])
    assert int(np.argmax(got["LB_list"])) == want["best"]
    np.testing.assert_allclose(got["LB_list"], want["LB_list"], rtol=1e-12)
    np.testing.assert_allclose(got["LB_doublet"], want["LB_doublet"],
                               rtol=1e-12)
    for key in ("ID_prob", "doublet_prob", "doublet_LLR", "GT_prob"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9,
                                   atol=1e-11, err_msg=key)
    numbers = entry.compare({k: np.asarray(v) for k, v in got.items()},
                            want)
    assert numbers["calls"] == 0 and numbers["other_best"] == 0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's (correct, checks) from one child process."""
    tmp = tmp_path_factory.mktemp("heavy16")
    env = dict(os.environ, VIREO_PLATFORM="cpu")
    proc = subprocess.run([sys.executable, __file__, str(tmp)], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.splitlines()[-1])


def test_a_tiny_checkout_under_the_limits_is_correct(runs):
    run = runs["sound"]
    assert run["correct"], run["checks"]
    assert run["checks"]["placement"]["value"] == 0
    assert run["layout"] == ["DenseCounts", "torch.float32", "torch.float32"]


@pytest.mark.parametrize("fault", sorted(CAUGHT))
def test_each_fault_is_judged_under_the_limits(runs, fault):
    run = runs[fault]
    assert run["correct"] != CAUGHT[fault], run["checks"]
    if fault == "tail_restarts":
        check = run["checks"]["contraction"]
        assert check["value"] > check["limit"]
    if fault == "altered_call":
        # the altered call is counted, below the limit
        assert 1 <= run["checks"]["calls"]["value"] \
            <= run["checks"]["calls"]["limit"]


def _runs(tmp):
    """The tiny checkout's sound run and a run under each fault, with
    heavy16.default's limits, from host counts."""
    import contextlib
    for p in (str(ROOT), str(BENCH_TESTS)):
        sys.path.insert(0, p)
    from helpers import TINY_HEAVY_POOL, tiny_checkout
    from test_portbench_faults import FAULTS
    from portbench.harness import run_cell as rc

    torch.set_num_threads(2)
    root = tiny_checkout(tmp, traffic="from_host", cell=TINY,
                         pool=TINY_HEAVY_POOL)
    limits = ROOT / "portbench" / "workloads" / (CELL + ".json")
    (root / "portbench" / "workloads" / (TINY + ".json")).write_text(
        limits.read_text())
    layouts = []
    real = rc.layout

    def layout(counts):
        layouts.append(real(counts))
        return layouts[-1]
    rc.layout = layout
    out = {}
    for case in ["sound"] + sorted(CAUGHT):
        fault = FAULTS[case]() if case in FAULTS \
            else contextlib.nullcontext()
        with fault:
            res, _ = rc.run_cell(TINY, 2**31 + 23, 0.2, False,
                                 torch.device("cpu"), time.perf_counter(),
                                 root=root, log=lambda m: None)
        out[case] = dict(correct=res["correct"], checks=res["checks"],
                         layout=layouts[-1])
    return out


if __name__ == "__main__":
    print(json.dumps(_runs(Path(sys.argv[1]))))
