"""utils/timing.py and the timing knobs: VIREO_TIMING=1 makes the port's
vireo_wrap and CLI print the JAX package's per-phase summary (the same
format and phases), PhaseTimer behaves as JAX's, VIREO_PROFILE=<dir>
writes a torch.profiler trace, and the program's `vireo.*` spans name
its steps in any profiler's trace and cost nothing without one."""

import json
import os
import re
import tempfile
import time

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from vireo_tpu.utils import timing as jtiming
from vireo_tpu_torch.utils import timing as ttiming
from vireo_tpu_torch.sim.synth import synth_pool_counts

torch.set_num_threads(1)

HEAD = re.compile(r"^\[vireo\] timing: total \d+\.\d\ds$")
ROW = re.compile(r"^  (\S+) +\d+\.\d\ds +\d+\.\d%$")


def _summaries(out):
    """Each printed summary as its list of phase names (every line
    checked against the format)."""
    lines = out.splitlines()
    found = []
    for i, line in enumerate(lines):
        if line.startswith("[vireo] timing:"):
            assert HEAD.match(line), line
            names = []
            for row in lines[i + 1:]:
                m = ROW.match(row)
                if not m:
                    break
                assert len(row) == len("  %-24s %8.2fs  %5.1f%%"
                                       % (m.group(1), 0.0, 0.0)), row
                names.append(m.group(1))
            found.append(names)
    return found


def test_phase_timer_matches_jax_format():
    t, j = ttiming.PhaseTimer(), jtiming.PhaseTimer()
    for timer in (t, j):
        for name in ("a", "b", "a"):
            with timer.phase(name):
                pass
        timer.phases.update(a=1.5, b=0.5)
    assert t.summary() == j.summary()
    assert t.summary().splitlines()[1] == "  %-24s %8.2fs  %5.1f%%" % (
        "a", 1.5, 75.0)
    assert json.loads(t.json()) == {"a": 1.5, "b": 0.5}
    synced = []
    timer = ttiming.PhaseTimer(sync=lambda: synced.append(1))
    with pytest.raises(ValueError):
        with timer.phase("x"):
            raise ValueError
    with timer.phase("x"):
        pass
    assert synced == [1] and list(timer.phases) == ["x"]


def test_phase_timer_reads_the_monotonic_clock(monkeypatch):
    """A step of the wall clock moves no phase time."""
    monkeypatch.setattr(time, "time", lambda: pytest.fail("wall clock read"))
    timer = ttiming.PhaseTimer()
    with timer.phase("a"):
        pass
    assert 0 <= timer.phases["a"] < 1


@pytest.fixture(scope="module")
def pool():
    return synth_pool_counts(n_var=120, n_cell=160, n_donor=3, density=0.2,
                             seed=1)


@pytest.mark.parametrize("env,timing,printed", [
    ("1", None, True), ("yes", None, True), ("0", None, False),
    ("", None, False), ("off", True, True), ("1", False, False),
])
def test_vireo_timing_env_through_vireo_wrap(pool, monkeypatch, capsys, env,
                                            timing, printed):
    """The knob resolves as JAX's: `timing` wins, else VIREO_TIMING; the
    summary names JAX's phases in its order."""
    from vireo_tpu.engine.wrap import vireo_wrap as jwrap
    from vireo_tpu_torch.engine.wrap import vireo_wrap as twrap
    monkeypatch.setenv("VIREO_TIMING", env)
    kw = dict(n_donor=3, n_init=2, random_seed=1, verbose=False,
              check_ambient=True, timing=timing)
    jwrap(pool["AD"], pool["DP"], dtype=jnp.float64, mesh=None, **kw)
    want = _summaries(capsys.readouterr().out)
    twrap(pool["AD"], pool["DP"], device="cpu", **kw)
    got = _summaries(capsys.readouterr().out)
    assert got == want
    assert (got == [["data_placement", "warm_restarts", "model_build",
                     "refit", "doublet", "ambient"]]) == printed


def test_timing_dict_is_filled_without_a_print(pool, capsys):
    from vireo_tpu_torch.engine.wrap import vireo_wrap
    phases = {}
    vireo_wrap(pool["AD"], pool["DP"], n_donor=3, n_init=2, random_seed=1,
               verbose=False, device="cpu", timing=phases)
    assert "timing:" not in capsys.readouterr().out
    assert list(phases) == ["data_placement", "warm_restarts", "model_build",
                            "refit", "doublet"]
    assert all(v >= 0 for v in phases.values())


@pytest.mark.parametrize("how", ["env", "flag"])
def test_vireo_timing_through_the_cli(tmp_path, monkeypatch, capsys, how):
    """The CLI prints vireo_wrap's summary, then its writers', as JAX's
    CLI does (with --noPlot, no plots phase)."""
    from vireo_tpu.cli import vireo_cli as jcli
    from vireo_tpu_torch.cli import vireo_cli as tcli
    from test_torch_cli import _write_cellsnp
    monkeypatch.setenv("VIREO_PLATFORM", "cpu")
    monkeypatch.setenv("VIREO_COMPILE_CACHE", "")
    monkeypatch.setenv("VIREO_TIMING", "1" if how == "env" else "0")
    data = tmp_path / "cellsnp"
    _write_cellsnp(data, V=60, C=80, K=2)
    args = ["-c", str(data), "-N", "2", "--nInit", "2", "--randSeed", "1",
            "--noPlot"] + (["--timing"] if how == "flag" else [])
    jcli.main(args + ["-o", str(tmp_path / "j")])
    want = _summaries(capsys.readouterr().out)
    tcli.main(args + ["-o", str(tmp_path / "t")])
    got = _summaries(capsys.readouterr().out)
    assert got == want and len(got) == 2
    assert got[1] == ["result_writers", "donor_vcf"]


def test_vireo_profile_writes_a_trace(pool, tmp_path, monkeypatch):
    from vireo_tpu_torch.engine.wrap import vireo_wrap
    out = tmp_path / "prof"
    monkeypatch.setenv("VIREO_PROFILE", str(out))
    res = vireo_wrap(pool["AD"], pool["DP"], n_donor=3, n_init=2,
                     random_seed=1, verbose=False, device="cpu")
    assert res["ID_prob"].shape == (160, 3)
    traces = list(out.glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("matmul" in str(e.get("name", "")) for e in events)
    with ttiming.profile_trace(None):      # no directory: no trace
        pass
    assert len(list(out.glob("*.json"))) == 1


# ---- the program's spans

PHASES = ("data_placement", "warm_restarts", "model_build", "refit",
          "doublet")


def _traced(fn):
    """(fn's result, the `vireo.*` spans of the calling thread as
    (name, start, end), in start order) under a CPU torch.profiler."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return out, sorted(((e["name"], float(e["ts"]),
                         float(e["ts"]) + e["dur"]) for e in events
                        if e.get("cat") == "user_annotation"
                        and e["name"].startswith("vireo.")),
                       key=lambda span: span[1])


def _named(spans, name):
    return [span for span in spans if span[0] == name]


def _inside(inner, outers):
    return any(o[1] <= inner[1] and inner[2] <= o[2] for o in outers)


class _Calls:
    """Counts the calls of a counts class's two contractions, as the
    benchmark's class wrapper records them."""

    def __init__(self, monkeypatch, cls):
        self.n = {"suff_stats": 0, "cell_loglik": 0}
        for kind in self.n:
            real = getattr(cls, kind)

            def call(counts, *a, _real=real, _kind=kind, **kw):
                self.n[_kind] += 1
                return _real(counts, *a, **kw)
            monkeypatch.setattr(cls, kind, call)


@pytest.mark.parametrize("init", ["_host_batched_init", "_mt_batched_init"])
def test_vireo_wrap_spans_nest_in_its_phases(pool, monkeypatch, init):
    """From host scipy: placement's steps inside `vireo.data_placement`
    (the dense rung: the value range and rung, then the upload; no
    union of the patterns), the inits' steps inside `vireo.inits` inside
    `vireo.warm_restarts` (the CPU's host draws, or the card's path,
    forced here, which runs the kernel's plain version on the CPU), and
    one contraction span for each call the class wrapper records."""
    from vireo_tpu_torch.engine import wrap
    from vireo_tpu_torch.engine.wrap import vireo_wrap
    from vireo_tpu_torch.ops.counts import DenseCounts
    # the CPU's dispatch sends the seeded inits to `init`
    monkeypatch.setattr(wrap, "_host_batched_init", getattr(wrap, init))
    calls = _Calls(monkeypatch, DenseCounts)
    _, spans = _traced(lambda: vireo_wrap(
        pool["AD"], pool["DP"], n_donor=3, n_init=2, random_seed=1,
        verbose=False, device="cpu"))
    for name in PHASES:
        assert len(_named(spans, "vireo." + name)) == 1, name
    place = _named(spans, "vireo.data_placement")
    steps = [sp for sp in spans if sp[0].startswith("vireo.place.")]
    assert {sp[0] for sp in steps} == {"vireo.place.rung",
                                       "vireo.place.upload"}
    assert all(_inside(sp, place) for sp in steps)
    inits = _named(spans, "vireo.inits")
    assert len(inits) == 1
    assert _inside(inits[0], _named(spans, "vireo.warm_restarts"))
    subs = {sp[0] for sp in spans if sp[0].startswith("vireo.inits.")}
    assert subs == ({"vireo.inits.host"} if init == "_host_batched_init" else
                    {"vireo.inits.plan", "vireo.inits.stream",
                     "vireo.inits.normalise"})
    assert all(_inside(sp, inits) for sp in spans
               if sp[0].startswith("vireo.inits."))
    for kind, n in calls.n.items():
        assert n > 0 and len(_named(spans, "vireo." + kind)) == n, kind
    fits = _named(spans, "vireo.fit")
    assert len(fits) == 2 and _inside(fits[0],
                                      _named(spans, "vireo.warm_restarts"))
    assert _inside(fits[1], _named(spans, "vireo.refit"))
    assert len(_named(spans, "vireo.binom")) == 2


@pytest.mark.parametrize("rung,budget,heavy", [
    ("packed", 1.0, False), ("int8-hybrid", 2.0, True),
    ("packed-hybrid", 1.0, True), ("coo", 1 / 120 / 160, False)])
def test_placement_off_the_dense_rung_opens_the_union(pool, rung, budget,
                                                      heavy):
    """`place.union` opens once, between `place.rung` and
    `place.upload`, where AD and DP are aligned to the union of their
    patterns (a hybrid's residual, the COO rung); the packed rung, like
    the dense one, goes from `place.rung` to `place.upload`."""
    from vireo_tpu_torch.ops.counts import (counts_from_scipy,
                                            device_dense_budget, ladder_rung)
    AD, DP = _heavy(pool) if heavy else (pool["AD"], pool["DP"])
    budget *= AD.shape[0] * AD.shape[1]
    assert ladder_rung(AD.shape, DP.max(), budget) == rung
    _, spans = _traced(lambda: counts_from_scipy(AD, DP, device="cpu",
                                                 dense_budget=budget))
    union = [] if rung == "packed" else ["vireo.place.union"]
    assert [sp[0] for sp in spans] == (["vireo.place.rung"] + union
                                       + ["vireo.place.upload"])


def _heavy(pool, extra=200.0):
    """The pool with a few counts above 127 (`extra` reads deeper), for
    the hybrid rungs; above 16,383 for the dense float32 rung."""
    AD, DP = pool["AD"].toarray(), pool["DP"].toarray()
    rows, cols = np.nonzero(DP)
    DP[rows[:7], cols[:7]] += extra
    AD[rows[:7], cols[:7]] += 0.75 * extra
    return sp.csc_matrix(AD), sp.csc_matrix(DP)


@pytest.mark.parametrize("rung,budget,heavy", [
    ("dense", None, False), ("packed", 1.0, False),
    ("int8-hybrid", 2.0, True), ("packed-hybrid", 1.0, True),
    ("coo", 1 / 120 / 160, False), ("dense", None, "float32")])
def test_one_contraction_span_per_call_on_every_rung(pool, monkeypatch, rung,
                                                     budget, heavy):
    """A hybrid's base and residual calls open no span of their own: each
    call of the placed counts' class lies inside exactly one span. Dense
    float32 counts (counts above 16,383) open one `vireo.matmul` inside
    each call's span; K0's int8 and int16 counts none."""
    from vireo_tpu_torch.engine.wrap import vireo_wrap
    from vireo_tpu_torch.ops.counts import (MATMULS, counts_from_scipy,
                                            device_dense_budget, ladder_rung)
    AD, DP = (_heavy(pool, 20000.0) if heavy == "float32"
              else _heavy(pool)) \
        if heavy else (pool["AD"], pool["DP"])
    budget = None if budget is None else budget * AD.shape[0] * AD.shape[1]
    counts = counts_from_scipy(AD, DP, device="cpu", dense_budget=budget)
    assert ladder_rung(AD.shape, DP.max(),
                       budget or device_dense_budget("cpu")) == rung
    plain = heavy == "float32"
    assert (getattr(counts, "ad", None) is not None
            and counts.ad.dtype == torch.float32) == plain
    calls = _Calls(monkeypatch, type(counts))
    matmuls = dict(MATMULS)
    _, spans = _traced(lambda: vireo_wrap(
        counts, n_donor=3, n_init=2, random_seed=1, verbose=False,
        device="cpu"))
    inner = _named(spans, "vireo.matmul")
    for kind, n_calls in calls.n.items():
        mine = _named(spans, "vireo." + kind)
        assert n_calls > 0 and len(mine) == n_calls, kind
        assert not any(_inside(a, [b]) for a in mine for b in mine
                       if a is not b)
        assert MATMULS[kind] - matmuls[kind] == n_calls * plain, kind
        assert sum(1 for a in mine if _inside(a, inner)) == 0
        assert [sum(1 for m in inner if _inside(m, [a])) for a in mine] \
            == [1 * plain] * n_calls, kind
    assert len(inner) == sum(calls.n.values()) * plain
    assert len(_named(spans, "vireo.binom")) == 2


def test_sweep_opens_inits_and_fit_once_per_k(pool):
    from vireo_tpu_torch.engine.select import sweep_n_donor
    from vireo_tpu_torch.ops.counts import counts_from_scipy
    counts = counts_from_scipy(pool["AD"], pool["DP"], device="cpu")
    Ks = (2, 3, 4)
    for seed in (1, None):
        _, spans = _traced(lambda: sweep_n_donor(
            counts, n_donor_list=Ks, n_init=2, random_seed=seed,
            verbose=False))
        assert len(_named(spans, "vireo.inits")) == len(Ks)
        assert len(_named(spans, "vireo.fit")) == len(Ks)
        assert len(_named(spans, "vireo.binom")) == 1


def test_no_span_is_recorded_without_a_profiler(pool, monkeypatch):
    """Without a profiler the spans enter no `record_function`; under
    one they do (the count proves the patch is seen)."""
    from vireo_tpu_torch.engine.select import sweep_n_donor
    from vireo_tpu_torch.engine.wrap import vireo_wrap
    entered = []
    real = torch.profiler.record_function

    def counted(*a, **kw):
        entered.append(a)
        return real(*a, **kw)
    monkeypatch.setattr(torch.profiler, "record_function", counted)

    def run():
        vireo_wrap(pool["AD"], pool["DP"], n_donor=3, n_init=2,
                   random_seed=1, verbose=False, device="cpu",
                   check_ambient=True)
        sweep_n_donor(pool["AD"], pool["DP"], n_donor_list=(2, 3),
                      n_init=2, random_seed=1, verbose=False, device="cpu")
    run()
    assert entered == []
    _traced(run)
    assert ("vireo.inits",) in entered and ("vireo.ambient",) in entered


def test_results_are_the_same_under_a_profiler(pool):
    from vireo_tpu_torch.engine.select import sweep_n_donor
    from vireo_tpu_torch.engine.wrap import vireo_wrap

    def run():
        res = vireo_wrap(pool["AD"], pool["DP"], n_donor=3, n_init=3,
                         random_seed=2, verbose=False, device="cpu")
        sweep = sweep_n_donor(pool["AD"], pool["DP"], n_donor_list=(2, 3),
                              n_init=2, random_seed=2, verbose=False,
                              device="cpu")
        return res, sweep
    plain, plain_sweep = run()
    (traced, traced_sweep), spans = _traced(run)
    assert spans
    for key, value in plain.items():
        if value is None:
            assert traced[key] is None, key
        else:
            assert np.array_equal(np.asarray(value), np.asarray(traced[key]),
                                  equal_nan=True), key
    assert plain_sweep["best"] == traced_sweep["best"]
    for K in (2, 3):
        assert np.array_equal(plain_sweep[K], traced_sweep[K])
