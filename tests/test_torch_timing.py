"""utils/timing.py and the timing knobs: VIREO_TIMING=1 makes the port's
vireo_wrap and CLI print the JAX package's per-phase summary (the same
format and phases), PhaseTimer and throughput behave as JAX's, and
VIREO_PROFILE=<dir> writes a torch.profiler trace."""

import json
import re

import jax.numpy as jnp
import pytest
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


def test_throughput_matches_jax():
    for args in ((10, 100, 2.0), (3, 5, 0.0)):
        assert ttiming.throughput(*args) == jtiming.throughput(*args)


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
