"""The port's device policy (vireo_tpu_torch/utils/device.py): its
entry points run on the card unless the caller asks for the CPU, by a
`device=` argument or by VIREO_PLATFORM=cpu, the JAX package's variable
for the same choice. Without a card they raise instead of running the
float64 CPU path unasked."""

import numpy as np
import pytest
import torch

from test_torch_cli import _write_cellsnp, _write_donor_vcf
from vireo_tpu_torch.cli import vireo_cli as tcli
from vireo_tpu_torch.engine.wrap import vireo_wrap
from vireo_tpu_torch.models import vireo as tvireo, vireo_fused
from vireo_tpu_torch.ops.counts import counts_from_scipy
from vireo_tpu_torch.sim.synth import synth_pool_counts
from vireo_tpu_torch.utils import device as tdevice

torch.set_num_threads(1)

V, C, K = 60, 80, 2


@pytest.fixture
def no_card(monkeypatch):
    """A machine whose CUDA reports no card, VIREO_PLATFORM unset."""
    monkeypatch.delenv("VIREO_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    return monkeypatch


def _default_device(tmp_path):
    return tdevice.default_device()


def _wrap(tmp_path):
    d = synth_pool_counts(V, C, K, doublet_rate=0.05, density=0.3, seed=1)
    return vireo_wrap(d["AD"], d["DP"], n_donor=K, n_init=2, random_seed=1,
                      verbose=False)


def _cli(tmp_path):
    _write_cellsnp(tmp_path / "cellsnp", V=V, C=C, K=K)
    tcli.main(["-c", str(tmp_path / "cellsnp"), "-N", str(K), "-o",
               str(tmp_path / "out"), "--randSeed", "1", "--nInit", "2",
               "--noPlot"])
    return (tmp_path / "out" / "donor_ids.tsv").read_text()


def _cli_donor_file(tmp_path):
    d = _write_cellsnp(tmp_path / "cellsnp", V=V, C=C, K=K)
    donors = str(tmp_path / "donors.vcf.gz")
    _write_donor_vcf(donors, d["GT"], [0, 1], ["A", "B"],
                     np.random.RandomState(0), V=V)
    tcli.main(["-c", str(tmp_path / "cellsnp"), "-d", donors, "-t", "GT",
               "-o", str(tmp_path / "out"), "--randSeed", "1", "--noPlot"])
    return (tmp_path / "out" / "donor_ids.tsv").read_text()


def _fused_fit(tmp_path):
    d = synth_pool_counts(V, C, K, doublet_rate=0.0, density=0.3, seed=1)
    cfg = tvireo.VireoConfig(n_var=V, n_cell=C, n_donor=K)
    state = tvireo.init_state(cfg, rng=np.random.RandomState(0),
                              dtype=torch.float32)
    priors = tvireo.default_priors(cfg, dtype=torch.float32)
    data = vireo_fused.prepare_fused(counts_from_scipy(d["AD"], d["DP"]))
    return vireo_fused.fused_fit_vb(data, state, priors, cfg, max_iter=30)


ENTRY_POINTS = {"default_device": _default_device, "vireo_wrap": _wrap,
                "cli": _cli, "cli_donor_file": _cli_donor_file,
                "fused_fit_vb": _fused_fit}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_no_card_raises_instead_of_running_on_the_cpu(no_card, tmp_path,
                                                      entry):
    with pytest.raises(RuntimeError,
                       match="no CUDA card.*VIREO_PLATFORM=cpu"):
        ENTRY_POINTS[entry](tmp_path)


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_platform_cpu_runs_on_the_cpu(no_card, tmp_path, entry):
    no_card.setenv("VIREO_PLATFORM", "cpu")
    got = ENTRY_POINTS[entry](tmp_path)
    if entry == "default_device":
        assert got == torch.device("cpu")
    elif entry == "vireo_wrap":
        # the CPU's working type is float64 (the card's float32)
        assert got["ID_prob"].shape == (C, K)
        assert got["GT_prob"].dtype == np.float64
    elif entry == "fused_fit_vb":
        state, _, elbo, n_iter = got
        assert state.id_prob.device == torch.device("cpu")
        assert np.isfinite(elbo) and 0 < n_iter <= 30
    else:
        assert len(got.splitlines()) == C + 1


@pytest.mark.parametrize("value", ["cuda", "gpu", "GPU"])
def test_asking_for_the_card_without_one_raises(no_card, value):
    no_card.setenv("VIREO_PLATFORM", value)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tdevice.default_device()


def test_an_unknown_platform_is_refused(no_card):
    no_card.setenv("VIREO_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="VIREO_PLATFORM=tpu"):
        tdevice.default_device()


def test_an_explicit_device_wins(no_card):
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    no_card.setenv("VIREO_PLATFORM", "cpu")
    assert tdevice.resolve_device("meta") == torch.device("meta")
    d = synth_pool_counts(V, C, K, doublet_rate=0.05, density=0.3, seed=1)
    no_card.delenv("VIREO_PLATFORM")
    res = vireo_wrap(d["AD"], d["DP"], n_donor=K, n_init=2, random_seed=1,
                     verbose=False, device="cpu")
    assert res["GT_prob"].dtype == np.float64
