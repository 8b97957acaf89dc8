"""Checkpoints: vireo_tpu_torch.utils.checkpoint wired into vireo_wrap,
against the uninterrupted run and against the JAX package's files.

- Within the port, a run resumed after either phase reproduces the
  uninterrupted run bit for bit (the saved state, priors and numpy RNG
  position are restored exactly), also across the subset branch, whose
  refit draws new assignments from the RNG.
- A checkpoint of another run is refused by its fingerprint.
- Each package resumes from the other's checkpoint directory and gives
  its own uninterrupted result, and the two packages' uninterrupted runs
  agree: identical calls, and the numbers to rtol 1e-9 (the two
  packages' float64 states differ in the last bits; both run the
  doublet phase unfused, at their defaults).
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vireo_tpu.engine.wrap import vireo_wrap as jax_wrap
from vireo_tpu.utils import checkpoint as jckpt
from vireo_tpu_torch.engine.wrap import vireo_wrap
from vireo_tpu_torch.sim.synth import synth_pool_counts
from vireo_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

KEYS = ("ID_prob", "GT_prob", "doublet_prob", "doublet_LLR", "LB_doublet",
        "LB_list")
STEP1 = "vireo_ckpt_00000001.npz"


@pytest.fixture(scope="module")
def pool():
    d = synth_pool_counts(n_var=150, n_cell=200, n_donor=3,
                          doublet_rate=0.1, density=0.2, seed=9)
    GT = np.eye(3)[d["GT"]] * 0.97 + 0.01
    decoy = np.eye(3)[np.random.RandomState(1).binomial(2, 0.5, (150, 1))]
    d["subset_prior"] = np.concatenate([GT, decoy * 0.97 + 0.01], 1)
    return d


def _kw(branch, pool):
    kw = dict(random_seed=7, check_doublet=True, verbose=False)
    if branch == "free":
        return dict(kw, n_donor=3, n_init=4)
    return dict(kw, n_donor=3, GT_prior=pool["subset_prior"],
                learn_GT=False, n_init=1)


def _equal(a, b):
    for key in KEYS:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("branch", ["free", "subset"])
def test_resume_after_each_phase_reproduces_the_run(pool, tmp_path, branch):
    AD, DP = pool["AD"], pool["DP"]
    kw = dict(_kw(branch, pool), device="cpu")
    plain = vireo_wrap(AD, DP, **kw)
    ck = str(tmp_path / "ck")
    full = vireo_wrap(AD, DP, checkpoint_dir=ck, **kw)
    rng_full = np.random.get_state()
    assert sorted(os.listdir(ck)) == ["rng_0.npz", "rng_1.npz",
                                      "vireo_ckpt_00000000.npz", STEP1]
    _equal(full, plain)

    # stopped after the refit: only the doublet phase runs again
    _equal(vireo_wrap(AD, DP, checkpoint_dir=ck, **kw), full)
    # stopped after the warm restarts: the refit (and the subset's
    # redraw) run again from the saved RNG position
    os.remove(os.path.join(ck, STEP1))
    _equal(vireo_wrap(AD, DP, checkpoint_dir=ck, **kw), full)
    rng_r0 = np.random.get_state()
    assert rng_r0[2] == rng_full[2]
    np.testing.assert_array_equal(rng_r0[1], rng_full[1])
    _equal(vireo_wrap(AD, DP, checkpoint_dir=ck, **kw), full)


def test_a_foreign_checkpoint_is_refused(pool, tmp_path):
    AD, DP = pool["AD"], pool["DP"]
    ck = str(tmp_path / "ck")
    kw = dict(n_donor=3, check_doublet=False, verbose=False, device="cpu")
    vireo_wrap(AD, DP, n_init=4, random_seed=7, checkpoint_dir=ck, **kw)
    for other in (dict(n_init=4, random_seed=8), dict(n_init=5, random_seed=7),
                  dict(n_init=4)):
        with pytest.raises(ValueError, match="DIFFERENT run"):
            vireo_wrap(AD, DP, checkpoint_dir=ck, **other, **kw)
    with pytest.raises(ValueError, match="DIFFERENT run"):
        vireo_wrap(AD[:, :150], DP[:, :150], n_init=4, random_seed=7,
                   checkpoint_dir=ck, **kw)


def test_checkpoint_files_round_trip(tmp_path):
    from vireo_tpu_torch.models.vireo import VireoState, VireoPriors
    rng = np.random.RandomState(0)
    state = VireoState(*(torch.as_tensor(rng.rand(*s)) for s in
                         ((1, 3), (1, 3), (5, 2, 3), (4, 2))))
    priors = VireoPriors(*(torch.as_tensor(rng.rand(*s)) for s in
                           ((1, 3), (1, 3), (1, 2), (5, 2, 3))))
    ck = str(tmp_path / "ck")
    assert tckpt.latest_step(ck) is None
    tckpt.save_state(ck, 3, state, priors=priors, elbo_trace=np.arange(4.0),
                     extra={"n_donor": 2}, fingerprint={"n_var": 5})
    assert tckpt.latest_step(ck) == 3 and not any(
        f.endswith(".tmp.npz") for f in os.listdir(ck))
    for mod, kw in ((tckpt, dict(dtype=torch.float64, device="cpu")),
                    (jckpt, dict(dtype=jnp.float64))):
        st, pr, ex = mod.load_state(ck, **kw)
        for a, b in zip((st.gt_prob, pr.gt_log, ex["elbo_trace"]),
                        (state.gt_prob, priors.gt_log, np.arange(4.0))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert int(ex["n_donor"]) == 2
    tckpt.check_fingerprint(ck, {"n_var": 5, "other": 1})
    with pytest.raises(ValueError, match="DIFFERENT run"):
        jckpt.check_fingerprint(ck, {"n_var": 6})
    np.random.seed(4)
    tckpt.save_rng(ck, "r")
    want = np.random.rand(3)
    jckpt.load_rng(ck, "r")
    np.testing.assert_array_equal(np.random.rand(3), want)


def _jax_run(AD, DP, kw, ck=None):
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("VIREO_FUSED_DOUBLET", raising=False)
        return jax_wrap(AD, DP, dtype=jnp.float64, mesh=None,
                        checkpoint_dir=ck, **kw)


def _close(a, b):
    """The other package's resumed run against this package's own."""
    np.testing.assert_array_equal(np.argmax(a["ID_prob"], 1),
                                  np.argmax(b["ID_prob"], 1))
    for key in KEYS:
        np.testing.assert_allclose(np.asarray(a[key]), np.asarray(b[key]),
                                   rtol=1e-9, atol=1e-12, err_msg=key)


@pytest.mark.parametrize("branch", ["free", "subset"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_resumes_from_the_others_checkpoint(pool, tmp_path,
                                                         branch, writer):
    AD, DP = pool["AD"], pool["DP"]
    kw = _kw(branch, pool)
    ck = str(tmp_path / "ck")

    def port(ck=None):
        return vireo_wrap(AD, DP, device="cpu", dtype=torch.float64,
                          checkpoint_dir=ck, **kw)

    write, read = (_jax_run, None) if writer == "jax" else (None, _jax_run)
    if writer == "jax":
        first = write(AD, DP, kw, ck)
        own = port()
        resume = port
    else:
        first = port(ck)
        own = _jax_run(AD, DP, kw)

        def resume(ck):
            return read(AD, DP, kw, ck)
    _close(own, first)                      # the two packages' runs
    _close(resume(ck), own)                 # after the refit
    os.remove(os.path.join(ck, STEP1))
    _close(resume(ck), own)                 # after the warm restarts
