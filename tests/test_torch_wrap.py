"""The slice as a whole: vireo_tpu_torch.engine.wrap.vireo_wrap against
vireo_tpu.engine.wrap.vireo_wrap, seeded, in float64.

On the dense rung both sides take int8 counts through K1 in the doublet
phase: the JAX side gets a pre-built int8 DenseCounts and
VIREO_FUSED_DOUBLET=interpret (the Pallas kernel in interpret mode), the
port's side places int8 counts itself and runs K1's plain version on the
CPU. On the packed, hybrid and COO rungs the port runs K2/K3's plain
versions and the COO sums in float64, against JAX's dense float64 run.

Tolerances:
- warm restarts and refit are float64 on both sides: identical
  per-restart iteration counts and winner, LB_list rtol 1e-9;
- the doublet phase through K1 (float32 sums, bf16 W and id) on both
  sides, differing only in float32 sum order: ID_prob, doublet_prob and
  GT_prob atol 1e-5, doublet_LLR rtol 1e-5;
- the doublet phase unfused (every non-dense rung) is float64: rtol 1e-9.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from vireo_tpu.ops.counts import counts_from_scipy as jax_counts_from_scipy
from vireo_tpu.ops.counts import dense_counts as jax_dense_counts
from vireo_tpu.engine import wrap as jwrap
from vireo_tpu.models import vireo as jvireo
from vireo_tpu_torch.engine import wrap as twrap
from vireo_tpu_torch.models import vireo as tvireo
from vireo_tpu_torch.ops import counts as tcounts, fused_em
from vireo_tpu_torch.sim.synth import synth_pool_counts

torch.set_num_threads(1)

N_INIT = 4


def _record_fits(monkeypatch, module, calls):
    """Keep each fit_vb's iteration counts (restarts and refit)."""
    real = module.fit_vb

    def spy(*args, **kwargs):
        res = real(*args, **kwargs)
        calls.append(np.atleast_1d(np.asarray(res.n_iter)).copy())
        return res

    monkeypatch.setattr(module, "fit_vb", spy)


def _jax_warm_iters(jc):
    """Per-restart iteration counts of the JAX warm phase: its
    _warm_select vmaps fit_vb inside one jit, so the same vmap is run
    here, on the same seeded inits, to read them."""
    import jax
    cfg = jvireo.VireoConfig(n_var=jc.n_var, n_cell=jc.n_cell, n_donor=3)
    np.random.seed(6)
    batched = jwrap._host_batched_init(cfg, N_INIT, None, np.random,
                                       jnp.float64)
    priors = jvireo.default_priors(cfg, dtype=jnp.float64)
    warm = jax.vmap(lambda st: jvireo.fit_vb(
        jc, st, priors, cfg, max_iter=20, min_iter=5,
        delay_fit_theta=3))(batched)
    return np.asarray(warm.n_iter)


@pytest.fixture(scope="module")
def pool():
    return synth_pool_counts(n_var=220, n_cell=300, n_donor=3,
                             doublet_rate=0.1, density=0.15, seed=4)


def test_vireo_wrap_slice_matches_jax(pool, monkeypatch):
    AD, DP = pool["AD"], pool["DP"]
    monkeypatch.setenv("VIREO_FUSED_DOUBLET", "interpret")

    jc = jax_counts_from_scipy(AD, DP, max_dense_elems=10)
    assert jc.ad.dtype == jnp.int8
    j_warm_iters = _jax_warm_iters(jc)

    j_calls, t_calls = [], []
    _record_fits(monkeypatch, jvireo, j_calls)    # the JAX refit
    _record_fits(monkeypatch, twrap, t_calls)
    _record_fits(monkeypatch, tvireo, t_calls)
    rj = jwrap.vireo_wrap(jc, n_donor=3, n_init=N_INIT, random_seed=6,
                          dtype=jnp.float64, verbose=False, mesh=None)
    rt = twrap.vireo_wrap(AD, DP, n_donor=3, n_init=N_INIT, random_seed=6,
                          dtype=torch.float64, device="cpu", verbose=False)

    # per-restart iterations of the warm phase, then the refit's
    assert len(t_calls) == 2 and len(j_calls) == 1
    np.testing.assert_array_equal(t_calls[0], j_warm_iters)
    assert len(set(t_calls[0].tolist())) > 1   # restarts stop apart
    np.testing.assert_array_equal(t_calls[1], j_calls[0])

    assert np.argmax(rt["LB_list"]) == np.argmax(rj["LB_list"])
    np.testing.assert_allclose(rt["LB_list"], rj["LB_list"], rtol=1e-9)
    np.testing.assert_allclose(rt["LB_doublet"], rj["LB_doublet"],
                               rtol=1e-9)
    for key in ("theta_mean", "theta_sum", "theta_shapes"):
        np.testing.assert_allclose(rt[key], rj[key], rtol=1e-9)

    for key in ("ID_prob", "doublet_prob", "GT_prob"):
        assert rt[key].shape == np.asarray(rj[key]).shape
        np.testing.assert_allclose(rt[key], np.asarray(rj[key]), atol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(rt["doublet_LLR"],
                               np.asarray(rj["doublet_LLR"]), rtol=1e-5,
                               atol=1e-5)
    for key in ("ambient_Psi", "Psi_var", "Psi_LLRatio"):
        assert rt[key] is None and rj[key] is None
    assert set(rt) == set(rj)


def _heavy(pool, seed=8):
    """The pool with ~3% of its nonzeros raised into the hundreds (above
    both the int8 cap 127 and the nibble cap 15)."""
    rng = np.random.RandomState(seed)
    AD, DP = pool["AD"].toarray(), pool["DP"].toarray()
    extra = ((DP > 0) & (rng.rand(*DP.shape) < 0.03)) \
        * rng.randint(150, 400, DP.shape)
    return (sp.csc_matrix(AD + rng.binomial(extra, 0.5)),
            sp.csc_matrix(DP + extra))


@pytest.fixture(scope="module")
def jax_dense_runs(pool):
    """JAX's vireo_wrap on dense float64 counts (its unfused doublet
    branch) for the pool and its heavy-tailed copy: the result, the
    warm-phase iterations per restart and the refit's."""
    runs = {}
    AD, DP = pool["AD"], pool["DP"]
    assert DP.max() <= 15
    for name, (ad, dp) in (("light", (AD, DP)), ("heavy", _heavy(pool))):
        jc = jax_dense_counts(ad, dp, dtype=jnp.float64)
        calls = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("VIREO_FUSED_DOUBLET", "0")
            _record_fits(mp, jvireo, calls)
            res = jwrap.vireo_wrap(jc, n_donor=3, n_init=N_INIT,
                                   random_seed=6, dtype=jnp.float64,
                                   verbose=False, mesh=None)
        runs[name] = (ad, dp, res, _jax_warm_iters(jc), calls[0])
    return runs


@pytest.mark.parametrize("rung,pool_name,budget,cls,base", [
    ("packed", "light", 1, "PackedCounts", None),
    ("int8-hybrid", "heavy", 2, "HybridCounts", "DenseCounts"),
    ("packed-hybrid", "heavy", 1, "HybridCounts", "PackedCounts"),
    ("coo", "heavy", 0, "SparseCounts", None),
])
def test_vireo_wrap_rungs_match_jax_dense(jax_dense_runs, monkeypatch, rung,
                                          pool_name, budget, cls, base):
    """The slice on each non-dense rung, placed by the ladder (budget in
    units of n_var * n_cell bytes) and handed to vireo_wrap prebuilt,
    against JAX's dense float64 run: all float64, the doublet phase
    unfused on both sides, so the same tolerances as the warm phase."""
    AD, DP, rj, j_warm_iters, j_refit_iters = jax_dense_runs[pool_name]
    nbytes = max(budget * AD.shape[0] * AD.shape[1], 1)
    assert tcounts.ladder_rung(AD.shape, float(DP.max()), nbytes) == rung
    counts = tcounts.counts_from_scipy(AD, DP, device="cpu",
                                       dense_budget=nbytes)
    assert type(counts).__name__ == cls
    if base:
        assert type(counts.base).__name__ == base
    t_calls = []
    _record_fits(monkeypatch, twrap, t_calls)
    _record_fits(monkeypatch, tvireo, t_calls)
    before = fused_em.LAUNCHES
    rt = twrap.vireo_wrap(counts, n_donor=3, n_init=N_INIT, random_seed=6,
                          dtype=torch.float64, verbose=False)
    assert fused_em.LAUNCHES == before
    np.testing.assert_array_equal(t_calls[0], j_warm_iters)
    np.testing.assert_array_equal(t_calls[1], j_refit_iters)
    assert np.argmax(rt["LB_list"]) == np.argmax(rj["LB_list"])
    np.testing.assert_allclose(rt["LB_list"], rj["LB_list"], rtol=1e-9)
    np.testing.assert_allclose(rt["LB_doublet"], rj["LB_doublet"],
                               rtol=1e-9)
    for key in ("theta_mean", "theta_sum", "ID_prob", "doublet_prob",
                "GT_prob"):
        np.testing.assert_allclose(rt[key], np.asarray(rj[key]), rtol=1e-9,
                                   atol=1e-12, err_msg=key)
    np.testing.assert_allclose(rt["doublet_LLR"],
                               np.asarray(rj["doublet_LLR"]), rtol=1e-9,
                               atol=1e-9)


def _singlet_accuracy(pool, ID_prob):
    from scipy.optimize import linear_sum_assignment
    singlet = pool["donor2"] < 0
    pred = np.argmax(ID_prob, 1)[singlet]
    true = pool["donor"][singlet]
    K = ID_prob.shape[1]
    hits = np.array([[np.sum((true == t) & (pred == p)) for p in range(K)]
                     for t in range(K)])
    ti, pi = linear_sum_assignment(-hits)
    return hits[ti, pi].sum() / singlet.sum()


def test_unseeded_run_reaches_the_seeded_optimum(pool):
    AD, DP = pool["AD"], pool["DP"]
    seeded = twrap.vireo_wrap(AD, DP, n_donor=3, n_init=N_INIT,
                              random_seed=6, device="cpu", verbose=False)
    gen = torch.Generator().manual_seed(1)
    unseeded = twrap.vireo_wrap(AD, DP, n_donor=3, n_init=8, device="cpu",
                                verbose=False, generator=gen)
    assert _singlet_accuracy(pool, seeded["ID_prob"]) > 0.95
    assert _singlet_accuracy(pool, unseeded["ID_prob"]) > 0.95
    np.testing.assert_allclose(unseeded["LB_doublet"], seeded["LB_doublet"],
                               rtol=1e-5)
    assert np.all(np.isfinite(unseeded["doublet_LLR"]))


@pytest.mark.parametrize("kwargs,match", [
    (dict(GT_prior=np.ones((220, 3, 3)) / 3), "donor-prior"),
    (dict(n_extra_donor=1), "donor-prior"),
    (dict(check_ambient=True), "ambient"),
    (dict(mesh="2x2"), "multi-GPU"),
    (dict(checkpoint_dir="ckpt"), "checkpoints"),
])
def test_unported_arguments_raise(pool, kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        twrap.vireo_wrap(pool["AD"], pool["DP"], n_donor=3, device="cpu",
                         **kwargs)
