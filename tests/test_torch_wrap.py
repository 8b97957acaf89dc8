"""The slice as a whole: vireo_tpu_torch.engine.wrap.vireo_wrap against
vireo_tpu.engine.wrap.vireo_wrap, seeded, in float64.

On the dense rung both sides take int8 counts at their defaults
(VIREO_FUSED_DOUBLET unset): the JAX side gets a pre-built int8
DenseCounts, the port's side places int8 counts itself and runs K0's
plain version on the CPU, and both run the doublet phase unfused (the
expanded log-likelihood, then update_GT_prob's E-step); K1 is not
launched. On the packed, hybrid and COO rungs the port runs K2/K3's
plain versions and the COO sums in float64, against JAX's dense float64
run.

Tolerances, every rung: the warm restarts, the refit and the doublet
phase are float64 on both sides, summed in other orders: identical
per-restart iteration counts, winner and calls, LB_list rtol 1e-9,
ID_prob, doublet_prob, GT_prob and doublet_LLR rtol 1e-9 (atol 1e-12).
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


def _record_k1(monkeypatch):
    """A list that gains an entry at each call of K1's wrapper."""
    calls = []
    real = fused_em.fused_estep_stats
    monkeypatch.setattr(fused_em, "fused_estep_stats",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


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
    monkeypatch.delenv("VIREO_FUSED_DOUBLET", raising=False)

    jc = jax_counts_from_scipy(AD, DP, max_dense_elems=10)
    assert jc.ad.dtype == jnp.int8
    j_warm_iters = _jax_warm_iters(jc)

    j_calls, t_calls = [], []
    _record_fits(monkeypatch, jvireo, j_calls)    # the JAX refit
    _record_fits(monkeypatch, twrap, t_calls)
    _record_fits(monkeypatch, tvireo, t_calls)
    rj = jwrap.vireo_wrap(jc, n_donor=3, n_init=N_INIT, random_seed=6,
                          dtype=jnp.float64, verbose=False, mesh=None)
    k1 = _record_k1(monkeypatch)
    rt = twrap.vireo_wrap(AD, DP, n_donor=3, n_init=N_INIT, random_seed=6,
                          dtype=torch.float64, device="cpu", verbose=False)
    assert k1 == []

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

    _same_doublet_phase(rt, rj)
    for key in ("ambient_Psi", "Psi_var", "Psi_LLRatio"):
        assert rt[key] is None and rj[key] is None
    assert set(rt) == set(rj)


def _same_doublet_phase(rt, rj):
    """The doublet phase's outputs of two float64 runs at round-off, and
    the same call (donor, or donor pair) for every cell."""
    for key in ("ID_prob", "doublet_prob", "GT_prob", "doublet_LLR"):
        assert rt[key].shape == np.asarray(rj[key]).shape, key
        np.testing.assert_allclose(rt[key], np.asarray(rj[key]), rtol=1e-9,
                                   atol=1e-12, err_msg=key)
    calls = [np.argmax(np.hstack([r["ID_prob"], r["doublet_prob"]]), 1)
             for r in (rt, {k: np.asarray(rj[k])
                            for k in ("ID_prob", "doublet_prob")})]
    np.testing.assert_array_equal(calls[0], calls[1])


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
            mp.delenv("VIREO_FUSED_DOUBLET", raising=False)
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
    k1 = _record_k1(monkeypatch)
    rt = twrap.vireo_wrap(counts, n_donor=3, n_init=N_INIT, random_seed=6,
                          dtype=torch.float64, verbose=False)
    assert k1 == []
    np.testing.assert_array_equal(t_calls[0], j_warm_iters)
    np.testing.assert_array_equal(t_calls[1], j_refit_iters)
    assert np.argmax(rt["LB_list"]) == np.argmax(rj["LB_list"])
    np.testing.assert_allclose(rt["LB_list"], rj["LB_list"], rtol=1e-9)
    np.testing.assert_allclose(rt["LB_doublet"], rj["LB_doublet"],
                               rtol=1e-9)
    for key in ("theta_mean", "theta_sum"):
        np.testing.assert_allclose(rt[key], np.asarray(rj[key]), rtol=1e-9,
                                   atol=1e-12, err_msg=key)
    _same_doublet_phase(rt, rj)


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


def _spy_jax(mp, calls):
    """Record JAX's per-restart warm iterations (the warm phase vmaps
    fit_vb inside one jitted call, so the same vmap is run beside it on
    the arguments the wrap passes) and every later fit's iterations."""
    import jax
    real_fit, real_warm = jvireo.fit_vb, jwrap._warm_select

    def warm(counts, batched, priors, cfg, max_iter_init, delay_fit_theta):
        w = jax.vmap(lambda st: real_fit(
            counts, st, priors, cfg, max_iter=max_iter_init, min_iter=5,
            delay_fit_theta=delay_fit_theta))(batched)
        calls.append(np.asarray(w.n_iter))
        return real_warm(counts, batched, priors, cfg, max_iter_init,
                         delay_fit_theta)

    mp.setattr(jwrap, "_warm_select", warm)
    _record_fits(mp, jvireo, calls)


def _smoothed(GT, eps=0.01):
    """One-hot genotypes (V, K) -> probabilities (V, K, 3)."""
    return np.eye(3)[GT] * (1 - 3 * eps) + eps


def _branches(pool):
    """The donor-genotype branches of vireo_wrap on the pool (3 donors):
    all known, a superset of 3 + 2 decoys, a subset of 2, and 1 extra
    donor searched by distance and by size."""
    GT = _smoothed(pool["GT"])
    decoys = _smoothed(np.random.RandomState(2).binomial(
        2, 0.5, size=(GT.shape[0], 2)))
    return {
        "known": dict(GT_prior=GT, n_donor=3, learn_GT=False),
        "known_width": dict(GT_prior=GT, learn_GT=False),
        "subset": dict(GT_prior=np.concatenate([GT, decoys], 1), n_donor=3,
                       learn_GT=False),
        "superset": dict(GT_prior=GT[:, :2], n_donor=3),
        "extra_distance": dict(n_donor=3, n_extra_donor=1),
        "extra_size": dict(n_donor=3, n_extra_donor=1,
                           extra_donor_mode="size"),
        "extra_superset": dict(GT_prior=GT[:, :1], n_donor=3,
                               n_extra_donor=1),
    }


BRANCHES = ["known", "known_width", "subset", "superset", "extra_distance",
            "extra_size", "extra_superset"]


@pytest.mark.parametrize("rung", ["dense", "packed"])
@pytest.mark.parametrize("branch", BRANCHES)
def test_donor_branches_match_jax(pool, monkeypatch, branch, rung):
    """Each branch, seeded, float64, against JAX's vireo_wrap: identical
    iterations in every fit (per restart in the warm phase), winner and
    LB_list (rtol 1e-9). On the dense rung both sides run at their
    defaults on int8 counts (the doublet phase unfused); on the packed
    rung the port runs K2/K3's plain versions against JAX's dense
    float64 run: rtol 1e-9 throughout."""
    AD, DP = pool["AD"], pool["DP"]
    kw = dict(_branches(pool)[branch], n_init=N_INIT, random_seed=6,
              verbose=False)
    monkeypatch.delenv("VIREO_FUSED_DOUBLET", raising=False)
    if rung == "dense":
        jc = jax_counts_from_scipy(AD, DP, max_dense_elems=10)
        tc = tcounts.counts_from_scipy(AD, DP, device="cpu")
        assert tc.ad.dtype == torch.int8
    else:
        jc = jax_dense_counts(AD, DP, dtype=jnp.float64)
        tc = tcounts.counts_from_scipy(AD, DP, device="cpu",
                                       dense_budget=AD.shape[0] * AD.shape[1])
        assert type(tc).__name__ == "PackedCounts"
    j_calls, t_calls = [], []
    _spy_jax(monkeypatch, j_calls)
    _record_fits(monkeypatch, twrap, t_calls)
    _record_fits(monkeypatch, tvireo, t_calls)
    rj = jwrap.vireo_wrap(jc, dtype=jnp.float64, mesh=None, **kw)
    rt = twrap.vireo_wrap(tc, dtype=torch.float64, **kw)

    assert len(t_calls) == len(j_calls) >= 2
    for t, j in zip(t_calls, j_calls):
        np.testing.assert_array_equal(t, j)
    assert np.argmax(rt["LB_list"]) == np.argmax(rj["LB_list"])
    np.testing.assert_allclose(rt["LB_list"], rj["LB_list"], rtol=1e-9)
    np.testing.assert_allclose(rt["LB_doublet"], rj["LB_doublet"],
                               rtol=1e-9)
    for key in ("theta_mean", "theta_sum", "theta_shapes"):
        np.testing.assert_allclose(rt[key], rj[key], rtol=1e-9)
    _same_doublet_phase(rt, rj)
    n_donor = kw.get("n_donor") or kw["GT_prior"].shape[1]
    assert rt["ID_prob"].shape == (AD.shape[1], n_donor)
    if branch.startswith("known"):
        # donor k of the prior is donor k of the calls
        singlet = pool["donor2"] < 0
        assert np.mean(np.argmax(rt["ID_prob"], 1)[singlet]
                       == pool["donor"][singlet]) > 0.95


def test_learn_gt_false_drops_extra_donors(pool, capsys):
    kw = dict(_branches(pool)["known"], n_extra_donor=2, n_init=N_INIT,
              random_seed=6, verbose=False, device="cpu")
    rt = twrap.vireo_wrap(pool["AD"], pool["DP"], **kw)
    printed = capsys.readouterr().out
    assert "Searching from extra donors only works with learn_GT" in printed
    assert "GT is fixed, so use a single initialization" in printed
    assert rt["ID_prob"].shape[1] == 3 and len(rt["LB_list"]) == 1
    with pytest.raises(ValueError, match="requiring n_donor or GT_prior"):
        twrap.vireo_wrap(pool["AD"], pool["DP"], device="cpu")


def test_unseeded_run_with_a_prior(pool):
    """Unseeded inits with a genotype prior draw only the assignments on
    the device; every restart starts from the prior. The run reaches the
    seeded run's calls: the same confident calls (max ID_prob >= 0.9; a
    doublet's singlet argmax is a near tie), and an ELBO within 1e-3 (the
    unseeded superset run stops 0.72 above the seeded one on this pool:
    another stop of the same partition)."""
    AD, DP = pool["AD"], pool["DP"]
    kw = dict(_branches(pool)["superset"], n_init=N_INIT, verbose=False,
              device="cpu")
    seeded = twrap.vireo_wrap(AD, DP, random_seed=6, **kw)
    seen = []
    real = twrap._device_batched_init

    def spy(cfg, n_init, GT_prior_use, *args):
        seen.append(GT_prior_use)
        return real(cfg, n_init, GT_prior_use, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(twrap, "_device_batched_init", spy)
        unseeded = twrap.vireo_wrap(AD, DP, generator=torch.Generator()
                                    .manual_seed(3), **kw)
    assert len(seen) == 1 and seen[0] is None    # superset: no warm prior
    known = dict(_branches(pool)["known"], n_init=1, verbose=False,
                 device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(twrap, "_device_batched_init", spy)
        k_unseeded = twrap.vireo_wrap(AD, DP, generator=torch.Generator()
                                      .manual_seed(3), **known)
    np.testing.assert_array_equal(seen[1], known["GT_prior"])
    k_seeded = twrap.vireo_wrap(AD, DP, random_seed=6, **known)
    for a, b in ((unseeded, seeded), (k_unseeded, k_seeded)):
        conf = b["ID_prob"].max(1) >= 0.9
        assert conf.mean() > 0.8
        np.testing.assert_array_equal(np.argmax(a["ID_prob"], 1)[conf],
                                      np.argmax(b["ID_prob"], 1)[conf])
        np.testing.assert_allclose(a["LB_doublet"], b["LB_doublet"],
                                   rtol=1e-3)


def test_device_batched_init_broadcasts_the_prior():
    cfg = tvireo.VireoConfig(n_var=5, n_cell=4, n_donor=2)
    prior = np.random.RandomState(0).dirichlet(np.ones(3), size=(5, 2)) * 2
    st = twrap._device_batched_init(cfg, 3, prior, torch.Generator()
                                    .manual_seed(0), torch.float64, "cpu")
    for r in range(3):
        np.testing.assert_allclose(st.gt_prob[r].numpy(), prior / 2,
                                   rtol=1e-15)
    np.testing.assert_allclose(st.id_prob.sum(-1).numpy(), 1.0)


def test_host_batched_init_stream_matches_jax():
    """With and without a prior, the port's seeded batched init draws
    numpy's stream as JAX's does and gives the same arrays."""
    cfg_t = tvireo.VireoConfig(n_var=40, n_cell=30, n_donor=3)
    cfg_j = jvireo.VireoConfig(n_var=40, n_cell=30, n_donor=3)
    for prior in (None, np.random.RandomState(9).dirichlet(
            [1.0] * 3, size=(40, 3))):
        np.random.seed(5)
        t = twrap._host_batched_init(cfg_t, 4, prior, np.random,
                                     torch.float64, "cpu")
        tail_t = np.random.rand()
        np.random.seed(5)
        j = jwrap._host_batched_init(cfg_j, 4, prior, np.random, jnp.float64)
        assert np.random.rand() == tail_t
        for f in ("id_prob", "gt_prob", "beta_mu", "beta_sum"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)))


@pytest.mark.parametrize("kwargs,shape", [
    (dict(mesh="2x2"), {"vars": 2, "cells": 2}),
])
def test_unported_arguments_raise(pool, tmp_path, monkeypatch, kwargs,
                                  shape):
    """mesh="VxC", refused before the multi-GPU slice, resolves the 2-D
    mesh on four ranks (every rank alike); tests/test_torch_mesh_wrap.py
    runs vireo_wrap on such meshes."""
    from vireo_tpu_torch.parallel.launch import run_ranks
    monkeypatch.setenv("VIREO_PLATFORM", "cpu")
    out = run_ranks("vireo_tpu_torch.engine.wrap:_resolve_mesh", 4,
                    args=(kwargs["mesh"], pool["AD"].shape[1]),
                    workdir=str(tmp_path), timeout=120)
    assert [o["shape"] for o in out] == [shape] * 4
    assert [o["coords"]["vars"] for o in out] == [0, 0, 1, 1]
