"""vireo_tpu_torch.models.vireo against vireo_tpu.models.vireo in float64.

Both sides start from the same state (passed across as numpy arrays
with state_from_numpy) and run the same update sequence; only
library round-off and the order of float sums differ. Tolerance: states
rtol 1e-10 (atol 1e-12 for probabilities that underflow towards zero),
and identical iteration counts.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from vireo_tpu.ops.counts import dense_counts as jax_dense_counts
from vireo_tpu.models import vireo as jv
from vireo_tpu_torch.ops.counts import counts_from_scipy
from vireo_tpu_torch.models import vireo as tv

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's entry points run on the card unless asked for the CPU
    (utils/device.py); these tests ask for it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIREO_PLATFORM", "cpu")
        yield

RTOL, ATOL = 1e-10, 1e-12
FIELDS = ("beta_mu", "beta_sum", "gt_prob", "id_prob")


def _pool(seed=11, V=120, C=90, K=3):
    rng = np.random.RandomState(seed)
    GT = rng.randint(0, 3, size=(V, K))
    donor = rng.randint(0, K, size=C)
    DP = (rng.rand(V, C) < 0.3) * (1 + rng.poisson(2, size=(V, C)))
    AD = rng.binomial(DP, np.array([0.02, 0.5, 0.98])[GT[:, donor]])
    return sp.csc_matrix(AD.astype(float)), sp.csc_matrix(DP.astype(float))


def _jax_state_numpy(st):
    return {f: np.asarray(getattr(st, f)) for f in FIELDS}


@pytest.fixture
def setup():
    AD, DP = _pool()
    K = 3
    cfg_j = jv.VireoConfig(n_var=AD.shape[0], n_cell=AD.shape[1], n_donor=K)
    cfg_t = tv.VireoConfig(n_var=AD.shape[0], n_cell=AD.shape[1], n_donor=K)
    st_j = jv.init_state(cfg_j, rng=np.random.RandomState(0),
                         dtype=jnp.float64)
    pr_j = jv.default_priors(cfg_j, dtype=jnp.float64)
    st_t = tv.state_from_numpy(_jax_state_numpy(st_j), dtype=torch.float64,
                               device="cpu")
    pr_t = tv.priors_from_numpy(
        {f: np.asarray(getattr(pr_j, f)) for f in
         ("theta_s1", "theta_s2", "id_log", "gt_log")},
        dtype=torch.float64, device="cpu")
    return (jax_dense_counts(AD, DP, dtype=jnp.float64), cfg_j, st_j, pr_j,
            counts_from_scipy(AD, DP), cfg_t, st_t, pr_t)


def _assert_state(st_t, st_j):
    got = tv.state_to_numpy(st_t)
    for f in FIELDS:
        np.testing.assert_allclose(got[f], np.asarray(getattr(st_j, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)


def test_init_state_and_priors_match():
    cfg_j = jv.VireoConfig(n_var=20, n_cell=15, n_donor=4)
    cfg_t = tv.VireoConfig(n_var=20, n_cell=15, n_donor=4)
    st_j = jv.init_state(cfg_j, rng=np.random.RandomState(5),
                         dtype=jnp.float64)
    st_t = tv.init_state(cfg_t, rng=np.random.RandomState(5),
                         dtype=torch.float64, device="cpu")
    got = tv.state_to_numpy(st_t)
    for f in FIELDS:       # same draws, same order, same normalisation
        np.testing.assert_array_equal(got[f], np.asarray(getattr(st_j, f)))
    pr_j = jv.default_priors(cfg_j, dtype=jnp.float64)
    pr_t = tv.priors_to_numpy(tv.default_priors(cfg_t, dtype=torch.float64,
                                                device="cpu"))
    for f in pr_t:
        np.testing.assert_array_equal(pr_t[f], np.asarray(getattr(pr_j, f)))


@pytest.mark.parametrize("update_theta", [True, False])
@pytest.mark.parametrize("flags", [
    {}, {"ASE_mode": True}, {"fix_beta_sum": True}, {"learn_GT": False},
    {"learn_theta": False}])
def test_em_step_matches(setup, update_theta, flags):
    cj, cfg_j, st_j, pr_j, ct, cfg_t, st_t, pr_t = setup
    cfg_j = dataclasses.replace(cfg_j, **flags)
    cfg_t = dataclasses.replace(cfg_t, **flags)
    if flags.get("ASE_mode"):       # per-variant theta
        st_j = jv.init_state(cfg_j, rng=np.random.RandomState(0),
                             dtype=jnp.float64)
        st_t = tv.state_from_numpy(_jax_state_numpy(st_j),
                                   dtype=torch.float64, device="cpu")
    for _ in range(3):
        st_j, ll_j, elbo_j = jv.em_step(cj, st_j, pr_j, cfg_j, update_theta)
        st_t, ll_t, elbo_t = tv.em_step(ct, st_t, pr_t, cfg_t, update_theta)
        _assert_state(st_t, st_j)
        np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(elbo_t), float(elbo_j), rtol=RTOL)


def test_fit_vb_matches(setup):
    cj, cfg_j, st_j, pr_j, ct, cfg_t, st_t, pr_t = setup
    rj = jv.fit_vb(cj, st_j, pr_j, cfg_j, max_iter=60, min_iter=5,
                   delay_fit_theta=2)
    rt = tv.fit_vb(ct, st_t, pr_t, cfg_t, max_iter=60, min_iter=5,
                   delay_fit_theta=2)
    assert rt.n_iter == int(rj.n_iter) < 60
    _assert_state(rt.state, rj.state)
    np.testing.assert_allclose(rt.elbo_ref, float(rj.elbo_ref), rtol=RTOL)
    np.testing.assert_allclose(rt.elbo_final, float(rj.elbo_final),
                               rtol=RTOL)
    np.testing.assert_allclose(rt.elbo_trace, np.asarray(rj.elbo_trace),
                               rtol=RTOL)   # NaN tails compare equal


def test_batched_fit_freezes_each_restart(setup):
    """A batched fit gives each restart exactly its own single fit."""
    cj, cfg_j, st_j, pr_j, ct, cfg_t, st_t, pr_t = setup
    states = [tv.init_state(cfg_t, rng=np.random.RandomState(s),
                            dtype=torch.float64, device="cpu")
              for s in (1, 2, 3)]
    batched = tv.VireoState(*(torch.stack([getattr(s, f) for s in states])
                              for f in FIELDS))
    rb = tv.fit_vb(ct, batched, pr_t, cfg_t, max_iter=40, min_iter=5)
    assert len(set(rb.n_iter.tolist())) > 1   # restarts stop apart
    for r, s in enumerate(states):
        rs = tv.fit_vb(ct, s, pr_t, cfg_t, max_iter=40, min_iter=5)
        assert int(rb.n_iter[r]) == rs.n_iter
        np.testing.assert_allclose(rb.elbo_ref[r], rs.elbo_ref, rtol=RTOL)
        got, want = tv.state_to_numpy(rb.state.take(r)), \
            tv.state_to_numpy(rs.state)
        for f in FIELDS:
            np.testing.assert_allclose(got[f], want[f], rtol=RTOL,
                                       atol=ATOL)


def test_vireo_class_fit_elbo_matches():
    AD, DP = _pool(seed=4)
    kw = dict(n_cell=AD.shape[1], n_var=AD.shape[0], n_donor=3)
    np.random.seed(9)
    mj = jv.Vireo(dtype=jnp.float64, **kw)
    mj.fit(jax_dense_counts(AD, DP, dtype=jnp.float64), max_iter=80,
           verbose=False)
    np.random.seed(9)
    mt = tv.Vireo(dtype=torch.float64, device="cpu", **kw)
    mt.fit(AD, DP, max_iter=80, verbose=False)
    assert len(mt.ELBO_) == len(mj.ELBO_) > 5
    np.testing.assert_allclose(mt.ELBO_, mj.ELBO_, rtol=RTOL)
    np.testing.assert_allclose(mt.ID_prob, mj.ID_prob, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(mt.GT_prob, mj.GT_prob, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(mt.theta_s1, mj.theta_s1, rtol=RTOL)
    # the single-step refresh APIs
    ct = counts_from_scipy(AD, DP)
    cj = jax_dense_counts(AD, DP, dtype=jnp.float64)
    np.testing.assert_allclose(mt.update_ID_prob(ct, None),
                               mj.update_ID_prob(cj, None), rtol=RTOL)
    mt.update_GT_prob(ct, None)
    mj.update_GT_prob(cj, None)
    np.testing.assert_allclose(mt.GT_prob, mj.GT_prob, rtol=RTOL,
                               atol=ATOL)


def test_run_em_iters_and_random_init_arrays_match(setup):
    cj, cfg_j, st_j, pr_j, ct, cfg_t, st_t, pr_t = setup
    sj, ej = jv.run_em_iters(cj, st_j, pr_j, cfg_j, 4)
    st, et = tv.run_em_iters(ct, st_t, pr_t, cfg_t, 4)
    _assert_state(st, sj)
    np.testing.assert_allclose(float(et), float(ej), rtol=RTOL)
    for a, b in zip(jv.random_init_arrays(cfg_j, np.random.RandomState(8)),
                    tv.random_init_arrays(cfg_t, np.random.RandomState(8))):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("n_iter,max_iter,n_dec,message", [
    (5, 10, 1, "Lower bound decreases"),
    (5, 5, 1, "VB did not converge"),
])
def test_warn_from_trace_matches(capsys, n_iter, max_iter, n_dec, message):
    trace = np.array([1.0, 2.0, 3.0, 2.0, 4.0])
    assert jv.warn_from_trace(trace, n_iter, max_iter, 1) == n_dec
    want = capsys.readouterr().out
    assert tv.warn_from_trace(trace, n_iter, max_iter, 1) == n_dec
    got = capsys.readouterr().out
    assert got == want and message in got
