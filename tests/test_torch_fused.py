"""The fused EM fit: vireo_tpu_torch.models.vireo_fused against
vireo_tpu.models.vireo_fused with K1 in interpret mode, both in float32,
and against the port's own unfused fit.

The JAX side pads variants to 32 and cells to its 64-cell block and
pads the state and priors to match; the port's side is unpadded (K1
masks ragged edges). Each iteration rounds the weights and the
assignments that feed the next statistics to bf16, so a float32
difference of a few ulps between the two packages (their digamma, their
sum orders) can flip a bf16 rounding and move the fit's path; at a
converged, saturated fixed point the two agree again. The parity pool
(200 variants x 300 cells x 4 donors, density 0.5, seed 3) is one on
which both stop at the same iteration. Pools on which they stop apart:
the same shape at density 0.5, seed 0 (JAX 9 iterations, the port 11)
and seed 2 (12 against 100: the port's bf16 path ends in a two-cycle
whose ELBO moves by 0.5 and never meets the 0.01 stop test), and the
suite's `small_data` pool (13 against 14).

Tolerances at the fixed point: ELBO rtol 1e-5, id_prob atol 1e-6 (the
calls are saturated), gt_prob atol 1e-5, beta_mu atol 1e-6 (measured
7e-7, 2e-24, 2e-6 and 2e-7). After one iteration, before any bf16
flip compounds: ELBO rtol 1e-5, id_prob and gt_prob atol 2e-4 (the
GT softmax amplifies the two float32 digammas' ulps; measured 2e-6,
8e-5, 5e-5). In ASE mode JAX's padded theta rows take the prior's value
at the first theta update and move its ELBO by no more than float32
sum order: the same tolerances hold (measured 1.5e-7).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from vireo_tpu.ops.counts import dense_counts as jax_dense_counts
from vireo_tpu.models import vireo as jv, vireo_fused as jf
from vireo_tpu_torch.models import vireo as tv, vireo_fused as tf
from vireo_tpu_torch.ops import counts as tcounts, fused_em
from vireo_tpu_torch.sim.synth import synth_pool_counts

torch.set_num_threads(1)

K = 4


@pytest.fixture(scope="module")
def pool():
    d = synth_pool_counts(n_var=200, n_cell=300, n_donor=K,
                          doublet_rate=0.0, density=0.5, seed=3)
    return d["AD"], d["DP"]


def _both(AD, DP, ase):
    """The same float32 init, priors and counts on both sides."""
    V, C = AD.shape
    jcfg = jv.VireoConfig(n_var=V, n_cell=C, n_donor=K, ASE_mode=ase)
    tcfg = tv.VireoConfig(n_var=V, n_cell=C, n_donor=K, ASE_mode=ase)
    idp, gtp = jv.random_init_arrays(jcfg, rng=np.random.RandomState(0))
    j = (jf.prepare_fused(jax_dense_counts(AD, DP, dtype=jnp.float32),
                          cell_block=64),
         jv.init_state(jcfg, ID_prob_init=idp, GT_prob_init=gtp,
                       dtype=jnp.float32),
         jv.default_priors(jcfg, dtype=jnp.float32), jcfg)
    t = (tf.prepare_fused(tcounts.counts_from_scipy(AD, DP, device="cpu")),
         tv.init_state(tcfg, ID_prob_init=idp, GT_prob_init=gtp,
                       dtype=torch.float32, device="cpu"),
         tv.default_priors(tcfg, dtype=torch.float32, device="cpu"), tcfg)
    return j, t


def _close_states(js, ts, V, C, id_atol, gt_atol):
    np.testing.assert_allclose(ts.id_prob.numpy(),
                               np.asarray(js.id_prob)[:C], atol=id_atol)
    np.testing.assert_allclose(ts.gt_prob.numpy(),
                               np.asarray(js.gt_prob)[:V], atol=gt_atol)


@pytest.mark.parametrize("ase,n_iter", [(False, 12), (True, 16)])
def test_fused_fit_matches_jax_interpret(pool, ase, n_iter):
    AD, DP = pool
    V, C = AD.shape
    j, t = _both(AD, DP, ase)
    js, jref, jfin, jit = jf.fused_fit_vb(*j, max_iter=100, min_iter=5,
                                          cell_block=64, interpret=True)
    before = fused_em.LAUNCHES
    ts, tref, tfin, tit = tf.fused_fit_vb(*t, max_iter=100, min_iter=5)
    assert fused_em.LAUNCHES == before        # the plain version on the CPU
    assert int(jit) == tit == n_iter
    assert isinstance(tfin, np.float32) and isinstance(tref, np.float32)
    np.testing.assert_allclose(tfin, float(jfin), rtol=1e-5)
    np.testing.assert_allclose(tref, float(jref), rtol=1e-5)
    _close_states(js, ts, V, C, id_atol=1e-6, gt_atol=1e-5)
    np.testing.assert_allclose(ts.beta_mu.numpy(), np.asarray(js.beta_mu),
                               atol=1e-6)
    assert ts.beta_mu.shape == (V if ase else 1, 3)
    assert ts.id_prob.shape == (C, K) and ts.id_prob.dtype == torch.float32


@pytest.mark.parametrize("n", [1, 12])
def test_run_fused_iters_n_matches_jax_interpret(pool, n):
    AD, DP = pool
    V, C = AD.shape
    j, t = _both(AD, DP, False)
    js, je = jf.run_fused_iters_n(*j, n, cell_block=64, interpret=True)
    ts, te = tf.run_fused_iters_n(*t, n)
    np.testing.assert_allclose(float(te), float(je), rtol=1e-5)
    tol = 2e-4 if n == 1 else 1e-5
    _close_states(js, ts, V, C, id_atol=tol, gt_atol=tol)


def test_an_uninformative_init_loses_every_donor_as_in_jax():
    """A property of the reference's fused fit, kept by the port: from a
    random init over many cells per variant (here 80, 16 donors), the
    donors' weights differ by less than bf16 resolves, so K1 sees equal
    weight columns, every cell's assignment comes out exactly uniform,
    and the statistics stay equal from then on. The unfused fit keeps
    the differences. Both packages lose every donor within three
    iterations; their ELBOs agree to rtol 1e-4 (the bf16 roundings of
    the first two iterations, before the columns become equal, differ by
    the packages' float32 ulps; measured 1.1e-5)."""
    d = synth_pool_counts(n_var=1000, n_cell=4000, n_donor=16,
                          doublet_rate=0.0, density=0.02, seed=0)
    V, C, K16 = 1000, 4000, 16
    jcfg = jv.VireoConfig(n_var=V, n_cell=C, n_donor=K16)
    tcfg = tv.VireoConfig(n_var=V, n_cell=C, n_donor=K16)
    idp, gtp = jv.random_init_arrays(jcfg, rng=np.random.RandomState(0))
    js, je = jf.run_fused_iters_n(
        jf.prepare_fused(jax_dense_counts(d["AD"], d["DP"],
                                          dtype=jnp.float32),
                         cell_block=128),
        jv.init_state(jcfg, ID_prob_init=idp, GT_prob_init=gtp,
                      dtype=jnp.float32),
        jv.default_priors(jcfg, dtype=jnp.float32), jcfg, 3,
        cell_block=128, interpret=True)
    counts = tcounts.counts_from_scipy(d["AD"], d["DP"], device="cpu")
    state = tv.init_state(tcfg, ID_prob_init=idp, GT_prob_init=gtp,
                          dtype=torch.float32, device="cpu")
    priors = tv.default_priors(tcfg, dtype=torch.float32, device="cpu")
    ts, te = tf.run_fused_iters_n(tf.prepare_fused(counts), state, priors,
                                  tcfg, 3)
    for id_prob in (np.asarray(js.id_prob)[:C], ts.id_prob.numpy()):
        assert np.all(id_prob == id_prob[:, :1])
    np.testing.assert_allclose(float(te), float(je), rtol=1e-4)
    unfused, _ = tv.run_em_iters(counts, state, priors, tcfg, 3)
    assert not np.any(np.all(unfused.id_prob.numpy()
                             == unfused.id_prob.numpy()[:, :1], axis=1))


def _own_setup(small_data):
    AD, DP, _ = small_data
    cfg = tv.VireoConfig(n_var=AD.shape[0], n_cell=AD.shape[1], n_donor=3)
    counts = tcounts.counts_from_scipy(AD, DP, device="cpu")
    state = tv.init_state(cfg, rng=np.random.RandomState(0),
                          dtype=torch.float32, device="cpu")
    priors = tv.default_priors(cfg, dtype=torch.float32, device="cpu")
    return cfg, counts, state, priors


def test_fused_loop_matches_unfused(small_data):
    """As tests/test_fused.py holds JAX's: five fused iterations against
    five unfused float32 em_steps, ELBO rtol 5e-3, calls > 0.99."""
    cfg, counts, state, priors = _own_setup(small_data)
    st_f, elbo_f = tf.run_fused_iters_n(tf.prepare_fused(counts), state,
                                        priors, cfg, 5)
    st = state
    for _ in range(5):
        st, _, elbo = tv.em_step(counts, st, priors, cfg, update_theta=True)
    np.testing.assert_allclose(float(elbo_f), float(elbo), rtol=5e-3)
    agree = np.mean(st_f.id_prob.argmax(1).numpy()
                    == st.id_prob.argmax(1).numpy())
    assert agree > 0.99, agree


def test_fused_fit_matches_unfused_fit(small_data):
    cfg, counts, state, priors = _own_setup(small_data)
    st, elbo_ref, elbo_fin, n_iter = tf.fused_fit_vb(
        tf.prepare_fused(counts), state, priors, cfg, max_iter=60,
        min_iter=5)
    assert np.isfinite(elbo_fin) and n_iter < 60
    res = tv.fit_vb(counts, state, priors, cfg, max_iter=60, min_iter=5)
    np.testing.assert_allclose(elbo_fin, res.elbo_final, rtol=5e-3)
    assert st.id_prob.shape == (cfg.n_cell, cfg.n_donor)


def test_prepare_fused_takes_int8_or_small_counts():
    rng = np.random.RandomState(0)
    dp = (rng.rand(30, 20) < 0.5) * rng.randint(1, 128, (30, 20))
    ad = rng.binomial(dp, 0.5)
    dense64 = tcounts.DenseCounts(torch.as_tensor(ad, dtype=torch.float64),
                                  torch.as_tensor(dp, dtype=torch.float64))
    data = tf.prepare_fused(dense64)
    assert data.ad.dtype == data.dp.dtype == torch.int8
    assert (data.n_var, data.n_cell) == (30, 20)
    assert torch.equal(data.dp.double(), dense64.dp)
    int8 = tcounts.counts_from_scipy(sp.csc_matrix(ad), sp.csc_matrix(dp),
                                     device="cpu")
    assert tf.prepare_fused(int8).ad is int8.ad


def test_prepare_fused_refuses_large_or_non_dense_counts():
    ad = np.zeros((8, 6))
    dp = np.zeros((8, 6))
    dp[2, 3], ad[2, 3] = 128, 64
    big = tcounts.counts_from_scipy(sp.csc_matrix(ad), sp.csc_matrix(dp),
                                    device="cpu")
    assert isinstance(big, tcounts.DenseCounts) and big.dp.dtype != torch.int8
    with pytest.raises(ValueError, match="128 > 127"):
        tf.prepare_fused(big)
    dp[2, 3], ad[2, 3] = 7, 3
    for budget in (48, 0):       # the packed rung, then COO
        c = tcounts.counts_from_scipy(sp.csc_matrix(ad), sp.csc_matrix(dp),
                                      device="cpu", dense_budget=budget)
        assert type(c).__name__ == ("PackedCounts" if budget
                                    else "SparseCounts")
        with pytest.raises(ValueError, match="takes a DenseCounts"):
            tf.prepare_fused(c)


def test_fused_iteration_requires_a_row_prior(small_data):
    cfg, counts, state, priors = _own_setup(small_data)
    per_cell = tv.default_priors(
        cfg, ID_prior=np.full((cfg.n_cell, 3), 1 / 3), dtype=torch.float32,
        device="cpu")
    with pytest.raises(ValueError, match="row-broadcast ID prior"):
        tf.fused_fit_vb(tf.prepare_fused(counts), state, per_cell, cfg)
