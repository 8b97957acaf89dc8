"""vireo_tpu_torch.models.doublet against vireo_tpu.models.doublet.

- add_doublet_GT / add_doublet_theta: float64, rtol 1e-12 (the same
  products and normalisation).
- predict_doublet on int8 counts (the fused branch) against JAX with
  VIREO_FUSED_DOUBLET=interpret: both run K1's math in float32 with
  bf16-rounded W and id, so probabilities agree to atol 1e-5 and the
  log-likelihood ratio to rtol 1e-5 (float32 sum order only).
- the unfused branch (bfloat16 counts) against JAX's default branch in
  float64: rtol 1e-10.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from vireo_tpu.ops.counts import counts_from_scipy as jax_counts_from_scipy
from vireo_tpu.ops.counts import dense_counts as jax_dense_counts
from vireo_tpu.models import doublet as jd
from vireo_tpu.models.vireo import Vireo as JVireo
from vireo_tpu_torch.ops.counts import counts_from_scipy
from vireo_tpu_torch.models import doublet as td
from vireo_tpu_torch.models.vireo import Vireo as TVireo

torch.set_num_threads(1)


def _pool(seed=21, V=150, C=160, K=3, vmax=None):
    rng = np.random.RandomState(seed)
    GT = rng.randint(0, 3, size=(V, K))
    donor = rng.randint(0, K, size=C)
    donor2 = np.where(rng.rand(C) < 0.15, (donor + 1) % K, donor)
    DP = (rng.rand(V, C) < 0.3) * (1 + rng.poisson(2, size=(V, C)))
    if vmax is not None:
        DP[5, 7] = vmax
    theta = np.array([0.02, 0.5, 0.98])
    p = 0.5 * (theta[GT[:, donor]] + theta[GT[:, donor2]])
    AD = rng.binomial(DP, p)
    return sp.csc_matrix(AD.astype(float)), sp.csc_matrix(DP.astype(float))


def test_add_doublet_gt_and_theta():
    rng = np.random.RandomState(0)
    gt = rng.dirichlet(np.ones(3), size=(40, 4))
    mu = rng.rand(1, 3)
    tot = rng.gamma(5, 20, (1, 3))
    np.testing.assert_allclose(
        td.add_doublet_GT(torch.as_tensor(gt)).numpy(),
        np.asarray(jd.add_doublet_GT(jnp.asarray(gt))), rtol=1e-12)
    for j, t in zip(jd.add_doublet_theta(jnp.asarray(mu), jnp.asarray(tot)),
                    td.add_doublet_theta(torch.as_tensor(mu),
                                         torch.as_tensor(tot))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12)


def _fitted_pair(AD, DP, jc, tc):
    kw = dict(n_cell=AD.shape[1], n_var=AD.shape[0], n_donor=3)
    np.random.seed(5)
    mj = JVireo(dtype=jnp.float64, **kw)
    mj.fit(jc, max_iter=25, min_iter=3, verbose=False)
    np.random.seed(5)
    mt = TVireo(dtype=torch.float64, device="cpu", **kw)
    mt.fit(tc, max_iter=25, min_iter=3, verbose=False)
    return mj, mt


def test_predict_doublet_fused_branch(monkeypatch):
    AD, DP = _pool()
    jc = jax_counts_from_scipy(AD, DP, max_dense_elems=10)
    tc = counts_from_scipy(AD, DP)
    assert jc.ad.dtype == jnp.int8 and tc.ad.dtype == torch.int8
    mj, mt = _fitted_pair(AD, DP, jc, tc)
    monkeypatch.setenv("VIREO_FUSED_DOUBLET", "interpret")
    dj, sj, lj = jd.predict_doublet(mj, jc, None)
    dt, st, lt = td.predict_doublet(mt, tc, None)
    assert (np.argmax(st, 1) == np.argmax(sj, 1)).all()
    np.testing.assert_allclose(st, sj, atol=1e-5)
    np.testing.assert_allclose(dt, dj, atol=1e-5)
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=1e-5)
    # the GT refresh from the kernel's singlet statistics (float64 from
    # float32 statistics on both sides)
    np.testing.assert_allclose(mt.GT_prob, mj.GT_prob, atol=1e-5)
    np.testing.assert_allclose(mt.ID_prob, mj.ID_prob, atol=1e-5)


def test_predict_doublet_unfused_branch(monkeypatch):
    # counts above 127 are placed as bfloat16: the unfused branch
    AD, DP = _pool(seed=8, vmax=200)
    jc = jax_dense_counts(AD, DP, dtype=jnp.float64)
    tc = counts_from_scipy(AD, DP)
    assert tc.ad.dtype == torch.bfloat16
    mj, mt = _fitted_pair(AD, DP, jc, tc)
    monkeypatch.setenv("VIREO_FUSED_DOUBLET", "0")
    dj, sj, lj = jd.predict_doublet(mj, jc, None)
    dt, st, lt = td.predict_doublet(mt, tc, None)
    np.testing.assert_allclose(st, sj, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(dt, dj, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(lt, lj, rtol=1e-10)
    np.testing.assert_allclose(mt.GT_prob, mj.GT_prob, rtol=1e-10,
                               atol=1e-12)


def test_predict_doublet_packed_counts(monkeypatch):
    """A PackedCounts takes the unfused branch through its own
    cell_loglik (K3's plain version, float64 on the CPU), as every
    counts class but an int8 DenseCounts does: JAX's default branch in
    float64, rtol 1e-10, and K1 is not launched."""
    from vireo_tpu_torch.ops import fused_em
    from vireo_tpu_torch.ops.packed import PackedCounts, pack_dense
    AD, DP = _pool(seed=11)
    assert DP.max() <= 15
    jc = jax_dense_counts(AD, DP, dtype=jnp.float64)
    tc = pack_dense(AD.toarray(), DP.toarray())
    assert isinstance(tc, PackedCounts)
    mj, mt = _fitted_pair(AD, DP, jc, tc)
    monkeypatch.setenv("VIREO_FUSED_DOUBLET", "0")
    before = fused_em.LAUNCHES
    dj, sj, lj = jd.predict_doublet(mj, jc, None)
    dt, st, lt = td.predict_doublet(mt, tc, None)
    assert fused_em.LAUNCHES == before
    np.testing.assert_allclose(st, sj, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(dt, dj, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(lt, lj, rtol=1e-10)
    np.testing.assert_allclose(mt.GT_prob, mj.GT_prob, rtol=1e-10,
                               atol=1e-12)


def test_predict_doublet_per_cell_prior(monkeypatch):
    AD, DP = _pool(seed=3)
    jc = jax_dense_counts(AD, DP, dtype=jnp.float64)
    tc = counts_from_scipy(AD, DP)
    mj, mt = _fitted_pair(AD, DP, jc, tc)
    prior = np.random.RandomState(2).dirichlet(np.ones(3), size=AD.shape[1])
    mj.set_prior(ID_prior=prior)
    mt.set_prior(ID_prior=prior)
    monkeypatch.setenv("VIREO_FUSED_DOUBLET", "0")
    dj, sj, lj = jd.predict_doublet(mj, jc, None, update_GT=False)
    dt, st, lt = td.predict_doublet(mt, tc, None, update_GT=False)
    np.testing.assert_allclose(st, sj, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(dt, dj, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(lt, lj, rtol=1e-10)
