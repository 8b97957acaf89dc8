"""vireo_tpu_torch.models.doublet against vireo_tpu.models.doublet.

- add_doublet_GT / add_doublet_theta: float64, rtol 1e-12 (the same
  products and normalisation).
- predict_doublet on int8 counts (the fused branch) against JAX with
  VIREO_FUSED_DOUBLET=interpret: both run K1's math in float32 with
  bf16-rounded W and id, so probabilities agree to atol 1e-5 and the
  log-likelihood ratio to rtol 1e-5 (float32 sum order only).
- the unfused branch (bfloat16 counts) against JAX's default branch in
  float64: rtol 1e-10.
- a 23-donor pool (K + C(K,2) = 276 columns) on int8 counts: through
  K1's plain version with the fused branch's tolerances, and, with K1's
  column limit `fused_em.MAX_K` set below 276, around K1 with the
  unfused branch's float64 tolerances.
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


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's entry points run on the card unless asked for the CPU
    (utils/device.py); these tests ask for it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIREO_PLATFORM", "cpu")
        yield


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


def _fitted_pair(AD, DP, jc, tc, n_donor=3):
    kw = dict(n_cell=AD.shape[1], n_var=AD.shape[0], n_donor=n_donor)
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


@pytest.mark.parametrize("route", ["fused", "above_max_k"])
def test_predict_doublet_23_donors(monkeypatch, route):
    """23 donors give 276 doublet columns, more than the first CUDA K1
    took (256), on int8 counts. With K1's limit `MAX_K` above 276 the
    port sends them through K1 (its plain version here) and matches the
    JAX kernel in interpret mode at the fused branch's tolerances; with
    the limit set below 276 it takes the unfused path, as the JAX
    package's default does, and matches it in float64."""
    from vireo_tpu_torch.ops import fused_em
    K = 23
    AD, DP = _pool(seed=23, V=120, C=200, K=K)
    tc = counts_from_scipy(AD, DP)
    assert tc.ad.dtype == torch.int8
    n_cols = K + K * (K - 1) // 2
    calls = []
    real = fused_em.fused_estep_stats
    monkeypatch.setattr(fused_em, "fused_estep_stats",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    if route == "fused":
        assert n_cols == 276 <= fused_em.MAX_K
        jc = jax_counts_from_scipy(AD, DP, max_dense_elems=10)
        monkeypatch.setenv("VIREO_FUSED_DOUBLET", "interpret")
    else:
        monkeypatch.setattr(fused_em, "MAX_K", n_cols - 1)
        jc = jax_dense_counts(AD, DP, dtype=jnp.float64)
        monkeypatch.setenv("VIREO_FUSED_DOUBLET", "0")
    mj, mt = _fitted_pair(AD, DP, jc, tc, n_donor=K)
    dj, sj, lj = jd.predict_doublet(mj, jc, None)
    dt, st, lt = td.predict_doublet(mt, tc, None)
    assert dt.shape == (200, n_cols - K) and st.shape == (200, K)
    if route == "fused":
        assert calls == [1]
        np.testing.assert_allclose(st, sj, atol=1e-5)
        np.testing.assert_allclose(dt, dj, atol=1e-5)
        np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(mt.GT_prob, mj.GT_prob, atol=1e-5)
    else:
        assert calls == []
        np.testing.assert_allclose(st, sj, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(dt, dj, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(lt, lj, rtol=1e-10)
        np.testing.assert_allclose(mt.GT_prob, mj.GT_prob, rtol=1e-10,
                                   atol=1e-12)
    np.testing.assert_allclose(mt.ID_prob, mj.ID_prob, atol=1e-5)


@pytest.mark.parametrize("n_donor,fused", [(23, True), (44, True),
                                           (45, False)])
def test_doublet_dispatch_follows_max_k(n_donor, fused):
    """An int8 DenseCounts goes to K1 while K + C(K,2) <= MAX_K (1024:
    44 donors give 990 columns, 45 give 1035); any other counts class
    never does."""
    from vireo_tpu_torch.ops.packed import pack_dense
    AD, DP = _pool(seed=1, V=20, C=30)
    n_cols = n_donor + n_donor * (n_donor - 1) // 2
    assert td.takes_fused_estep(counts_from_scipy(AD, DP), n_cols) is fused
    assert not td.takes_fused_estep(
        pack_dense(AD.toarray(), DP.toarray()), n_cols)
