"""vireo_tpu_torch.models.doublet against vireo_tpu.models.doublet.

- add_doublet_GT / add_doublet_theta: float64, rtol 1e-12 (the same
  products and normalisation).
- predict_doublet by default (VIREO_FUSED_DOUBLET unset on both sides)
  on int8 counts: both take the unfused path, the expanded
  log-likelihood through the counts' cell_loglik (K0's plain version
  here) and update_GT_prob's E-step, in float64: rtol 1e-9, atol 1e-12,
  identical calls.
- predict_doublet under VIREO_FUSED_DOUBLET=interpret on int8 counts
  (the fused branch): both run K1's math in float32 with bf16-rounded
  W and id, so probabilities agree to atol 1e-5 and the log-likelihood
  ratio to rtol 1e-5 (float32 sum order only).
- the unfused branch (bfloat16 counts) against JAX's default branch in
  float64: rtol 1e-10.
- a 23-donor pool (K + C(K,2) = 276 columns) on int8 counts: under the
  knob through K1's plain version with the fused branch's tolerances,
  and, with K1's column limit `fused_em.MAX_K` set below 276, around K1
  with the unfused branch's float64 tolerances.
- takes_fused_estep against the JAX package's _fused_doublet_mode:
  every value of the knob (K1 where JAX picks a mode, the same
  warning), every counts class, a per-cell prior and the column limit.
"""

import types
import warnings

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
    monkeypatch.delenv("VIREO_FUSED_DOUBLET", raising=False)
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
    monkeypatch.delenv("VIREO_FUSED_DOUBLET", raising=False)
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
    monkeypatch.delenv("VIREO_FUSED_DOUBLET", raising=False)
    dj, sj, lj = jd.predict_doublet(mj, jc, None, update_GT=False)
    dt, st, lt = td.predict_doublet(mt, tc, None, update_GT=False)
    np.testing.assert_allclose(st, sj, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(dt, dj, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(lt, lj, rtol=1e-10)


@pytest.mark.parametrize("route", ["fused", "above_max_k"])
def test_predict_doublet_23_donors(monkeypatch, route):
    """23 donors give 276 doublet columns, more than the first CUDA K1
    took (256), on int8 counts, under VIREO_FUSED_DOUBLET. With K1's
    limit `MAX_K` above 276 the port sends them through K1 (its plain
    version here) and matches the JAX kernel in interpret mode at the
    fused branch's tolerances; with the limit set below 276 it takes the
    unfused path despite the knob, and matches the JAX package's
    unfused path in float64."""
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
        # the knob asks for K1 and the port's column limit declines; the
        # JAX side's float64 counts take its unfused path under the knob
        monkeypatch.setattr(fused_em, "MAX_K", n_cols - 1)
        jc = jax_dense_counts(AD, DP, dtype=jnp.float64)
        monkeypatch.setenv("VIREO_FUSED_DOUBLET", "1")
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
def test_doublet_dispatch_follows_max_k(monkeypatch, n_donor, fused):
    """Under VIREO_FUSED_DOUBLET an int8 DenseCounts goes to K1 while
    K + C(K,2) <= MAX_K (1024: 44 donors give 990 columns, 45 give
    1035); any other counts class never."""
    from vireo_tpu_torch.ops.packed import pack_dense
    monkeypatch.setenv("VIREO_FUSED_DOUBLET", "1")
    AD, DP = _pool(seed=1, V=20, C=30)
    n_cols = n_donor + n_donor * (n_donor - 1) // 2
    assert td.takes_fused_estep(counts_from_scipy(AD, DP), n_cols,
                                True) is fused
    assert not td.takes_fused_estep(
        pack_dense(AD.toarray(), DP.toarray()), n_cols, True)


def test_predict_doublet_default_matches_jax_default(monkeypatch):
    """Neither side sets VIREO_FUSED_DOUBLET: on int8 counts both run the
    unfused doublet phase, the port's through K0 (its plain version on
    the CPU) at N = K + C(K,2), then update_GT_prob's E-step through K0
    at N = K, and never K1. Equal to JAX's default in float64 at
    round-off, every call identical."""
    from vireo_tpu_torch.ops import counts as tcounts, fused_em
    monkeypatch.delenv("VIREO_FUSED_DOUBLET", raising=False)
    AD, DP = _pool()
    jc = jax_counts_from_scipy(AD, DP, max_dense_elems=10)
    tc = counts_from_scipy(AD, DP)
    assert jc.ad.dtype == jnp.int8 and tc.ad.dtype == torch.int8
    mj, mt = _fitted_pair(AD, DP, jc, tc)
    widths, k1 = [], []
    for name in ("dense_suff_stats", "dense_cell_loglik"):
        real = getattr(tcounts, name)
        monkeypatch.setattr(tcounts, name, lambda *a, real=real, name=name:
                            widths.append((name, a[2].shape[1]))
                            or real(*a))
    real_k1 = fused_em.fused_estep_stats
    monkeypatch.setattr(fused_em, "fused_estep_stats",
                        lambda *a, **k: k1.append(1) or real_k1(*a, **k))
    dj, sj, lj = jd.predict_doublet(mj, jc, None)
    dt, st, lt = td.predict_doublet(mt, tc, None)
    assert k1 == []
    assert widths == [("dense_cell_loglik", 6), ("dense_suff_stats", 3),
                      ("dense_cell_loglik", 3)]
    both_t, both_j = np.hstack([st, dt]), np.hstack([sj, dj])
    np.testing.assert_array_equal(np.argmax(both_t, 1),
                                  np.argmax(both_j, 1))
    np.testing.assert_allclose(st, sj, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(dt, dj, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(lt, lj, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(mt.GT_prob, mj.GT_prob, rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(mt.ID_prob, np.asarray(mj.ID_prob),
                               rtol=1e-9, atol=1e-12)


def _jax_vobj(id_log):
    """What JAX's _fused_doublet_mode reads of a model: its priors."""
    return types.SimpleNamespace(priors=types.SimpleNamespace(
        id_log=id_log))


def _modes(counts_t, counts_j, n_cols=6, row_prior=True):
    """Whether the port and JAX take their fused doublet pass on one
    input, and the messages of the warnings each gave."""
    id_log = np.zeros((1 if row_prior else counts_t.n_cell, 3))
    out = []
    for fn in (lambda: td.takes_fused_estep(counts_t, n_cols, row_prior),
               lambda: jd._fused_doublet_mode(counts_j, _jax_vobj(id_log))
               is not None):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            mode = fn()
        out.append((mode, [str(w.message) for w in seen]))
    return out


@pytest.mark.parametrize("knob,want", [
    (None, False), ("0", False), ("off", False), ("no", False),
    ("", False), ("OFF", False), ("1", True), ("on", True), ("yes", True),
    ("kernel", True), ("Yes", True), ("interpret", True),
    ("INTERPRET", True), ("2", "warn"), ("fused", "warn"),
])
def test_fused_doublet_mode_reads_the_knob_as_jax(monkeypatch, knob, want):
    """Every value of VIREO_FUSED_DOUBLET on int8 dense counts with a row
    prior: the port takes K1 where the JAX package picks a fused mode
    (`interpret` too: K1's plain version on the CPU, the kernel on a
    card), and an invalid value gives the same warning and the unfused
    path."""
    if knob is None:
        monkeypatch.delenv("VIREO_FUSED_DOUBLET", raising=False)
    else:
        monkeypatch.setenv("VIREO_FUSED_DOUBLET", knob)
    AD, DP = _pool(seed=1, V=20, C=30)
    (mt, wt), (mj, wj) = _modes(
        counts_from_scipy(AD, DP),
        jax_counts_from_scipy(AD, DP, max_dense_elems=10))
    assert mt == mj == (False if want == "warn" else want)
    assert wt == wj and len(wt) == (want == "warn")


@pytest.mark.parametrize("knob", ["1", None])
@pytest.mark.parametrize("case,port,jax", [
    ("int8", True, True),
    # kept by design (ROADMAP queue 3): K1 reads int8 bytes
    ("bfloat16", False, True),
    ("float32", False, False),
    ("float64", False, False),
    ("packed", False, False),
    ("per-cell prior", False, False),
    # K1's column limit (fused_em.MAX_K); the JAX kernel has none
    ("above MAX_K", False, True),
])
def test_fused_doublet_mode_by_counts_and_prior(monkeypatch, knob, case,
                                                port, jax):
    """Which inputs the knob sends to K1, against the JAX package's
    choice on the same inputs; with the knob unset, none."""
    from vireo_tpu_torch.ops import counts as tcounts, fused_em
    from vireo_tpu_torch.ops.packed import pack_dense
    if knob is None:
        monkeypatch.delenv("VIREO_FUSED_DOUBLET", raising=False)
        port = jax = False
    else:
        monkeypatch.setenv("VIREO_FUSED_DOUBLET", knob)
    AD, DP = _pool(seed=1, V=20, C=30)
    dtypes = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
              "float32": (torch.float32, jnp.float32),
              "float64": (torch.float64, jnp.float64)}
    if case in dtypes:
        tdt, jdt = dtypes[case]
        tc = tcounts.dense_counts(AD, DP, dtype=tdt, device="cpu")
        jc = jax_dense_counts(AD, DP, dtype=jdt)
    else:
        tc = counts_from_scipy(AD, DP)
        jc = jax_counts_from_scipy(AD, DP, max_dense_elems=10)
        assert tc.ad.dtype == torch.int8 and jc.ad.dtype == jnp.int8
    if case == "packed":
        from vireo_tpu.ops.packed import pack_dense as jax_pack_dense
        tc = pack_dense(AD.toarray(), DP.toarray())
        jc = jax_pack_dense(AD.toarray(), DP.toarray())
    n_cols = fused_em.MAX_K + 1 if case == "above MAX_K" else 6
    (mt, wt), (mj, wj) = _modes(tc, jc, n_cols,
                                row_prior=case != "per-cell prior")
    assert (mt, mj) == (port, jax) and wt == wj == []
