"""Bulk deconvolution (models/bulk.py) against the JAX package's, in
float64 on the CPU: VireoBulk's draws and fit (psi and theta within
rtol 1e-9, the same iterations and trace) and LikRatio_test."""

import numpy as np
import pytest

from vireo_tpu.models import bulk as jbulk
from vireo_tpu_torch.models import bulk as tbulk


def _bulk(seed=0, V=300, K=4):
    """A bulk sample of K donors mixed at Dirichlet fractions: genotype
    probabilities (V, K, 3) and alt/total counts."""
    rng = np.random.RandomState(seed)
    gt = rng.randint(0, 3, (V, K))
    GT_prob = np.eye(3)[gt] * 0.94 + 0.02
    psi = rng.dirichlet(np.ones(K) * 2)
    rate = (GT_prob @ np.array([0.01, 0.5, 0.99])) @ psi
    DP = rng.poisson(40, V) + 1
    AD = rng.binomial(DP, rate)
    return AD.astype(float), DP.astype(float), GT_prob, psi


@pytest.mark.parametrize("kw", [
    dict(),
    dict(learn_theta=False),
    dict(delay_fit_theta=3, min_iter=2, epsilon_conv=1e-6),
    dict(max_iter=4),
])
def test_vireo_bulk_fit_matches_jax(kw, capsys):
    AD, DP, GT_prob, _ = _bulk()
    out = {}
    for name, mod in (("jax", jbulk), ("torch", tbulk)):
        np.random.seed(2)
        m = mod.VireoBulk(4) if name == "jax" \
            else mod.VireoBulk(4, device="cpu")
        m.fit(AD, DP, GT_prob, verbose=True, **kw)
        out[name] = (m, np.random.rand(), capsys.readouterr().out)
    (j, j_tail, j_out), (t, t_tail, t_out) = out["jax"], out["torch"]
    assert t_tail == j_tail and t_out == j_out
    np.testing.assert_allclose(t.psi, j.psi, rtol=1e-9)
    np.testing.assert_allclose(t.theta, j.theta, rtol=1e-9)
    assert len(t.logLik_all) == len(j.logLik_all)
    np.testing.assert_allclose(t.logLik_all, j.logLik_all, rtol=1e-9)
    np.testing.assert_allclose(t.logLik, j.logLik, rtol=1e-9)


def test_vireo_bulk_init_draws_even_with_inits():
    """__init__ draws a Dirichlet psi and a uniform theta from numpy's
    stream even when both inits are given, and warns on a wrong length,
    as JAX's does."""
    for args in (dict(psi_init=[0.5, 0.5]),
                 dict(psi_init=[1.0], theta_init=(0.1, 0.9))):
        np.random.seed(7)
        j = jbulk.VireoBulk(2, **args)
        j_tail = np.random.rand()
        np.random.seed(7)
        t = tbulk.VireoBulk(2, device="cpu", **args)
        assert np.random.rand() == j_tail
        np.testing.assert_array_equal(t.psi, j.psi)
        np.testing.assert_array_equal(t.theta, j.theta)


def test_fit_recovers_the_mixture():
    """With theta fixed at the simulation's rates the fit finds the
    mixture (learning theta as well trades it against psi on this
    pool, in both packages)."""
    AD, DP, GT_prob, psi = _bulk(seed=3, V=3000)
    np.random.seed(0)
    m = tbulk.VireoBulk(4, device="cpu")
    m.fit(AD, DP, GT_prob, learn_theta=False)
    assert np.abs(m.psi - psi).max() < 0.03


@pytest.mark.parametrize("log", [False, True])
def test_likratio_test_matches_jax(log):
    AD, DP, GT_prob, psi = _bulk(seed=1)
    theta = np.array([0.01, 0.5, 0.99])
    null = np.ones(4) / 4
    want = jbulk.LikRatio_test(psi, null, AD, DP, GT_prob, theta, log=log)
    got = tbulk.LikRatio_test(psi, null, AD, DP, GT_prob, theta, log=log,
                              device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-9)
    np.random.seed(0)
    m = tbulk.VireoBulk(4, device="cpu")
    m.fit(AD, DP, GT_prob)
    LR, p = m.LR_test(psi_null=null, AD=AD, DP=DP, GT_prob=GT_prob,
                      log=log, device="cpu")
    assert LR > 0 and (p < 0 if log else 0 <= p < 1e-3)
