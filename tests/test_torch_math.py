"""vireo_tpu_torch.ops.math against vireo_tpu.ops.math, in float64.

Tolerance: rtol 1e-10. Both sides run the same formulas in float64;
lgamma and digamma come from different libraries (XLA vs ATen), which
differ only in round-off.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vireo_tpu.ops import math as jm
from vireo_tpu_torch.ops import math as tm

torch.set_num_threads(1)

RTOL = 1e-10


def _pair(x):
    return jnp.asarray(x), torch.as_tensor(x)


def _close(j, t, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


@pytest.fixture
def rng():
    return np.random.RandomState(3)


def test_betaln_and_digamma_triplet(rng):
    a, b = rng.gamma(2.0, 20.0, (5, 3)) + 0.1, rng.gamma(2.0, 20.0, (5, 3))
    (ja, ta), (jb, tb) = _pair(a), _pair(b)
    _close(jm.betaln(ja, jb), tm.betaln(ta, tb))
    for j, t in zip(jm.digamma_triplet(ja, jb), tm.digamma_triplet(ta, tb)):
        _close(j, t)


@pytest.mark.parametrize("axis", [-1, 0])
def test_softmax_helpers(rng, axis):
    x = rng.randn(7, 4) * 30
    p = np.log(rng.dirichlet(np.ones(4)))[None, :] if axis == -1 \
        else np.log(rng.dirichlet(np.ones(7)))[:, None]
    (jx, tx), (jp, tp) = _pair(x), _pair(p)
    _close(jm.normalize(jnp.abs(jx), axis), tm.normalize(tx.abs(), axis))
    _close(jm.loglik_amplify(jx, axis), tm.loglik_amplify(tx, axis))
    _close(jm.softmax_from_loglik(jx, jp, axis),
           tm.softmax_from_loglik(tx, tp, axis), atol=1e-300)


def test_kl_categorical_zero_convention(rng):
    P = rng.dirichlet(np.ones(5), size=6)
    P[0, 2] = 0.0          # exact zeros add nothing
    P[0] /= P[0].sum()
    prior = np.log(rng.dirichlet(np.ones(5)))[None, :]
    (jP, tP), (jq, tq) = _pair(P), _pair(prior)
    _close(jm.kl_categorical(jP, jq), tm.kl_categorical(tP, tq))
    # the batched form keeps the leading axis: one value per slice
    per_row = tm.kl_categorical(tP[:, None, :], tq, batch_ndim=1)
    _close(jnp.stack([jm.kl_categorical(jP[i], jq) for i in range(6)]),
           per_row)


def test_beta_entropy(rng):
    s1, s2 = rng.gamma(2.0, 30.0, (4, 3)) + 1, rng.gamma(2.0, 30.0, (4, 3)) + 1
    q1, q2 = np.array([[0.5, 25.0, 49.5]]), np.array([[49.5, 25.0, 0.5]])
    (j1, t1), (j2, t2), (jq1, tq1), (jq2, tq2) = map(_pair, (s1, s2, q1, q2))
    _close(jm.beta_entropy(j1, j2), tm.beta_entropy(t1, t2))
    _close(jm.beta_entropy(j1, j2, jq1, jq2),
           tm.beta_entropy(t1, t2, tq1, tq2))


def test_log_binom_coeff_clip_and_zero(rng):
    dp = rng.randint(0, 40, size=200).astype(np.float64)
    ad = np.floor(dp * rng.rand(200))
    dp[:3] = [0, 2000, 1500]            # zero coverage and the 700 clip
    ad[:3] = [0, 1000, 700]
    (jd, td), (ja, ta) = _pair(dp), _pair(ad)
    t = tm.log_binom_coeff(td, ta)
    _close(jm.log_binom_coeff(jd, ja), t)
    assert t[0] == 0.0 and t[1] == 700.0
