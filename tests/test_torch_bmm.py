"""The binomial mixture model (models/bmm.py) against the JAX package's,
in float64 on the CPU, on synthetic clones (the mito demo data of the
reference is absent): one step, a fit, and BinomMixtureVB.fit with its
batched restarts, with identical iterations and ELBOs within rtol 1e-9;
then the same fit on the packed and hybrid rungs of the port against its
dense result; and warn_from_trace's three styles against JAX's."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from vireo_tpu.models import bmm as jbmm
from vireo_tpu.models.vireo import warn_from_trace as j_warn
from vireo_tpu.ops.counts import dense_counts as jax_dense_counts
from vireo_tpu_torch.models import bmm as tbmm
from vireo_tpu_torch.models.vireo import warn_from_trace as t_warn
from vireo_tpu_torch.ops import counts as tcounts

torch.set_num_threads(1)

RTOL = 1e-9


def _clones(seed=0, V=40, C=150, K=3, depth=2, heavy=False):
    """Cells of K clones: each clone has its own alt rate per variant
    (Beta(0.4, 0.4)), depth Poisson around `depth` at half the sites;
    `heavy` raises ~3% of the covered sites into the hundreds. Shallow
    enough that restarts stop at different iterations."""
    rng = np.random.RandomState(seed)
    rate = rng.beta(0.4, 0.4, size=(V, K))
    clone = rng.randint(0, K, C)
    DP = rng.poisson(depth, (V, C)) * (rng.rand(V, C) < 0.5)
    DP = np.minimum(DP, 15)
    if heavy:
        DP = DP + ((DP > 0) & (rng.rand(V, C) < 0.03)) \
            * rng.randint(150, 400, (V, C))
    AD = rng.binomial(DP, rate[:, clone])
    return sp.csc_matrix(AD.astype(float)), sp.csc_matrix(DP.astype(float))


def _jax_model(AD, DP, K, seed):
    np.random.seed(seed)
    return jbmm.BinomMixtureVB(n_cell=AD.shape[1], n_var=AD.shape[0],
                               n_donor=K, dtype=jnp.float64)


def _torch_model(AD, DP, K, seed):
    np.random.seed(seed)
    return tbmm.BinomMixtureVB(n_cell=AD.shape[1], n_var=AD.shape[0],
                               n_donor=K, device="cpu")


def test_bmm_step_matches_jax():
    AD, DP = _clones()
    jm, tm = _jax_model(AD, DP, 3, 31), _torch_model(AD, DP, 3, 31)
    np.testing.assert_array_equal(tm.ID_prob, np.asarray(jm.ID_prob))
    jc = jax_dense_counts(AD, DP, dtype=jnp.float64)
    tc = tcounts.counts_from_scipy(AD, DP, device="cpu")
    for _ in range(4):
        jm.state, j_ll, j_elbo = jbmm.bmm_step(jc, jm.state, jm.priors)
        tm.state, t_ll, t_elbo = tbmm.bmm_step(tc, tm.state, tm.priors)
        for f in ("beta_mu", "beta_sum", "ID_prob"):
            np.testing.assert_allclose(getattr(tm, f),
                                       np.asarray(getattr(jm, f)),
                                       rtol=RTOL, atol=1e-14, err_msg=f)
        np.testing.assert_allclose(t_ll.numpy(), np.asarray(j_ll),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(t_elbo), float(j_elbo), rtol=RTOL)


@pytest.mark.parametrize("fix_beta_sum", [False, True])
def test_fit_bmm_matches_jax(fix_beta_sum):
    AD, DP = _clones(seed=1)
    jm, tm = _jax_model(AD, DP, 3, 5), _torch_model(AD, DP, 3, 5)
    jc = jax_dense_counts(AD, DP, dtype=jnp.float64)
    tc = tcounts.counts_from_scipy(AD, DP, device="cpu")
    j = jbmm.fit_bmm(jc, jm.state, jm.priors, max_iter=60, min_iter=3,
                     fix_beta_sum=fix_beta_sum)
    t = tbmm.fit_bmm(tc, tm.state, tm.priors, max_iter=60, min_iter=3,
                     fix_beta_sum=fix_beta_sum)
    assert t[3] == int(j[3]) > 4
    np.testing.assert_allclose(t[4], np.asarray(j[4]), rtol=RTOL,
                               equal_nan=True)
    for a, b in zip(t[1:3], j[1:3]):
        np.testing.assert_allclose(a, float(b), rtol=RTOL)
    np.testing.assert_allclose(t[0].id_prob.numpy(),
                               np.asarray(j[0].id_prob), rtol=RTOL,
                               atol=1e-14)


def _record(monkeypatch, module, calls):
    """Keep every fit_bmm's per-restart iterations."""
    real = module.fit_bmm

    def spy(*args, **kwargs):
        res = real(*args, **kwargs)
        calls.append(np.atleast_1d(np.asarray(res[3])).copy())
        return res

    monkeypatch.setattr(module, "fit_bmm", spy)


def _jax_warm_iters(AD, DP, K, seed, n_init, **kw):
    """JAX's warm restarts vmap fit_bmm inside `fit`; the same vmap, on
    the same inits, reads their iterations."""
    import jax
    jm = _jax_model(AD, DP, K, 0)
    np.random.seed(seed)
    inits = []
    for _ in range(n_init):
        jm.set_initial(rng=np.random)
        inits.append(jm.state)
    batched = jax.tree.map(lambda *xs: jnp.stack(xs), *inits)
    jc = jax_dense_counts(AD, DP, dtype=jnp.float64)
    res = jax.vmap(lambda st: jbmm.fit_bmm(jc, st, jm.priors, **kw))(batched)
    return np.asarray(res[3])


@pytest.fixture(scope="module")
def jax_fit():
    AD, DP = _clones(seed=2, C=200)
    jm = _jax_model(AD, DP, 3, 0)
    jm.fit(jax_dense_counts(AD, DP, dtype=jnp.float64), None, n_init=6,
           max_iter_pre=40, min_iter=3, random_seed=4, verbose=False)
    warm = _jax_warm_iters(AD, DP, 3, 4, 6, max_iter=40, min_iter=3)
    return AD, DP, jm, warm


def test_binom_mixture_fit_matches_jax(jax_fit, monkeypatch):
    AD, DP, jm, j_warm = jax_fit
    calls = []
    _record(monkeypatch, tbmm, calls)
    tm = _torch_model(AD, DP, 3, 0)
    tm.fit(AD, DP, n_init=6, max_iter_pre=40, min_iter=3, random_seed=4,
           verbose=False)
    np.testing.assert_array_equal(calls[0], j_warm)
    assert len(set(calls[0].tolist())) > 1     # restarts stop apart
    assert len(tm.ELBO_iters) == len(jm.ELBO_iters)
    np.testing.assert_allclose(tm.ELBO_inits, jm.ELBO_inits, rtol=RTOL)
    np.testing.assert_allclose(tm.ELBO_iters, jm.ELBO_iters, rtol=RTOL)
    for f in ("beta_mu", "beta_sum", "ID_prob"):
        np.testing.assert_allclose(getattr(tm, f), getattr(jm, f),
                                   rtol=RTOL, atol=1e-12, err_msg=f)


@pytest.mark.parametrize("budget,cls,heavy", [
    (1, "PackedCounts", False),
    (2, "HybridCounts", True),
    (1, "HybridCounts", True),
    (0, "SparseCounts", True),
])
def test_binom_mixture_fit_on_every_rung(budget, cls, heavy, monkeypatch):
    """The fit on each non-dense rung of the port against its own dense
    rung (JAX's `_as_counts` takes none of these): the same iterations
    and ELBOs within rtol 1e-9."""
    AD, DP = _clones(seed=3, heavy=heavy)
    nbytes = max(budget * AD.shape[0] * AD.shape[1], 1)
    counts = tcounts.counts_from_scipy(AD, DP, device="cpu",
                                       dense_budget=nbytes)
    assert type(counts).__name__ == cls
    runs = []
    for c in (tcounts.counts_from_scipy(AD, DP, device="cpu"), counts):
        calls = []
        with monkeypatch.context() as mp:
            _record(mp, tbmm, calls)
            m = _torch_model(AD, DP, 3, 0)
            m.fit(c, n_init=4, max_iter_pre=30, min_iter=3, random_seed=1,
                  verbose=False)
        runs.append((m, calls))
    (d, d_calls), (r, r_calls) = runs
    for a, b in zip(d_calls, r_calls):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(r.ELBO_inits, d.ELBO_inits, rtol=RTOL)
    np.testing.assert_allclose(r.ELBO_iters, d.ELBO_iters, rtol=RTOL)
    np.testing.assert_allclose(r.ID_prob, d.ID_prob, rtol=RTOL, atol=1e-12)


def test_batched_restarts_equal_single_fits():
    """Each restart of a batched fit_bmm stops at its own test and gives
    what it gives alone."""
    AD, DP = _clones(seed=4)
    tc = tcounts.counts_from_scipy(AD, DP, device="cpu")
    m = _torch_model(AD, DP, 3, 0)
    np.random.seed(8)
    inits = []
    for _ in range(4):
        m.set_initial(rng=np.random)
        inits.append(m.state)
    batched = tbmm.BmmState(*(torch.stack([getattr(s, f) for s in inits])
                              for f in ("beta_mu", "beta_sum", "id_prob")))
    st, ref, fin, n_it, trace = tbmm.fit_bmm(tc, batched, m.priors,
                                             max_iter=50, min_iter=3)
    assert len(set(n_it.tolist())) > 1
    for i, s in enumerate(inits):
        one = tbmm.fit_bmm(tc, s, m.priors, max_iter=50, min_iter=3)
        assert one[3] == n_it[i]
        np.testing.assert_allclose(one[1], ref[i], rtol=1e-12)
        np.testing.assert_allclose(one[0].id_prob.numpy(),
                                   st.id_prob[i].numpy(), rtol=1e-12,
                                   atol=1e-15)


@pytest.mark.parametrize("style", ["vireo", "bmm", "bulk"])
def test_warn_from_trace_styles_match_jax(style, capsys):
    trace = np.array([-10.0, -9.0, -8.5, -8.5 - 5e-7, -8.4, -8.41, -8.3,
                      -8.3 - 2e-6, -8.2, -8.1])
    for n_iter, max_iter in ((10, 10), (8, 20), (3, 10)):
        want = j_warn(trace, n_iter, max_iter, 2, style=style)
        out_j = capsys.readouterr().out
        got = t_warn(trace, n_iter, max_iter, 2, style=style)
        assert got == want and capsys.readouterr().out == out_j
    assert t_warn(trace, 10, 10, 2, style=style) == \
        {"vireo": 2, "bmm": 2, "bulk": 3}[style]
