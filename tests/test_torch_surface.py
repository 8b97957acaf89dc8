"""The port's package surface against the JAX package's: every top-level
name that vireo_tpu/__init__.py binds resolves in vireo_tpu_torch, to the
port's counterpart, while `import vireo_tpu_torch` imports no submodule;
and the names this surface added (`get_binom_coeff`, `dense_counts`,
`Counts`, `SparseCounts.pack`, `run_em_iters_n`) equal JAX's in float64."""

import ast
import inspect
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import vireo_tpu
import vireo_tpu_torch

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(1)


def _jax_top_level_names():
    """The names bound by vireo_tpu/__init__.py's own statements."""
    tree = ast.parse((REPO / "vireo_tpu" / "__init__.py").read_text())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names += [a.asname or a.name.split(".")[0] for a in node.names]
    return names


JAX_NAMES = _jax_top_level_names()


def test_the_jax_surface_is_what_it_was():
    assert len(JAX_NAMES) == 29
    assert {"vcf", "base", "model", "plot", "vireo_wrap", "Counts",
            "get_binom_coeff", "dense_counts"} <= set(JAX_NAMES)


@pytest.mark.parametrize("name", JAX_NAMES)
def test_every_jax_name_resolves_in_the_port(name):
    want = getattr(vireo_tpu, name)
    got = getattr(vireo_tpu_torch, name)
    if isinstance(want, types.ModuleType):
        assert isinstance(got, types.ModuleType)
        # the counterpart of the same path
        assert got.__name__.replace("vireo_tpu_torch", "vireo_tpu") \
            == want.__name__
    elif isinstance(want, tuple):
        assert [c.__name__ for c in got] == [c.__name__ for c in want]
    elif isinstance(want, str):          # __version__: each package's own
        assert isinstance(got, str) and got
    else:
        assert callable(got) and got.__name__ == want.__name__
        assert got.__module__.startswith("vireo_tpu_torch.")
    assert name in dir(vireo_tpu_torch)


def test_unknown_name_raises_attribute_error():
    with pytest.raises(AttributeError):
        vireo_tpu_torch.no_such_name


def test_import_loads_no_submodule():
    code = ("import sys, vireo_tpu_torch as v; "
            "mods = sorted(m for m in sys.modules "
            "if m.startswith('vireo_tpu_torch.') "
            "and m != 'vireo_tpu_torch.version'); "
            "assert not mods, mods; "
            "assert 'torch' not in sys.modules; "
            "v.optimal_match; "
            "assert 'vireo_tpu_torch.ops.matching' in sys.modules; "
            "assert 'vireo_tpu_torch.engine.wrap' not in sys.modules")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_get_binom_coeff_matches_jax():
    rng = np.random.RandomState(0)
    DP = rng.poisson(3, (30, 20)) * (rng.rand(30, 20) < 0.5)
    AD = rng.binomial(DP, 0.4)
    DP[0, 0], AD[0, 0] = 2000, 1000          # past the 700 clip
    got = vireo_tpu_torch.get_binom_coeff(AD, DP)
    want = np.asarray(vireo_tpu.get_binom_coeff(AD, DP))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.max() == 700


def test_normalize_and_amplify_match_jax():
    X = np.random.RandomState(1).rand(5, 4) * 10
    for name in ("normalize", "loglik_amplify"):
        got = getattr(vireo_tpu_torch, name)(torch.from_numpy(X))
        want = getattr(vireo_tpu, name)(jnp.asarray(X))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-15)


@pytest.fixture()
def pool(small_data):
    AD, DP, _ = small_data
    return AD, DP


def test_dense_counts_matches_jax(pool):
    AD, DP = pool
    got = vireo_tpu_torch.dense_counts(AD, DP, dtype=torch.float64,
                                       device="cpu")
    want = vireo_tpu.dense_counts(AD, DP, dtype=jnp.float64)
    assert isinstance(got, vireo_tpu_torch.Counts)
    assert isinstance(want, vireo_tpu.Counts)
    for a, b in ((got.ad, want.ad), (got.dp, want.dp)):
        assert a.dtype == torch.float64
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    W = np.random.RandomState(2).rand(AD.shape[1], 3)
    for a, b in zip(got.suff_stats(torch.from_numpy(W)),
                    want.suff_stats(jnp.asarray(W))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)


@pytest.mark.parametrize("clip", [False, True])
def test_sparse_counts_pack_matches_jax(pool, clip):
    from vireo_tpu.ops.counts import sparse_counts as j_sparse
    from vireo_tpu_torch.ops.packed import PackedCounts
    AD, DP = pool
    if clip:                       # counts above the nibble cap saturate
        DP = sp.csc_matrix(DP.toarray() * 4.0)
        AD = sp.csc_matrix(AD.toarray() * 4.0)
    else:
        assert DP.max() <= 15
    got = vireo_tpu_torch.sparse_counts(AD, DP, device="cpu").pack(clip=clip)
    want = j_sparse(AD, DP).pack(clip=clip)
    assert isinstance(got, PackedCounts) and got.shape == want.shape
    # the same nibbles, byte for byte (JAX pads its layout to blocks)
    V, Cb = got.ad_p.shape
    for a, b in ((got.ad_p, want.ad_p), (got.dp_p, want.dp_p)):
        np.testing.assert_array_equal(
            a.numpy(), np.asarray(b)[:V, :Cb].view(np.uint8))
    W = np.random.RandomState(3).rand(AD.shape[1], 4)
    S1, SS = got.suff_stats(torch.from_numpy(W))
    for M, S in ((AD, S1), (DP, SS)):
        dense = np.minimum(M.toarray(), 15) if clip else M.toarray()
        np.testing.assert_allclose(S.numpy(), dense @ W, rtol=1e-12)


def test_run_em_iters_n_matches_jax(pool):
    from vireo_tpu.models import vireo as jv
    from vireo_tpu_torch.models import vireo as tv
    AD, DP = pool
    assert tv.run_em_iters_n is tv.run_em_iters
    assert "n_iters" in inspect.signature(tv.run_em_iters_n).parameters
    cfg_t = tv.VireoConfig(n_var=60, n_cell=40, n_donor=3)
    cfg_j = jv.VireoConfig(n_var=60, n_cell=40, n_donor=3)
    idp, gtp = tv.random_init_arrays(cfg_t, rng=np.random.RandomState(4))
    init = dict(ID_prob_init=idp, GT_prob_init=gtp)
    st_t = tv.init_state(cfg_t, **init, dtype=torch.float64, device="cpu")
    st_j = jv.init_state(cfg_j, **init, dtype=jnp.float64)
    st_t, elbo_t = tv.run_em_iters_n(
        vireo_tpu_torch.dense_counts(AD, DP, dtype=torch.float64,
                                     device="cpu"),
        st_t, tv.default_priors(cfg_t, dtype=torch.float64, device="cpu"),
        cfg_t, 7)
    st_j, elbo_j = jv.run_em_iters_n(
        vireo_tpu.dense_counts(AD, DP, dtype=jnp.float64), st_j,
        jv.default_priors(cfg_j, dtype=jnp.float64), cfg_j, 7)
    np.testing.assert_allclose(float(elbo_t), float(elbo_j), rtol=1e-10)
    np.testing.assert_allclose(st_t.id_prob.numpy(),
                               np.asarray(st_j.id_prob), rtol=1e-9,
                               atol=1e-12)
