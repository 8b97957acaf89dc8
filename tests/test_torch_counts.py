"""vireo_tpu_torch.ops.counts (dense rung) against vireo_tpu.ops.counts.

Contractions run in float64 on both sides over the same exact integer
counts; only the order of the float sums differs, so rtol 1e-12.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from vireo_tpu.ops.counts import counts_from_scipy as jax_counts_from_scipy
from vireo_tpu.ops.counts import dense_counts as jax_dense_counts
from vireo_tpu_torch.ops.counts import (DenseCounts, counts_from_scipy,
                                        exact_count_dtype)

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's entry points run on the card unless asked for the CPU
    (utils/device.py); these tests ask for it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIREO_PLATFORM", "cpu")
        yield

RTOL = 1e-12


def _pool(seed=7, V=97, C=131, vmax=None):
    rng = np.random.RandomState(seed)
    DP = (rng.rand(V, C) < 0.2) * (1 + rng.poisson(1.5, (V, C)))
    if vmax is not None:
        DP[0, 0] = vmax
    AD = rng.binomial(DP, 0.4)
    return sp.csc_matrix(AD.astype(float)), sp.csc_matrix(DP.astype(float))


@pytest.fixture
def pool():
    AD, DP = _pool()
    jc = jax_dense_counts(AD, DP, dtype=jnp.float64)
    tc = counts_from_scipy(AD, DP)
    return AD, DP, jc, tc


def test_contractions_match_jax(pool):
    AD, DP, jc, tc = pool
    rng = np.random.RandomState(1)
    W = rng.rand(AD.shape[1], 5)
    Wa, Wd = rng.randn(AD.shape[0], 5), rng.randn(AD.shape[0], 5)
    for j, t in zip(jc.suff_stats(jnp.asarray(W)),
                    tc.suff_stats(torch.as_tensor(W))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL)
    np.testing.assert_allclose(
        tc.cell_loglik(torch.as_tensor(Wa), torch.as_tensor(Wd)).numpy(),
        np.asarray(jc.cell_loglik(jnp.asarray(Wa), jnp.asarray(Wd))),
        rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("vmax,dtype", [(None, torch.int8),
                                        (200, torch.bfloat16),
                                        (2000, torch.float32)])
def test_plain_contractions_are_counted(vmax, dtype):
    """MATMULS counts each call of DenseCounts' plain contractions of
    non-int8 counts, and none of int8 counts (K0's); LAUNCHES counts K0's
    kernels alone, which launch nothing on the CPU."""
    from vireo_tpu_torch.ops.counts import LAUNCHES, MATMULS
    AD, DP = _pool(vmax=vmax)
    tc = counts_from_scipy(AD, DP)
    assert isinstance(tc, DenseCounts) and tc.ad.dtype == dtype
    matmuls, launches = dict(MATMULS), dict(LAUNCHES)
    rng = np.random.RandomState(2)
    W = torch.as_tensor(rng.rand(AD.shape[1], 3))
    Wa, Wd = (torch.as_tensor(rng.randn(AD.shape[0], 3)) for _ in range(2))
    tc.suff_stats(W)
    tc.suff_stats(W)
    tc.cell_loglik(Wa, Wd)
    plain = dtype != torch.int8
    assert {k: MATMULS[k] - matmuls[k] for k in MATMULS} == \
        {"suff_stats": 2 * plain, "cell_loglik": 1 * plain}
    assert LAUNCHES == launches
    assert set(LAUNCHES) == {"dense_suff_stats", "dense_cell_loglik"}


def test_reductions_match_jax(pool):
    AD, DP, jc, tc = pool
    np.testing.assert_allclose(float(tc.binom_coeff_sum()),
                               float(jc.binom_coeff_sum()), rtol=RTOL)
    for j, t in zip(jc.row_sums(), tc.row_sums()):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(tc.n_vars_per_cell().numpy(),
                                  np.asarray(jc.n_vars_per_cell()))


def test_int8_placement_equals_jax_dense_rung():
    AD, DP = _pool(seed=2)
    jc = jax_counts_from_scipy(AD, DP, max_dense_elems=10)
    tc = counts_from_scipy(AD, DP)
    assert tc.ad.dtype == torch.int8 and jc.ad.dtype == jnp.int8
    np.testing.assert_array_equal(tc.ad.numpy(), np.asarray(jc.ad))
    np.testing.assert_array_equal(tc.dp.numpy(), np.asarray(jc.dp))


def test_union_pattern_and_exact_dtype():
    # AD with explicit zeros where DP is covered: the union pattern
    AD, DP = _pool(seed=4, vmax=200)
    AD = AD.tolil()
    AD[1, 1] = 0
    AD = AD.tocsr()
    tc = counts_from_scipy(AD, DP)
    assert tc.ad.dtype == exact_count_dtype(200) == torch.bfloat16
    np.testing.assert_array_equal(tc.dp.float().numpy(), DP.toarray())
    np.testing.assert_array_equal(tc.ad.float().numpy(), AD.toarray())


@pytest.mark.parametrize("row_chunk", [1, 7, 32, 1000])
def test_chunked_conversion_is_chunk_independent(pool, row_chunk):
    _, _, _, tc = pool
    ref = DenseCounts(tc.ad, tc.dp, row_chunk=10 ** 6)
    chunked = DenseCounts(tc.ad, tc.dp, row_chunk=row_chunk)
    rng = np.random.RandomState(row_chunk)
    W = torch.as_tensor(rng.rand(tc.n_cell, 3))
    Wa = torch.as_tensor(rng.randn(tc.n_var, 3))
    Wd = torch.as_tensor(rng.randn(tc.n_var, 3))
    for a, b in zip(ref.suff_stats(W), chunked.suff_stats(W)):
        torch.testing.assert_close(b, a, rtol=RTOL, atol=0)
    torch.testing.assert_close(chunked.cell_loglik(Wa, Wd),
                               ref.cell_loglik(Wa, Wd), rtol=RTOL,
                               atol=1e-12)
    torch.testing.assert_close(chunked.binom_coeff_sum(),
                               ref.binom_coeff_sum(), rtol=RTOL, atol=0)


def _heavy_pool(seed=3, V=61, C=77):
    """A pool with ~5% of its covered sites deep (above both caps)."""
    AD, DP = _pool(seed=seed, V=V, C=C)
    rng = np.random.RandomState(seed)
    DP = DP.toarray()
    extra = ((DP > 0) & (rng.rand(V, C) < 0.05)) * rng.randint(150, 300,
                                                                (V, C))
    AD = AD.toarray() + rng.binomial(extra, 0.5)
    return sp.csc_matrix(AD.astype(float)), sp.csc_matrix(DP + extra)


@pytest.mark.parametrize("budget,cls,heavy", [
    (None, "DenseCounts", False),
    (1, "PackedCounts", False),
    (2, "HybridCounts", True),
    (1, "HybridCounts", True),
    (0, "SparseCounts", True),
])
def test_var_subset_and_densify_on_every_rung(budget, cls, heavy):
    """var_subset then densify gives the selected rows' exact counts on
    every rung, and the subset's contractions and binomial sum equal
    JAX's over its dense float64 subset (the hybrid rungs recompute
    their correction from the kept residual)."""
    AD, DP = _heavy_pool() if heavy else _pool(seed=3, V=61, C=77)
    nbytes = None if budget is None else max(budget * AD.shape[0]
                                             * AD.shape[1], 1)
    tc = counts_from_scipy(AD, DP, dense_budget=nbytes)
    assert type(tc).__name__ == cls
    rng = np.random.RandomState(5)
    sel = np.sort(rng.choice(AD.shape[0], 23, replace=False))
    mask = np.zeros(AD.shape[0], bool)
    mask[sel] = True
    jsub = jax_dense_counts(AD[sel], DP[sel], dtype=jnp.float64)
    W = rng.rand(AD.shape[1], 4)
    for idx in (sel, mask, torch.as_tensor(sel)):
        sub = tc.var_subset(idx)
        assert (sub.n_var, sub.n_cell) == (23, AD.shape[1])
        dense = sub.densify()
        assert type(dense).__name__ == "DenseCounts"
        np.testing.assert_array_equal(dense.ad.double().numpy(),
                                      AD[sel].toarray())
        np.testing.assert_array_equal(dense.dp.double().numpy(),
                                      DP[sel].toarray())
        np.testing.assert_allclose(float(sub.binom_coeff_sum()),
                                   float(jsub.binom_coeff_sum()), rtol=RTOL)
        for j, t in zip(jsub.suff_stats(jnp.asarray(W)),
                        sub.suff_stats(torch.as_tensor(W))):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL)
    # the whole pool densified
    full = tc.densify()
    np.testing.assert_array_equal(full.dp.double().numpy(), DP.toarray())


def test_hybrid_densify_keeps_the_exact_smallest_type():
    """JAX's HybridCounts.densify returns float32; the port's returns the
    smallest exact type of the true counts (int8 when they fit), with
    the same values, so the same sums."""
    AD, DP = _pool(seed=6, V=40, C=50)
    DP = DP.toarray()
    DP[0, :3] = [40, 90, 127]          # above the nibble cap, int8-exact
    AD = AD.toarray()
    AD[0, :3] = [20, 45, 100]
    AD, DP = sp.csc_matrix(AD), sp.csc_matrix(DP)
    tc = counts_from_scipy(AD, DP, dense_budget=AD.shape[0] * AD.shape[1])
    assert type(tc).__name__ == "HybridCounts" and tc.cap == 15
    dense = tc.densify()
    assert dense.ad.dtype == torch.int8
    as_f32 = DenseCounts(dense.ad.float(), dense.dp.float())
    W = torch.rand(AD.shape[1], 3, dtype=torch.float64)
    for a, b in zip(dense.suff_stats(W), as_f32.suff_stats(W)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(dense.binom_coeff_sum(),
                               tc.binom_coeff_sum(), rtol=RTOL, atol=0)
    # the base is not written through
    np.testing.assert_array_equal(tc.base.densify().dp.numpy()[0, :3],
                                  [15, 15, 15])
    AD, DP = _heavy_pool()
    heavy = counts_from_scipy(AD, DP, dense_budget=AD.shape[0] * AD.shape[1])
    assert type(heavy).__name__ == "HybridCounts"
    assert heavy.densify().dp.dtype == exact_count_dtype(DP.max()) \
        == torch.float32


def test_sparse_densify_promotes_a_narrow_dtype(capsys):
    AD, DP = _heavy_pool()
    coo = counts_from_scipy(AD, DP, dense_budget=1)
    dense = coo.densify(dtype=torch.int8)
    assert "exceed the exact range of int8" in capsys.readouterr().out
    assert dense.dp.dtype == exact_count_dtype(DP.max())
    np.testing.assert_array_equal(dense.dp.double().numpy(), DP.toarray())
    assert coo.densify(dtype=torch.float64).dp.dtype == torch.float64


# ---- placement: the dense rung from each matrix's own arrays

def _csc_by_hand(X, per_col):
    """A CSC matrix of X's entries in the order (and with the splits)
    `per_col(rows, vals)` gives each column, built from its arrays, so
    scipy neither sorts nor sums them."""
    X = sp.csc_matrix(X)
    indptr, indices, data = [0], [], []
    for j in range(X.shape[1]):
        lo, hi = X.indptr[j], X.indptr[j + 1]
        r, v = per_col(X.indices[lo:hi], X.data[lo:hi])
        indices.extend(r)
        data.extend(v)
        indptr.append(len(indices))
    M = sp.csc_matrix((np.asarray(data, X.dtype), np.asarray(indices),
                       np.asarray(indptr)), shape=X.shape)
    assert not M.has_canonical_format or len(data) == X.nnz
    return M


def _placement_case(case):
    """An AD-DP pair in the form `case` names (see the test)."""
    AD, DP = _pool(seed=8, V=37, C=53)
    if case == "csc":
        return AD, DP
    if case == "csr":
        return AD.tocsr(), DP.tocsr()
    if case == "coo":
        return AD.tocoo(), DP.tocoo()
    if case == "numpy":
        return AD.toarray(), DP.toarray()
    if case == "mixed":
        return AD.tocsr(), DP.toarray()
    if case == "duplicates":
        # every entry split in two entries at the same place
        def split(rows, vals):
            half = np.floor(vals / 2)
            return np.repeat(rows, 2), np.stack([half, vals - half], 1).ravel()
        return _csc_by_hand(AD, split), _csc_by_hand(DP, split)
    if case == "unsorted":
        flip = (lambda rows, vals: (rows[::-1], vals[::-1]))
        # AD a CSC, DP a CSR (the transpose of one), both unsorted
        return _csc_by_hand(AD, flip), _csc_by_hand(DP.T, flip).T
    if case == "explicit_zeros":
        AD = AD.copy()
        AD.data[::3] = 0.0             # stored, not eliminated
        return AD, DP
    if case == "ad_not_in_dp":
        extra = sp.random(37, 53, density=0.05, random_state=3,
                          data_rvs=lambda n: np.arange(1, n + 1) % 4 + 1.0)
        return (AD + extra.tocsc()).tocsc(), DP
    if case == "empty_rows_and_cols":
        keep = np.ones((37, 53))
        keep[[0, 17, 36], :] = 0
        keep[:, [0, 20, 52]] = 0
        return (sp.csc_matrix(AD.multiply(keep)),
                sp.csc_matrix(DP.multiply(keep)))
    if case == "int16":
        AD, DP = AD.toarray().astype(np.int16), DP.toarray().astype(np.int16)
        DP[5, 7], AD[5, 7] = 200, 120
        return sp.csc_matrix(AD), sp.csc_matrix(DP)
    raise ValueError(case)


def _host_arrays(X):
    """Copies of the arrays that hold X's values and pattern."""
    if sp.issparse(X):
        return [np.array(a) for a in (getattr(X, k, None) for k in
                                      ("data", "indices", "indptr", "row",
                                       "col")) if a is not None]
    return [np.array(X)]


def _count_unions(monkeypatch):
    """The aligned triplets of every `_host_union_triplets` call."""
    from vireo_tpu_torch.ops import counts as tcounts
    called = []
    real = tcounts._host_union_triplets

    def counted(*args):
        called.append(real(*args))
        return called[-1]
    monkeypatch.setattr(tcounts, "_host_union_triplets", counted)
    return called


def _dense(X):
    return X.toarray() if sp.issparse(X) else np.asarray(X)


@pytest.mark.parametrize("case", [
    "csc", "csr", "coo", "numpy", "mixed", "duplicates", "unsorted",
    "explicit_zeros", "ad_not_in_dp", "empty_rows_and_cols", "int16"])
def test_dense_rung_placed_directly_equals_the_union_path(monkeypatch, case):
    """The dense rung, placed from each matrix's own compressed arrays,
    holds the host's dense arrays bit for bit in the smallest exact type
    (`exact_count_dtype`); no union is computed, and the caller's
    matrices are left as they were."""
    AD, DP = _placement_case(case)
    before = [_host_arrays(X) for X in (AD, DP)]
    unions = _count_unions(monkeypatch)
    got = counts_from_scipy(AD, DP)
    assert unions == []
    assert type(got) is DenseCounts
    dense = [_dense(X) for X in (AD, DP)]
    dtype = exact_count_dtype(max(x.max() for x in dense))
    assert dtype == (torch.bfloat16 if case == "int16" else torch.int8)
    for g, want in zip((got.ad, got.dp), dense):
        assert g.dtype == dtype
        np.testing.assert_array_equal(g.double().numpy(), want)
    for X, arrays in zip((AD, DP), before):
        for a, b in zip(_host_arrays(X), arrays):
            np.testing.assert_array_equal(a, b)


def _same_as_jax(got, want):
    """A port counts object against the JAX package's of the same rung,
    field by field and exactly: the JAX arrays cut to the port's extent
    (its COO triplets to `nnz`, its packed bytes to the pool's rows and
    bytes; the rest is padding)."""
    from vireo_tpu_torch.ops.counts import (HybridCounts, PackedCounts,
                                            SparseCounts)
    assert type(got).__name__ == type(want).__name__
    if isinstance(got, HybridCounts):
        assert got.cap == want.cap
        assert got.binom_corr.dtype == torch.float64
        assert float(got.binom_corr) == float(want.binom_corr)
        _same_as_jax(got.base, want.base)
        _same_as_jax(got.resid, want.resid)
    elif isinstance(got, SparseCounts):
        assert got.shape == want.shape and got.nnz == want.nnz
        for f in ("rows_r", "cols_r", "ad_r", "dp_r",
                  "rows_c", "cols_c", "ad_c", "dp_c"):
            np.testing.assert_array_equal(
                getattr(got, f).numpy(),
                np.asarray(getattr(want, f))[:want.nnz], err_msg=f)
    elif isinstance(got, PackedCounts):
        assert got.shape == want.shape
        V, Cb = got.ad_p.shape
        for f in ("ad_p", "dp_p"):
            np.testing.assert_array_equal(
                getattr(got, f).numpy(),
                np.asarray(getattr(want, f))[:V, :Cb].view(np.uint8))
    else:
        for f in ("ad", "dp"):
            g, w = getattr(got, f), np.asarray(getattr(want, f))
            assert g.dtype == torch.int8 and w.dtype == np.int8
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("case", ["csc", "duplicates"])
@pytest.mark.parametrize("rung,budget,heavy", [
    ("packed", 1, False), ("int8-hybrid", 2, True),
    ("packed-hybrid", 1, True), ("coo", 0, True)])
def test_other_rungs_keep_the_union(monkeypatch, rung, budget, heavy, case):
    """Every rung places each matrix on its own; AD and DP are aligned
    to the union of their patterns only where one layout holds both: no
    union on the packed rung, one of only the entries above the cap on a
    hybrid (its residual), one of the whole pool on COO. The object
    equals the JAX package's of the same rung, field by field, and
    densifies to the host's dense arrays."""
    from vireo_tpu_torch.ops import counts as tcounts
    if heavy:
        AD, DP = _heavy_pool()
        if case == "duplicates":
            AD, DP = (_csc_by_hand(X, lambda r, v: (
                np.repeat(r, 2), np.stack([v - 1, np.ones_like(v)],
                                          1).ravel())) for X in (AD, DP))
    else:
        AD, DP = _placement_case(case)
        AD, DP = (sp.csc_matrix(np.minimum(X.toarray(), 15)) if case == "csc"
                  else X for X in (AD, DP))
        if case == "duplicates":
            assert max(X.toarray().max() for X in (AD, DP)) <= 15
    nbytes = max(budget * AD.shape[0] * AD.shape[1], 1)
    shape = (AD.shape[0], AD.shape[1])
    dense = [X.toarray() for X in (AD, DP)]
    unions = _count_unions(monkeypatch)
    got = counts_from_scipy(AD, DP, dense_budget=nbytes)
    assert tcounts.ladder_rung(shape, max(x.max() for x in dense),
                               nbytes) == rung
    cap = {"int8-hybrid": 127, "packed-hybrid": 15}.get(rung)
    over = (dense[0] > cap) | (dense[1] > cap) if cap else None
    if rung == "packed":
        assert unions == []
    elif cap:
        (rows, cols, a, d), = unions
        assert len(rows) == over.sum() > 0
        assert over[rows, cols].all()
        np.testing.assert_array_equal(a, dense[0][rows, cols])
        np.testing.assert_array_equal(d, dense[1][rows, cols])
    else:
        (rows, cols, a, d), = unions
        assert len(rows) == ((dense[0] != 0) | (dense[1] != 0)).sum()
    _same_as_jax(got, jax_counts_from_scipy(
        AD, DP, dtype=jnp.float64, max_dense_elems=0, dense_budget=nbytes))
    flat = got.densify()
    for g, want in zip((flat.ad, flat.dp), dense):
        np.testing.assert_array_equal(g.double().numpy(), want)
