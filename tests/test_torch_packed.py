"""vireo_tpu_torch.ops.packed (K2/K3 plain versions, reductions) and the
port's SparseCounts and HybridCounts against vireo_tpu's, on the CPU.

Tolerances:
- byte layout, row sums, per-cell variant counts and densify: exact;
- K2/K3 plain versions against JAX's PackedCounts in Pallas interpret
  mode: both sides contract in float32 (JAX casts the weights to f32,
  packed.py:151), differing in sum order only, so rtol 1e-5 with an
  absolute floor of 1e-5 of the largest output;
- everything in float64 (the plain versions given float64 weights, the
  COO and hybrid contractions, binomial sums and corrections) against
  JAX's float64 counterparts: rtol 1e-12 (sum order only).

The CUDA kernels run only on a card; chip_smoke.py holds them against
the plain versions there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from vireo_tpu.ops import counts as jcounts
from vireo_tpu.ops import packed as jpacked
from vireo_tpu_torch.ops import _build, packed
from vireo_tpu_torch.ops.counts import (DenseCounts, HybridCounts,
                                        PackedCounts, SparseCounts,
                                        counts_from_scipy, hybrid_from_coo,
                                        sparse_counts)

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's entry points run on the card unless asked for the CPU
    (utils/device.py); these tests ask for it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIREO_PLATFORM", "cpu")
        yield

RTOL64 = 1e-12
RTOL32 = 1e-5


def _nibble_pool(V, C, seed):
    rng = np.random.RandomState(seed)
    DP = rng.binomial(1, 0.3, size=(V, C)) * rng.randint(1, 16, (V, C))
    AD = rng.binomial(DP, 0.4)
    return AD.astype(np.float64), DP.astype(np.float64)


def _heavy_pool(V=101, C=131, seed=5):
    """Small UMI-scale depths with ~7% of nonzeros in the hundreds (above
    both the int8 cap 127 and the nibble cap 15), as
    tests/test_hybrid.py's heavy_data."""
    rng = np.random.RandomState(seed)
    DP = (rng.rand(V, C) < 0.3) * rng.poisson(3, size=(V, C))
    hot = (DP > 0) & (rng.rand(V, C) < 0.07)
    DP = DP + hot * rng.randint(150, 700, size=(V, C))
    AD = rng.binomial(DP.astype(int), 0.4)
    return AD.astype(np.float64), DP.astype(np.float64)


def _weights(V, C, N, seed, dtype=np.float64):
    rng = np.random.RandomState(seed)
    W = rng.rand(C, N)
    Wa = rng.uniform(-1.0, 4.0, (V, N))
    Wd = -rng.uniform(0.01, 4.0, (V, N))
    return W.astype(dtype), Wa.astype(dtype), Wd.astype(dtype)


@pytest.fixture(scope="module", params=[(37, 53), (100, 131)],
                ids=["37x53", "100x131"])
def nibble(request):
    V, C = request.param
    AD, DP = _nibble_pool(V, C, seed=V + C)
    return AD, DP, jpacked.pack_dense(AD, DP), packed.pack_dense(AD, DP)


def test_bytes_match_jax_layout(nibble):
    AD, DP, jp, tp = nibble
    V, C = AD.shape
    Cb = (C + 1) // 2
    assert tp.ad_p.dtype == torch.uint8 and tp.ad_p.shape == (V, Cb)
    for j, t in ((jp.ad_p, tp.ad_p), (jp.dp_p, tp.dp_p)):
        jb = np.asarray(j).view(np.uint8)
        np.testing.assert_array_equal(t.numpy(), jb[:V, :Cb])
        # JAX's padding to its block grid holds zero bytes only
        assert not jb[V:].any() and not jb[:, Cb:].any()
    # the ladder's device scatter gives the same bytes
    placed = counts_from_scipy(sp.csr_matrix(AD), sp.csr_matrix(DP),
                               dense_budget=AD.size)
    assert isinstance(placed, PackedCounts)
    assert torch.equal(placed.ad_p, tp.ad_p)
    assert torch.equal(placed.dp_p, tp.dp_p)


@pytest.mark.parametrize("N", [1, 5, 21])
def test_plain_versions_match_jax_interpret_f32(nibble, N):
    AD, DP, jp, tp = nibble
    V, C = AD.shape
    W, Wa, Wd = _weights(V, C, N, seed=N, dtype=np.float32)
    jS = jp.suff_stats(jnp.asarray(W))
    tS = tp.suff_stats(torch.as_tensor(W))
    jl = jp.cell_loglik(jnp.asarray(Wa), jnp.asarray(Wd))
    tl = tp.cell_loglik(torch.as_tensor(Wa), torch.as_tensor(Wd))
    for j, t in list(zip(jS, tS)) + [(jl, tl)]:
        j = np.asarray(j)
        assert t.dtype == torch.float32 and t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), j, rtol=RTOL32,
                                   atol=RTOL32 * np.abs(j).max())


@pytest.mark.parametrize("N", [1, 5, 21])
def test_plain_versions_match_jax_dense_f64(nibble, N):
    AD, DP, _, tp = nibble
    V, C = AD.shape
    jd = jcounts.dense_counts(AD, DP, dtype=jnp.float64)
    W, Wa, Wd = _weights(V, C, N, seed=10 + N)
    for j, t in zip(jd.suff_stats(jnp.asarray(W)),
                    tp.suff_stats(torch.as_tensor(W))):
        assert t.dtype == torch.float64
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL64)
    np.testing.assert_allclose(
        tp.cell_loglik(torch.as_tensor(Wa), torch.as_tensor(Wd)).numpy(),
        np.asarray(jd.cell_loglik(jnp.asarray(Wa), jnp.asarray(Wd))),
        rtol=RTOL64, atol=1e-12)


def test_reductions_and_densify_exact(nibble):
    AD, DP, jp, tp = nibble
    np.testing.assert_allclose(float(tp.binom_coeff_sum()),
                               float(jp.binom_coeff_sum()), rtol=RTOL64)
    assert tp.binom_coeff_sum().dtype == torch.float64
    for j, t, ref in zip(jp.row_sums(), tp.row_sums(), (AD, DP)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        np.testing.assert_array_equal(t.numpy(), ref.sum(axis=1))
    np.testing.assert_array_equal(tp.n_vars_per_cell().numpy(),
                                  np.asarray(jp.n_vars_per_cell()))
    d = tp.densify()
    assert isinstance(d, DenseCounts) and d.ad.dtype == torch.int8
    np.testing.assert_array_equal(d.ad.numpy(), np.asarray(jp.densify().ad))
    np.testing.assert_array_equal(d.dp.numpy(), DP)


def test_row_blocks_do_not_change_results(nibble, monkeypatch):
    AD, DP, _, tp = nibble
    W, Wa, Wd = _weights(*AD.shape, 3, seed=3)
    W, Wa, Wd = (torch.as_tensor(x) for x in (W, Wa, Wd))
    whole = (tp.suff_stats(W), tp.cell_loglik(Wa, Wd), tp.row_sums(),
             tp.n_vars_per_cell(), tp.binom_coeff_sum())
    # a few rows a block
    monkeypatch.setattr(packed, "_CHUNK_BYTES", 7 * AD.shape[1])
    blocked = (tp.suff_stats(W), tp.cell_loglik(Wa, Wd), tp.row_sums(),
               tp.n_vars_per_cell(), tp.binom_coeff_sum())
    for a, b in zip(whole[0], blocked[0]):
        torch.testing.assert_close(b, a, rtol=RTOL64, atol=0)
    torch.testing.assert_close(blocked[1], whole[1], rtol=RTOL64, atol=1e-12)
    for a, b in zip(whole[2], blocked[2]):
        assert torch.equal(a, b)
    assert torch.equal(whole[3], blocked[3])
    torch.testing.assert_close(blocked[4], whole[4], rtol=RTOL64, atol=0)


@pytest.mark.parametrize("block", [1, 7, 64])
def test_pack_scatter_is_block_and_order_independent(nibble, block,
                                                     monkeypatch):
    """The even and odd cells of one byte may land in different scatter
    blocks, in either order: the per-matrix writer's OR of disjoint
    nibbles gives the same bytes from a CSR whose entries lie in any
    order within their rows, and from a CSC."""
    AD, DP, _, tp = nibble
    from vireo_tpu_torch.ops import counts as tcounts
    monkeypatch.setattr(tcounts, "_SCATTER_BLOCK", block)
    rng = np.random.RandomState(block)
    for X, want in ((AD, tp.ad_p), (DP, tp.dp_p)):
        M = sp.csr_matrix(X)
        rows = np.repeat(np.arange(M.shape[0]), np.diff(M.indptr))
        order = np.lexsort((rng.rand(M.nnz), rows))
        shuffled = sp.csr_matrix((M.data[order], M.indices[order],
                                  M.indptr), shape=M.shape)
        for Y in (shuffled, sp.csc_matrix(X)):
            assert torch.equal(tcounts._place_packed(Y, X.shape, "cpu"),
                               want)


def test_pack_dense_rejects_counts_above_a_nibble():
    AD, DP = _nibble_pool(5, 6, seed=1)
    DP[0, 0] = 16
    with pytest.raises(ValueError, match="outside"):
        packed.pack_dense(AD, DP)


@pytest.fixture(scope="module")
def heavy():
    AD, DP = _heavy_pool()
    jcoo = jcounts.sparse_counts(AD, DP, dtype=jnp.float64, pad_multiple=64)
    return AD, DP, jcoo, sparse_counts(AD, DP)


def _check_contractions(j, t, V, C, rtol=RTOL64, atol_rel=0.0):
    W, Wa, Wd = _weights(V, C, 4, seed=V)
    for js, ts in zip(j.suff_stats(jnp.asarray(W)),
                      t.suff_stats(torch.as_tensor(W))):
        js = np.asarray(js)
        np.testing.assert_allclose(ts.numpy(), js, rtol=rtol,
                                   atol=atol_rel * np.abs(js).max())
    jl = np.asarray(j.cell_loglik(jnp.asarray(Wa), jnp.asarray(Wd)))
    np.testing.assert_allclose(
        t.cell_loglik(torch.as_tensor(Wa), torch.as_tensor(Wd)).numpy(),
        jl, rtol=rtol, atol=max(1e-10, atol_rel * np.abs(jl).max()))


def _check_reductions(j, t):
    np.testing.assert_allclose(float(t.binom_coeff_sum()),
                               float(j.binom_coeff_sum()), rtol=RTOL64)
    for js, ts in zip(j.row_sums(), t.row_sums()):
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(t.n_vars_per_cell().numpy(),
                                  np.asarray(j.n_vars_per_cell()))


def test_sparse_counts_match_jax(heavy):
    AD, DP, jcoo, tcoo = heavy
    assert isinstance(tcoo, SparseCounts) and tcoo.nnz == jcoo.nnz
    assert tcoo.max_count() == jcoo.max_count() == DP.max()
    # one sort order per contraction, as JAX keeps them
    n = jcoo.nnz
    for f in ("rows_r", "cols_r", "rows_c", "cols_c"):
        np.testing.assert_array_equal(getattr(tcoo, f).numpy(),
                                      np.asarray(getattr(jcoo, f))[:n])
    _check_contractions(jcoo, tcoo, *AD.shape)
    _check_reductions(jcoo, tcoo)


@pytest.mark.parametrize("cap,kind,base", [(127, "int8", DenseCounts),
                                           (15, "packed", PackedCounts)])
def test_hybrid_counts_match_jax(heavy, cap, kind, base):
    AD, DP, jcoo, tcoo = heavy
    jh = jcounts.hybrid_from_coo(jcoo, cap, kind, pad_multiple=32)
    th = hybrid_from_coo(tcoo, cap, kind)
    assert isinstance(th, HybridCounts) and isinstance(th.base, base)
    assert th.cap == jh.cap == cap and th.resid_nnz == jh.resid_nnz > 0
    assert th.binom_corr.dtype == torch.float64
    np.testing.assert_allclose(float(th.binom_corr), float(jh.binom_corr),
                               rtol=RTOL64)
    _check_reductions(jh, th)
    # float64 against the JAX dense pool; against JAX's own hybrid in
    # float64 for the int8 base, in float32 for the packed base (its
    # Pallas kernels cast the weights to f32)
    _check_contractions(jcounts.dense_counts(AD, DP, dtype=jnp.float64), th,
                        *AD.shape)
    if kind == "int8":
        _check_contractions(jh, th, *AD.shape)
    else:
        _check_contractions(jh, th, *AD.shape, rtol=RTOL32,
                            atol_rel=RTOL32)


def test_cpu_wrappers_leave_launch_counts_untouched(nibble):
    AD, DP, _, tp = nibble
    W, Wa, Wd = (torch.as_tensor(x) for x in _weights(*AD.shape, 2, seed=0))
    before = dict(packed.LAUNCHES)
    S = tp.suff_stats(W)
    ll = tp.cell_loglik(Wa, Wd)
    assert packed.LAUNCHES == before
    for a, b in zip(S, packed.suff_stats_reference(tp.ad_p, tp.dp_p,
                                                   tp.n_cell, W)):
        assert torch.equal(a, b)
    assert torch.equal(ll, packed.cell_loglik_reference(
        tp.ad_p, tp.dp_p, tp.n_cell, Wa, Wd))


def test_wrappers_raise_off_cpu_and_cuda(nibble):
    _, _, _, tp = nibble
    meta = PackedCounts(tp.ad_p.to("meta"), tp.dp_p.to("meta"), tp.shape)
    W = torch.zeros((tp.n_cell, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        meta.suff_stats(W)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        meta.cell_loglik(W[:tp.n_var], W[:tp.n_var])


def test_launch_checks_refuse_what_the_kernels_do_not_take(nibble):
    _, _, _, tp = nibble
    w32 = torch.zeros((tp.n_cell, 3), dtype=torch.float32)
    ok = packed._check_launch("suff_stats", tp.ad_p, tp.dp_p, tp.n_cell,
                              [w32], tp.n_cell)
    assert ok[0].is_contiguous() and ok[2][0].dtype == torch.float32
    with pytest.raises(TypeError, match="float32"):
        packed._check_launch("suff_stats", tp.ad_p, tp.dp_p, tp.n_cell,
                             [w32.double()], tp.n_cell)
    with pytest.raises(TypeError, match="uint8"):
        packed._check_launch("suff_stats", tp.ad_p.to(torch.int8),
                             tp.dp_p, tp.n_cell, [w32], tp.n_cell)
    with pytest.raises(ValueError, match="do not hold"):
        packed._check_launch("cell_loglik", tp.ad_p, tp.dp_p,
                             tp.n_cell + 2, [w32], tp.n_cell)
    with pytest.raises(ValueError, match="not \\(%d, N\\)" % tp.n_cell):
        packed._check_launch("suff_stats", tp.ad_p, tp.dp_p, tp.n_cell,
                             [w32[1:]], tp.n_cell)


def test_build_command_targets_the_packed_source():
    src = _build.source_path("packed_counts")
    assert src.is_file() and src.parent == _build.CSRC_DIR
    cmd = _build.nvcc_command(src, "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and cmd[-1] == str(src)
    text = src.read_text()
    for name in ("vireo_packed_suff_stats", "vireo_packed_cell_loglik",
                 "vireo_packed_error_string"):
        assert name in text


def _split_sum(W):
    return sum(t.double() for t in packed.split_bf16x3(W))


@pytest.mark.parametrize("kind", ["probabilities", "digamma_fold",
                                  "negative", "tiny", "wide", "zeros"])
def test_bf16x3_split_is_exact(kind):
    """K2 multiplies nibbles by three bf16 terms of each float32 weight;
    their sum, taken in float64, is the weight exactly."""
    rng = np.random.RandomState(7)
    n = 20000
    x = {"probabilities": rng.rand(n),
         "digamma_fold": rng.uniform(-4.01, 4.5, n),
         "negative": -rng.gamma(0.5, 3.0, n),
         "tiny": np.sign(rng.randn(n)) * 10.0 ** rng.uniform(-33, -20, n),
         "wide": np.sign(rng.randn(n)) * 10.0 ** rng.uniform(-30, 30, n),
         "zeros": np.zeros(n)}[kind]
    W = torch.as_tensor(x, dtype=torch.float32)
    hi, mid, lo = packed.split_bf16x3(W)
    assert all(t.dtype == torch.bfloat16 for t in (hi, mid, lo))
    assert torch.equal(_split_sum(W), W.double())
    assert torch.equal(hi, W.to(torch.bfloat16))


def test_bf16x3_split_below_its_exact_range():
    """From 2^-110 up the split is exact; below, the last term falls
    under bf16's subnormal step 2^-133 and the sum stays within 2^-134."""
    edge = torch.tensor([2.0 ** -110, -(2.0 ** -110) * 1.2345678,
                         2.0 ** -100 * 1.9999999], dtype=torch.float32)
    assert torch.equal(_split_sum(edge), edge.double())
    W = torch.as_tensor(10.0 ** np.random.RandomState(8).uniform(-44, -34,
                                                               5000),
                        dtype=torch.float32)
    assert float((_split_sum(W) - W.double()).abs().max()) <= 2.0 ** -134


def test_split_weights_are_kmajor_and_zero_padded():
    """K2's B operand: (3, N, ldw) bf16, the transposed terms, each row
    padded with zeros to a whole 16 bytes (TMA's stride unit) and no
    further: the kernel's tensor map supplies the ragged tiles."""
    W = torch.as_tensor(np.random.RandomState(9).rand(37, 5),
                        dtype=torch.float32)
    w3 = packed.split_weights_kmajor(W)
    assert w3.shape == (3, 5, 40) and w3.dtype == torch.bfloat16
    assert torch.equal(w3.double().sum(0)[:, :37], W.double().t())
    assert not w3[:, :, 37:].any()
    assert packed.split_weights_kmajor(W[:32]).shape == (3, 5, 32)


def test_smoke_split_weights_need_all_three_terms():
    """chip_smoke's exact check of K2's three bf16 terms: its weights need
    mid (all of them) and lo (some), the float32 plain version sums them
    exactly, as float64 does, and the weights cut to one or two terms
    give other sums, so a kernel that lost a term would fail it."""
    import chip_smoke
    V, C, N = 50, 301, 21
    g = torch.Generator().manual_seed(3)
    W = chip_smoke._split_weights(torch, C, N, g, torch.device("cpu"))
    hi, mid, lo = packed.split_bf16x3(W)
    nz = W != 0
    assert 0 < int(nz.sum(0).max()) <= chip_smoke.SPLIT_NNZ
    assert bool((mid[nz] != 0).all()) and bool((lo[nz] != 0).any())
    rng = np.random.RandomState(4)
    tp = packed.pack_dense(rng.randint(0, 16, (V, C)),
                           rng.randint(0, 16, (V, C)))
    exact = packed.suff_stats_reference(tp.ad_p, tp.dp_p, C, W.double())
    f32 = packed.suff_stats_reference(tp.ad_p, tp.dp_p, C, W)
    for a, b in zip(f32, exact):
        assert float(b.abs().max()) < 2 ** 24
        assert torch.equal(a.double(), b)
    for cut in chip_smoke._fewer_terms(torch, W).values():
        got = packed.suff_stats_reference(tp.ad_p, tp.dp_p, C, cut)
        assert not all(torch.equal(a, b) for a, b in zip(got, f32))


@pytest.mark.parametrize("V", [37, 40])
def test_loglik_weights_are_kmajor_and_zero_padded(V):
    """K3's B operand: (6, N, ldv) bf16, the three terms of Wa then of
    Wd, transposed (variants contiguous), each row padded with zeros to a
    whole 16 bytes and no further; the planes of each matrix sum to it
    exactly."""
    rng = np.random.RandomState(V)
    N = 5
    Wa = torch.as_tensor(rng.uniform(-1.0, 4.0, (V, N)), dtype=torch.float32)
    Wd = torch.as_tensor(-rng.uniform(0.01, 4.0, (V, N)),
                         dtype=torch.float32)
    b6 = packed.split_weights_kmajor(Wa, Wd)
    ldv = -(-V // 8) * 8
    assert b6.shape == (6, N, ldv) and b6.dtype == torch.bfloat16
    assert b6.is_contiguous()
    for i, W in enumerate((Wa, Wd)):
        terms = packed.split_bf16x3(W)
        for p in range(3):
            assert torch.equal(b6[3 * i + p, :, :V], terms[p].t())
        assert torch.equal(b6[3 * i:3 * i + 3].double().sum(0)[:, :V],
                           W.double().t())
    assert not b6[:, :, V:].any()


@pytest.mark.parametrize("bad", ["float64", "meta", "rows", "width",
                                 "vector"])
def test_loglik_launch_checks_refuse_weights_the_kernel_does_not_take(
        nibble, bad):
    """K3's weights, which the wrapper splits into its B operand: float32,
    on the counts' device, both (n_var, N); anything else raises before
    the split."""
    _, _, _, tp = nibble
    Wa = torch.zeros((tp.n_var, 3), dtype=torch.float32)
    Wd = Wa.clone()
    assert packed._check_launch("cell_loglik", tp.ad_p, tp.dp_p, tp.n_cell,
                                [Wa, Wd], tp.n_var)[2][1] is Wd
    Wd, err = {"float64": (Wd.double(), TypeError),
               "meta": (Wd.to("meta"), ValueError),
               "rows": (Wd[1:], ValueError),
               "width": (Wd[:, :2], ValueError),
               "vector": (Wd[:, 0], ValueError)}[bad]
    with pytest.raises(err):
        packed._check_launch("cell_loglik", tp.ad_p, tp.dp_p, tp.n_cell,
                             [Wa, Wd], tp.n_var)


def test_smoke_loglik_split_weights_need_all_three_terms():
    """chip_smoke's exact check of K3's three bf16 terms: SPLIT_NNZ
    nonzeros a column across Wa and Wd together, which need mid (all)
    and lo (some); the float32 plain version sums them exactly, as
    float64 does, and the weights cut to one or two terms give other
    sums."""
    import chip_smoke
    V, C, N = 60, 301, 21
    g = torch.Generator().manual_seed(5)
    w = chip_smoke._split_weights_of(torch, "cell_loglik", V, C, N, g,
                                     torch.device("cpu"))
    assert [x.shape for x in w] == [(V, N), (V, N)]
    both = torch.cat(w)
    nz = both != 0
    assert 0 < int(nz.sum(0).max()) <= chip_smoke.SPLIT_NNZ
    _, mid, lo = packed.split_bf16x3(both)
    assert bool((mid[nz] != 0).all()) and bool((lo[nz] != 0).any())
    rng = np.random.RandomState(6)
    tp = packed.pack_dense(rng.randint(0, 16, (V, C)),
                           rng.randint(0, 16, (V, C)))
    exact = packed.cell_loglik_reference(tp.ad_p, tp.dp_p, C,
                                         *(x.double() for x in w))
    f32 = packed.cell_loglik_reference(tp.ad_p, tp.dp_p, C, *w)
    assert float(exact.abs().max()) < 2 ** 24
    assert torch.equal(f32.double(), exact)
    for terms in (1, 2):
        cut = chip_smoke._cut_terms(torch, w, terms)
        got = packed.cell_loglik_reference(tp.ad_p, tp.dp_p, C, *cut)
        assert not torch.equal(got, f32)
