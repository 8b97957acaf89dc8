"""K0, the dense rung's int8 contractions (vireo_tpu_torch.ops.counts:
`dense_suff_stats`, `dense_cell_loglik`, csrc/dense_counts.cu), on the
CPU: the wrappers' dispatch and launch checks, and K0's arithmetic
against vireo_tpu.ops.counts.DenseCounts, whose XLA dots read int8
counts cast to bf16 (vireo_tpu/ops/counts.py:71-95).

The CUDA kernels run only on a card; chip_smoke.py's `[k0]` phase holds
them against the plain versions there. Here a CPU emulation of their
arithmetic (each float32 weight split into three bf16 terms, each
64-deep k-block summed in float32, the k-blocks added in float32 in
order) is held against JAX's DenseCounts on int8 counts and float32
weights:
- integer weights: every product and partial sum is an integer below
  2^24, exact in float32 in any order, so bit for bit;
- float weights: both sides sum the same exact products (a count below
  128 times a bf16 term, or JAX's float32 weight) in float32 in other
  orders, so |err| <= (gamma_3n + gamma_n) sum|terms| elementwise,
  gamma_n = n u / (1 - n u), u = 2^-24, n the products of one output on
  JAX's side (n_cell for suff_stats, 2 n_var for cell_loglik), three
  times as many on K0's (Higham's bound, as chip_smoke applies to K2 and
  K3).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vireo_tpu.ops.counts import dense_counts as jax_dense_counts
from vireo_tpu_torch.ops import _build, counts
from vireo_tpu_torch.ops.counts import DenseCounts
from vireo_tpu_torch.ops.packed import split_bf16x3

torch.set_num_threads(1)

F32_UNIT = 2.0 ** -24
K_BLOCK = 64  # k values a stage of K0's kernels (hopper_gemm.cuh kKBlock)


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's entry points run on the card unless asked for the CPU
    (utils/device.py); these tests ask for it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIREO_PLATFORM", "cpu")
        yield


def _int8_pool(V, C, seed):
    """int8 counts over their whole range, 0 to 127, a third of them 0."""
    rng = np.random.RandomState(seed)
    dp = rng.randint(0, 128, (V, C)) * (rng.rand(V, C) < 0.67)
    ad = rng.binomial(dp, 0.4)
    return ad.astype(np.int8), dp.astype(np.int8)


def _weights(V, C, N, seed, integer=False):
    rng = np.random.RandomState(seed)
    if integer:
        draw = [rng.randint(-2, 3, shape) for shape in
                ((C, N), (V, N), (V, N))]
    else:
        draw = [rng.rand(C, N), rng.uniform(-1.0, 4.0, (V, N)),
                -rng.uniform(0.01, 4.0, (V, N))]
    return [x.astype(np.float32) for x in draw]


def _dense(ad, dp):
    return DenseCounts(torch.as_tensor(ad), torch.as_tensor(dp))


def _k0_emulation(A, W):
    """Sum over k of A[:, k] * W[k, :] as K0's suff_stats forms it: W's
    three bf16 terms, each k-block of K_BLOCK cells summed in float32 on
    its own, the k-blocks added in float32 in order."""
    terms = [t.float() for t in split_bf16x3(W)]
    acc = torch.zeros((A.shape[0], W.shape[1]), dtype=torch.float32)
    for k0 in range(0, A.shape[1], K_BLOCK):
        a = A[:, k0:k0 + K_BLOCK].float()
        acc += sum(a @ t[k0:k0 + K_BLOCK] for t in terms)
    return acc


def _emulated_suff_stats(ad, dp, W):
    return _k0_emulation(ad, W), _k0_emulation(dp, W)


def _emulated_cell_loglik(ad, dp, Wa, Wd):
    """AD.T @ Wa + DP.T @ Wd as K0's cell_loglik forms it: a k-block of
    K_BLOCK variants takes both matrices and the three terms of each
    weight, summed in float32 on its own, the k-blocks added in order."""
    ta = [t.float() for t in split_bf16x3(Wa)]
    td = [t.float() for t in split_bf16x3(Wd)]
    acc = torch.zeros((ad.shape[1], Wa.shape[1]), dtype=torch.float32)
    for v0 in range(0, ad.shape[0], K_BLOCK):
        blk = slice(v0, v0 + K_BLOCK)
        a, d = ad[blk].float().t(), dp[blk].float().t()
        acc += (sum(a @ t[blk] for t in ta) + sum(d @ t[blk] for t in td))
    return acc


def _gamma(n):
    return n * F32_UNIT / (1 - n * F32_UNIT)


@pytest.mark.parametrize("V,C", [(37, 53), (130, 301)])
def test_cpu_wrappers_run_the_plain_versions_and_count_nothing(V, C):
    ad, dp = _int8_pool(V, C, seed=V)
    W, Wa, Wd = (torch.as_tensor(x) for x in _weights(V, C, 5, seed=1))
    dc = _dense(ad, dp)
    before = dict(counts.LAUNCHES)
    S = dc.suff_stats(W)
    ll = dc.cell_loglik(Wa, Wd)
    assert counts.LAUNCHES == before
    for a, b in zip(S, counts.suff_stats_reference(dc.ad, dc.dp, W)):
        assert torch.equal(a, b)
    assert torch.equal(ll, counts.cell_loglik_reference(dc.ad, dc.dp, Wa,
                                                        Wd))


def test_plain_blocks_follow_row_chunk():
    """`row_chunk` sizes only the plain version's converted blocks: any
    block size gives the same float64 sums."""
    ad, dp = _int8_pool(41, 67, seed=3)
    W, Wa, Wd = (torch.as_tensor(x, dtype=torch.float64)
                 for x in _weights(41, 67, 4, seed=2, integer=True))
    whole = _dense(ad, dp)
    for rows in (1, 7, 40, 41, 1000):
        cut = DenseCounts(whole.ad, whole.dp, row_chunk=rows)
        for a, b in zip(cut.suff_stats(W), whole.suff_stats(W)):
            assert torch.equal(a, b)
        assert torch.equal(cut.cell_loglik(Wa, Wd),
                           whole.cell_loglik(Wa, Wd))


def test_wrappers_raise_off_cpu_and_cuda():
    ad, dp = _int8_pool(9, 11, seed=4)
    meta = DenseCounts(torch.as_tensor(ad).to("meta"),
                       torch.as_tensor(dp).to("meta"))
    W = torch.zeros((11, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        meta.suff_stats(W)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        meta.cell_loglik(W[:9], W[:9])


@pytest.mark.parametrize("bad", ["float64", "int16 counts", "counts shape",
                                 "rows", "width", "meta weights",
                                 "vector"])
def test_launch_checks_refuse_what_the_kernels_do_not_take(bad):
    ad, dp = (torch.as_tensor(x) for x in _int8_pool(9, 11, seed=5))
    Wa = torch.zeros((9, 3), dtype=torch.float32)
    ok = counts._check_launch("dense_cell_loglik", ad, dp, [Wa, Wa.clone()],
                              9)
    assert ok[2] == 11 and ok[3][0].dtype == torch.float32
    Wd, err = Wa.clone(), ValueError
    if bad == "float64":
        Wd, err = Wd.double(), TypeError
    elif bad == "int16 counts":
        ad, err = ad.to(torch.int16), TypeError
    elif bad == "counts shape":
        dp = dp[1:]
    elif bad == "rows":
        Wd = Wd[1:]
    elif bad == "width":
        Wd = Wd[:, :2]
    elif bad == "meta weights":
        Wd = Wd.to("meta")
    else:
        Wd = Wd[:, 0]
    with pytest.raises(err):
        counts._check_launch("dense_cell_loglik", ad, dp, [Wa, Wd], 9)


def _recorders(monkeypatch):
    calls = []

    def record(name):
        real = getattr(counts, name)

        def fn(*args, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)
        monkeypatch.setattr(counts, name, fn)
    for name in ("dense_suff_stats", "dense_cell_loglik",
                 "suff_stats_reference", "cell_loglik_reference"):
        record(name)
    return calls


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16,
                                   torch.bfloat16, torch.float32])
def test_int8_counts_route_through_k0_and_others_through_the_plain_product(
        dtype, monkeypatch):
    """int8 DenseCounts go through K0's wrappers (which run the plain
    versions on the CPU); counts of any other type straight through the
    plain product, as JAX takes a plain dot for them. The sums are the
    same either way."""
    ad, dp = _int8_pool(23, 31, seed=6)
    W, Wa, Wd = (torch.as_tensor(x, dtype=torch.float64)
                 for x in _weights(23, 31, 3, seed=7))
    dc = DenseCounts(torch.as_tensor(ad).to(dtype),
                     torch.as_tensor(dp).to(dtype))
    calls = _recorders(monkeypatch)
    S1, SS = dc.suff_stats(W)
    ll = dc.cell_loglik(Wa, Wd)
    if dtype == torch.int8:
        assert calls == ["dense_suff_stats", "suff_stats_reference",
                         "dense_cell_loglik", "cell_loglik_reference"]
    else:
        assert calls == ["suff_stats_reference", "cell_loglik_reference"]
    ref = _dense(ad, dp)
    np.testing.assert_allclose(S1.numpy(), ref.suff_stats(W)[0].numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(ll.numpy(), ref.cell_loglik(Wa, Wd).numpy(),
                               rtol=1e-12, atol=1e-12)


def test_build_command_targets_the_dense_source():
    src = _build.source_path("dense_counts")
    assert src.is_file() and src.parent == _build.CSRC_DIR
    cmd = _build.nvcc_command(src, "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and cmd[-1] == str(src)
    assert {p.name for p in _build.compiled_files("dense_counts")} == {
        "hopper_gemm.cuh", "dense_counts.cu"}
    text = src.read_text()
    for name in ("vireo_dense_suff_stats", "vireo_dense_cell_loglik",
                 "vireo_dense_error_string"):
        assert name in text


class _FakeLibrary:
    """Records the arguments of K0's C entry points."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("vireo_dense_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' card path on CPU tensors: on_cpu says no, the
    library is a recorder and the launch calls it on stream 0."""
    lib = _FakeLibrary()
    monkeypatch.setattr(counts, "on_cpu", lambda name, t: False)
    monkeypatch.setattr(counts, "_library", lambda: lib)
    monkeypatch.setattr(counts, "launch",
                        lambda name, fn, args, device, err: fn(*args, 0))
    monkeypatch.setattr(counts, "LAUNCHES", dict.fromkeys(counts.LAUNCHES,
                                                          0))
    return lib


def test_cell_slice_and_odd_cells_reach_the_kernel_with_their_pitch(
        fake_card):
    """A cell range that starts at an odd column and ends at its parent's
    last one, and an odd cell count, reach the kernels in place: the
    view's first byte, the parent's row pitch, the slice's cells; B's
    rows padded to a whole 16 bytes. Counts whose cells are not
    contiguous are copied first."""
    V, C0, start = 13, 40, 7
    ad, dp = (torch.as_tensor(x) for x in _int8_pool(V, C0, seed=8))
    view = DenseCounts(ad, dp).cell_slice(start, C0)
    C = C0 - start
    W = torch.ones((C, 5), dtype=torch.float32)
    Wa = torch.ones((V, 5), dtype=torch.float32)
    view.suff_stats(W)
    view.cell_loglik(Wa, Wa)
    (n1, a1), (n2, a2) = fake_card.calls
    assert n1 == "vireo_dense_suff_stats" and n2 == "vireo_dense_cell_loglik"
    for args in (a1, a2):
        assert args[0] == ad.data_ptr() + start
        assert args[1] == dp.data_ptr() + start
        assert args[-2] == C0                   # the row pitch
    assert a1[5:9] == (V, C, 5, -(-C // 8) * 8)
    assert a2[4:8] == (V, C, 5, -(-V // 8) * 8)
    assert counts.LAUNCHES == {"dense_suff_stats": 1, "dense_cell_loglik": 1}

    fake_card.calls.clear()
    cols = DenseCounts(ad.t().contiguous().t(), dp.t().contiguous().t())
    cols.suff_stats(torch.ones((C0, 2), dtype=torch.float32))
    (_, args), = fake_card.calls
    assert args[0] != ad.data_ptr() and args[-2] == C0


def test_empty_counts_give_zeros_without_a_launch(fake_card):
    ad = torch.zeros((0, 9), dtype=torch.int8)
    S1, SS = DenseCounts(ad, ad).suff_stats(torch.ones((9, 3)))
    ll = DenseCounts(ad, ad).cell_loglik(torch.ones((0, 3)),
                                         torch.ones((0, 3)))
    assert S1.shape == SS.shape == (0, 3) and ll.shape == (9, 3)
    assert not ll.any() and not fake_card.calls


def test_smoke_k0_views_start_at_an_odd_column_of_their_parent():
    import chip_smoke
    dc = chip_smoke._k0_inputs(torch, 11, 21, 3, torch.device("cpu"),
                               start=chip_smoke.K0_VIEW_START)
    assert chip_smoke.K0_VIEW_START % 2 == 1 and dc.n_cell == 21
    assert dc.ad.stride(0) == 21 + chip_smoke.K0_VIEW_START
    assert dc.ad.storage_offset() == chip_smoke.K0_VIEW_START
    assert int(dc.ad.max()) <= 127 and int(dc.ad.min()) >= 0


def test_smoke_k0_split_weights_need_all_three_terms():
    """chip_smoke's three-term check of K0: on counts halved to 0..63 and
    K0_SPLIT_NNZ nonzero a column, the float32 plain version equals the
    float64 sums, and the weights cut to one or two terms give other
    sums; on counts up to 127 the same weights are not exact in float32,
    which is why the check halves them."""
    import chip_smoke
    V, C, N = 40, 301, 33
    g = torch.Generator().manual_seed(9)
    ad, dp = (torch.as_tensor(x) for x in _int8_pool(V, C, seed=9))
    ad[0, :], dp[0, :] = 127, 127
    for name in ("suff_stats", "cell_loglik"):
        w = chip_smoke._split_weights_of(torch, name, V, C, N, g,
                                         torch.device("cpu"),
                                         chip_smoke.K0_SPLIT_NNZ)
        plain = (counts.suff_stats_reference if name == "suff_stats"
                 else lambda a, d, *x: (counts.cell_loglik_reference(
                     a, d, *x),))
        half = (ad >> 1, dp >> 1)
        f32 = plain(*half, *w)
        for a, b in zip(f32, plain(*half, *(x.double() for x in w))):
            assert torch.equal(a.double(), b)
        for terms in (1, 2):
            cut = chip_smoke._cut_terms(torch, w, terms)
            assert not all(torch.equal(a, b)
                           for a, b in zip(plain(*half, *cut), f32))
        full = plain(ad, dp, *w)
        assert not all(torch.equal(a.double(), b) for a, b in zip(
            full, plain(ad, dp, *(x.double() for x in w))))


@pytest.mark.parametrize("V,C,N", [(37, 53, 5), (130, 301, 21)])
def test_k0_arithmetic_equals_jax_on_integer_weights(V, C, N):
    ad, dp = _int8_pool(V, C, seed=V + C)
    W, Wa, Wd = _weights(V, C, N, seed=N, integer=True)
    jc = jax_dense_counts(ad, dp, dtype=jnp.int8)
    tad, tdp = torch.as_tensor(ad), torch.as_tensor(dp)
    for j, t in zip(jc.suff_stats(jnp.asarray(W)),
                    _emulated_suff_stats(tad, tdp, torch.as_tensor(W))):
        assert np.asarray(j).dtype == np.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(
        _emulated_cell_loglik(tad, tdp, torch.as_tensor(Wa),
                              torch.as_tensor(Wd)).numpy(),
        np.asarray(jc.cell_loglik(jnp.asarray(Wa), jnp.asarray(Wd))))


@pytest.mark.parametrize("V,C,N", [(37, 53, 5), (130, 301, 21)])
def test_k0_arithmetic_matches_jax_on_float_weights(V, C, N):
    ad, dp = _int8_pool(V, C, seed=V * C)
    W, Wa, Wd = _weights(V, C, N, seed=N + 1)
    jc = jax_dense_counts(ad, dp, dtype=jnp.int8)
    tad, tdp = torch.as_tensor(ad), torch.as_tensor(dp)
    a64, d64 = tad.double(), tdp.double()
    got = _emulated_suff_stats(tad, tdp, torch.as_tensor(W))
    mag = np.abs(W).astype(np.float64)
    for j, t, m in zip(jc.suff_stats(jnp.asarray(W)), got,
                       (a64.numpy() @ mag, d64.numpy() @ mag)):
        bound = (_gamma(3 * C) + _gamma(C)) * m
        assert np.all(np.abs(t.numpy() - np.asarray(j)) <= bound)
    got = _emulated_cell_loglik(tad, tdp, torch.as_tensor(Wa),
                                torch.as_tensor(Wd)).numpy()
    ref = np.asarray(jc.cell_loglik(jnp.asarray(Wa), jnp.asarray(Wd)))
    mag = a64.numpy().T @ np.abs(Wa) + d64.numpy().T @ np.abs(Wd)
    bound = (_gamma(6 * V) + _gamma(2 * V)) * mag
    assert np.all(np.abs(got - ref) <= bound)
    assert np.abs(got - ref).max() > 0   # the orders do differ
