"""K0, the dense rung's int8 contractions (vireo_tpu_torch.ops.counts:
`dense_suff_stats`, `dense_cell_loglik`, csrc/dense_counts.cu), on the
CPU: the wrappers' dispatch and launch checks, and K0's arithmetic
against vireo_tpu.ops.counts.DenseCounts, whose XLA dots read int8
counts cast to bf16 (vireo_tpu/ops/counts.py:71-95).

The CUDA kernels run only on a card; chip_smoke.py's `[k0]` phase holds
them against the plain versions there. Here the host pieces of their
design are checked (the tile schedule `k0_plan`, the k order of the
suff_stats B operand `k0_operand`, the choice of producer
`k0_producer`), and a CPU emulation of their arithmetic in their order
of sums (each float32 weight split into three bf16 terms; each 64-deep
k-block, its k values in the kernel's order, summed in float32 on its
own; a slice's k-blocks added in float32 in order from 0; the slices
added in order) is held against JAX's DenseCounts on int8 counts and
float32 weights:
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

import re

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


# the H100's SMs: the plans the emulation follows are the card's
SMS = 132


def _k0_slices(plan, total_of):
    """The slices' sums added in slice order, each slice's k-blocks
    (total_of(t) for k-block t) added in k order to float32 sums from 0:
    the kernels' order of sums."""
    total = None
    for sl in range(plan.slices):
        t0 = sl * plan.slice_kb
        acc = None
        for t in range(t0, min(t0 + plan.slice_kb, plan.nkb)):
            blk = total_of(t)
            acc = blk if acc is None else acc + blk
        total = acc if total is None else total + acc
    return total


def _k0_emulation(A, W, plan):
    """Sum over k of A[:, k] * W[k, :] as K0's suff_stats forms it: W's
    three bf16 terms, each k-block of K_BLOCK cells (read in k0_k_order)
    summed in float32 on its own, in the plan's slices."""
    terms = [t.float() for t in split_bf16x3(W)]
    order = torch.as_tensor(counts.k0_k_order("suff_stats"))

    def block(t):
        cells = K_BLOCK * t + order
        cells = cells[cells < A.shape[1]]
        a = A[:, cells].float()
        return sum(a @ term[cells] for term in terms)
    return _k0_slices(plan, block)


def _emulated_suff_stats(ad, dp, W, sms=SMS):
    plan = counts.k0_plan("suff_stats", ad.shape[0], ad.shape[1],
                          W.shape[1], sms)
    return _k0_emulation(ad, W, plan), _k0_emulation(dp, W, plan)


def _emulated_cell_loglik(ad, dp, Wa, Wd, sms=SMS):
    """AD.T @ Wa + DP.T @ Wd as K0's cell_loglik forms it: a k-block of
    K_BLOCK variants takes both matrices and the three terms of each
    weight, summed in float32 on its own, in the plan's slices."""
    plan = counts.k0_plan("cell_loglik", ad.shape[0], ad.shape[1],
                          Wa.shape[1], sms)
    ta = [t.float() for t in split_bf16x3(Wa)]
    td = [t.float() for t in split_bf16x3(Wd)]

    def block(t):
        blk = slice(K_BLOCK * t, K_BLOCK * (t + 1))
        a, d = ad[blk].float().t(), dp[blk].float().t()
        return sum(a @ x[blk] for x in ta) + sum(d @ x[blk] for x in td)
    return _k0_slices(plan, block)


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
    monkeypatch.setattr(counts, "_sms", lambda device: SMS)
    monkeypatch.setattr(counts, "launch",
                        lambda name, fn, args, device, err: fn(*args, 0))
    monkeypatch.setattr(counts, "LAUNCHES", dict.fromkeys(counts.LAUNCHES,
                                                          0))
    return lib


def test_cell_slice_and_odd_cells_reach_the_kernel_with_their_pitch(
        fake_card):
    """A cell range that starts at an odd column and ends at its parent's
    last one, and an odd cell count, reach the kernels in place: the
    view's first byte, the parent's row pitch, the slice's cells, the
    producer without TMA; suff_stats' B rows padded to whole k-blocks,
    cell_loglik's to a whole 16 bytes; k0_plan's schedule. Counts whose
    cells are not contiguous are copied first."""
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
    for args, name in ((a1, "suff_stats"), (a2, "cell_loglik")):
        assert args[0] == ad.data_ptr() + start
        assert args[1] == dp.data_ptr() + start
        assert args[-8] == C0                   # the row pitch
        plan = counts.k0_plan(name, V, C, 5, SMS)
        # the plan, the producer without TMA, mode full; then the stream
        assert args[-7:] == (plan.bn, plan.slices, plan.slice_kb, plan.grid,
                             0, 0, 0)
    assert a1[7:11] == (V, C, 5, -(-C // 64) * 64)
    assert a2[7:11] == (V, C, 5, -(-V // 8) * 8)
    assert a1[2] == W.data_ptr() and a2[2:4] == (Wa.data_ptr(),) * 2
    assert counts.LAUNCHES == {"dense_suff_stats": 1, "dense_cell_loglik": 1}

    fake_card.calls.clear()
    cols = DenseCounts(ad.t().contiguous().t(), dp.t().contiguous().t())
    cols.suff_stats(torch.ones((C0, 2), dtype=torch.float32))
    (_, args), = fake_card.calls
    assert args[0] != ad.data_ptr() and args[-8] == C0


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


# chip_smoke's [k0] shapes (warm, refit and the K sweep's widths on the
# main pool, the edge shapes) and ragged ones: V, C and N off every tile
PLAN_SHAPES = [(name, V, C, N)
               for name in ("suff_stats", "cell_loglik")
               for V, C, N in ((30000, 100000, 320), (30000, 100000, 16),
                               (30000, 100000, 96), (30000, 100000, 128),
                               (1001, 1999, 21), (1001, 2000, 21),
                               (37, 53, 5), (130, 301, 21), (129, 65, 81),
                               (1, 1, 1))]


def _unit(plan, u):
    """(m_tile, n_tile, slice, t0, t1) of unit u as the kernels read it
    (csrc/dense_counts.cu, Plan::unit): slice-major, then output-row
    tiles, then column tiles; k-blocks [t0, t1)."""
    sl, rest = divmod(u, plan.m_tiles * plan.n_tiles)
    mt, nt = divmod(rest, plan.n_tiles)
    t0 = sl * plan.slice_kb
    return mt, nt, sl, t0, min(t0 + plan.slice_kb, plan.nkb)


@pytest.mark.parametrize("name,V,C,N", PLAN_SHAPES)
def test_k0_schedule_covers_each_tile_and_k_range_once(name, V, C, N):
    """k0_plan's units, walked as the kernels walk them (block b takes
    units b, b + grid, ...), cover every (row or cell tile, column tile,
    k-block) exactly once, each unit one nonempty slice of whole
    k-blocks; the blocks' shares differ by at most one unit."""
    plan = counts.k0_plan(name, V, C, N, SMS)
    rows, max_bn = counts.K0_TILES[name]
    m_len, k_len = (V, C) if name == "suff_stats" else (C, V)
    assert (plan.m_len, plan.k_len, plan.N) == (m_len, k_len, N)
    assert plan.bn % 16 == 0 and 16 <= plan.bn <= max_bn
    assert plan.bn * (plan.n_tiles - 1) < N <= plan.bn * plan.n_tiles
    assert rows * (plan.m_tiles - 1) < m_len <= rows * plan.m_tiles
    assert plan.nkb == -(-k_len // K_BLOCK)
    assert 1 <= plan.slices <= counts.K0_MAX_SLICES
    assert plan.units == plan.slices * plan.m_tiles * plan.n_tiles
    assert plan.grid == min(SMS, plan.units)
    seen, shares = {}, {}
    order = [(b, u) for b in range(plan.grid)
             for u in range(b, plan.units, plan.grid)]
    assert sorted(u for _, u in order) == list(range(plan.units))
    for b, u in order:
        mt, nt, sl, t0, t1 = _unit(plan, u)
        assert 0 <= mt < plan.m_tiles and 0 <= nt < plan.n_tiles
        assert t0 == sl * plan.slice_kb and t0 < t1 <= plan.nkb
        for t in range(t0, t1):
            seen[(mt, nt, t)] = seen.get((mt, nt, t), 0) + 1
        shares[b] = shares.get(b, 0) + 1
    assert len(seen) == plan.m_tiles * plan.n_tiles * plan.nkb
    assert set(seen.values()) == {1}
    assert max(shares.values()) - min(shares.values()) <= 1


@pytest.mark.parametrize("name,N,slices", [("suff_stats", 320, 4),
                                           ("suff_stats", 16, 5),
                                           ("cell_loglik", 320, 1),
                                           ("cell_loglik", 16, 1)])
def test_k0_plan_fills_the_waves_at_the_main_pools_shapes(name, N, slices):
    """At the main pool's shape on 132 SMs the last wave is at least 95%
    full: suff_stats' 235 row tiles are split over the cells (5 slices
    at N = 16, 4 at N = 320 with 4 column tiles of 80), cell_loglik's
    391 tiles of 256 cells (x 5 column tiles of 64 at N = 320) need no
    split."""
    plan = counts.k0_plan(name, 30000, 100000, N, SMS)
    assert plan.slices == slices
    assert plan.bn == (16 if N == 16 else
                       80 if name == "suff_stats" else 64)
    waves = -(-plan.units // plan.grid)
    assert plan.units / (plan.grid * waves) >= 0.95


def _instantiated_widths(name):
    """The column tiles csrc/dense_counts.cu instantiates K0's kernel
    `name` at (K0_SUFF_WIDTHS, K0_LOGLIK_WIDTHS), parsed from the source;
    its dispatch refuses any other."""
    macro = {"suff_stats": "K0_SUFF_WIDTHS",
             "cell_loglik": "K0_LOGLIK_WIDTHS"}[name]
    text = _build.source_path("dense_counts").read_text()
    found = re.search(r"#define %s\(X\)((?: X\(\d+\))+)\n" % macro, text)
    return [int(x) for x in re.findall(r"X\((\d+)\)", found.group(1))]


@pytest.mark.parametrize("N,suff,loglik", [(96, 48, 48), (112, 64, 64),
                                           (128, 64, 64), (144, 80, 48)])
def test_k0_tiles_at_the_k_sweeps_widths(N, suff, loglik):
    """The K sweep's warm widths n_init x K (8 x 12, 14, 16, 18: chip_smoke's
    [ksweep]) take these column tiles at the main pool's shape, each one
    the source instantiates."""
    for name, bn in (("suff_stats", suff), ("cell_loglik", loglik)):
        plan = counts.k0_plan(name, 30000, 100000, N, SMS)
        assert plan.bn == bn == counts.pick_tile(N, counts.K0_TILES[name][1])
        assert bn in _instantiated_widths(name)


@pytest.mark.parametrize("name", ["suff_stats", "cell_loglik"])
def test_every_k0_tile_is_instantiated(name):
    """Every column tile the plan picks, for N from 1 to 1024, is a width
    the source instantiates, and every instantiated width is picked for
    some N: the widest is K0_TILES' and the rest are its multiples of
    16 below it."""
    widths = _instantiated_widths(name)
    assert widths == list(range(16, counts.K0_TILES[name][1] + 1, 16))
    picked = {counts.k0_plan(name, 300, 1000, N, SMS).bn
              for N in range(1, 1025)}
    assert picked == set(widths)


def test_k0_k_order_gives_each_lane_column_16_adjacent_cells():
    """suff_stats' k order: k value L = 16 s + 8 h + 2 c + e of a k-block
    is cell 16 c + 4 s + 2 h + e, so lane column c's 16 k values (four
    k16 steps x two register halves x two elements) are cells 16 c ..
    16 c + 15, a 16-byte load; word s holds step s's pairs (2c, 2c + 1)
    and (2c + 8, 2c + 9). cell_loglik reads the variants in order."""
    order = counts.k0_k_order("suff_stats")
    assert sorted(order) == list(range(K_BLOCK))
    for L in range(K_BLOCK):
        s, h, c, e = L // 16, (L // 8) % 2, (L // 2) % 4, L % 2
        assert L == 16 * s + 2 * c + 8 * h + e
        assert order[L] == 16 * c + 4 * s + 2 * h + e
    assert list(counts.k0_k_order("cell_loglik")) == list(range(K_BLOCK))


@pytest.mark.parametrize("K,N", [(1, 1), (53, 5), (64, 3), (301, 21),
                                 (1999, 7)])
def test_k0_operand_round_trips_to_split_weights_kmajor(K, N):
    """suff_stats' permuted B, its k axis put back in cell order, is
    split_weights_kmajor's B bit for bit, and zero for the rows past the
    last cell; cell_loglik's is split_weights_kmajor's."""
    from vireo_tpu_torch.ops.packed import split_weights_kmajor
    rng = np.random.RandomState(K + N)
    W = torch.as_tensor(rng.standard_normal((K, N)).astype(np.float32))
    b = counts.k0_operand("suff_stats", W)
    K64 = -(-K // K_BLOCK) * K_BLOCK
    assert b.shape == (3, N, K64) and b.dtype == torch.bfloat16
    rows = np.arange(K64)
    cell = K_BLOCK * (rows // K_BLOCK) + counts.k0_k_order(
        "suff_stats")[rows % K_BLOCK]
    back = torch.zeros_like(b)
    back[:, :, torch.as_tensor(cell)] = b
    ref = split_weights_kmajor(W)
    assert torch.equal(back[:, :, :K], ref[:, :, :K])
    assert not back[:, :, K:].any()
    Wd = torch.as_tensor(rng.standard_normal((K, N)).astype(np.float32))
    assert torch.equal(counts.k0_operand("cell_loglik", W, Wd),
                       split_weights_kmajor(W, Wd))


def test_k0_producer_sends_aligned_rows_to_tma_and_odd_views_to_loads():
    """TMA for counts whose rows start on 16 bytes and lie a whole 16
    bytes apart (the main pool: C = 100000; a view from a column that is
    a multiple of 16); the producer warp's loads for a cell_slice view
    from an odd column and for rows of a C off 16."""
    def producer(dc):
        ad, dp, pitch, _ = counts._check_launch(
            "dense_suff_stats", dc.ad, dc.dp,
            [torch.zeros((dc.n_cell, 1))], dc.n_cell)
        return counts.k0_producer(ad, dp, pitch)
    ad, dp = (torch.as_tensor(x) for x in _int8_pool(13, 160, seed=10))
    whole = DenseCounts(ad, dp)
    assert ad.data_ptr() % 16 == 0 and dp.data_ptr() % 16 == 0
    assert producer(whole) == "tma"
    assert producer(whole.cell_slice(16, 160)) == "tma"
    assert producer(whole.cell_slice(7, 160)) == "loads"
    assert producer(whole.cell_slice(16, 151)) == "tma"
    odd = DenseCounts(*(torch.as_tensor(x) for x in _int8_pool(13, 1999,
                                                               seed=11)))
    assert producer(odd) == "loads"


def test_aligned_counts_reach_the_kernel_with_tma(fake_card):
    V, C = 9, 2000
    dc = DenseCounts(*(torch.as_tensor(x) for x in _int8_pool(V, C,
                                                              seed=12)))
    dc.suff_stats(torch.ones((C, 3), dtype=torch.float32))
    dc.cell_loglik(torch.ones((V, 3)), torch.ones((V, 3)))
    (_, a1), (_, a2) = fake_card.calls
    assert a1[-3:] == (1, 0, 0) and a2[-3:] == (1, 0, 0)  # TMA, full
    assert a1[-8] == a2[-8] == C
