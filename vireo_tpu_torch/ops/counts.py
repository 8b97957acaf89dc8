"""Allele-count matrices on the device: the single-device capacity ladder
of vireo_tpu/ops/counts.py.

Every model-side use of the data is one of two contractions:

- ``suff_stats(W)``:       (S1, SS) = (AD @ W, DP @ W)    variant side
- ``cell_loglik(Wa, Wd)``: AD.T @ Wa + DP.T @ Wd          cell side

Four interchangeable classes implement them, and `counts_from_scipy`
picks one by the pool's size and largest count (`ladder_rung`):

- ``DenseCounts``: AD and DP dense, (n_var, n_cell), in the smallest
  type that holds every count exactly (`exact_count_dtype`): int8 up to
  127, which is what real pools give. int8 counts go through K0
  (`dense_suff_stats`, `dense_cell_loglik`): on a card the CUDA kernels
  of csrc/dense_counts.cu on a static tile schedule (`k0_plan`), which
  build bf16 operands in registers from the count bytes, as the JAX
  package's XLA dots read int8 cast to bf16
  (vireo_tpu/ops/counts.py:71-95); on the CPU their plain versions.
  The plain versions (`suff_stats_reference`,
  `cell_loglik_reference`) convert the counts to the weights' type one
  block of variant rows at a time and hand each block to
  `torch.matmul`; counts of other types (bfloat16 or float32, for pools
  with counts above 127) always take them, as the JAX package takes a
  plain dot there, at `Precision.HIGHEST` for float32
  (vireo_tpu/ops/counts.py:61-69).
- ``PackedCounts`` (ops/packed.py): two cells a byte when every count is
  <= 15, with the CUDA kernels K2 and K3.
- ``HybridCounts``: an int8 or packed base clipped at its cap plus a COO
  residual of the few deltas above it.
- ``SparseCounts``: COO triplets, gathered and summed in a fixed order
  (`index_put_(accumulate=True)`).

On a mesh (`counts_from_scipy(..., mesh=)`) the ladder picks one rung
for the whole pool, from its global shape and largest count, with the
budget of the ranks it spans, and each rank places its block of that
rung, wrapped in a `parallel.mesh.ShardedCounts`.

Every rung is placed by one route (`_place_rung`): each matrix from its
own compressed arrays, scattered on the device by the writer of its
layout (`_place_dense`, `_place_packed`), the hybrids' bases clipped.
AD and DP are aligned on the host to the union of their nonzero
patterns (`_host_union_triplets`) only where one layout holds both on
one pattern: the COO rung, and a hybrid's residual, from the entries
above its cap alone.
"""

import ctypes
import dataclasses
import os

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.timing import span
from ._launch import launch, on_cpu
from .math import log_binom_coeff
from .packed import (PACK_MAX, PackedCounts, check_weights,
                     split_weights_kmajor)

__all__ = ["Counts", "DenseCounts", "SparseCounts", "HybridCounts",
           "counts_from_scipy", "dense_counts", "sparse_counts",
           "hybrid_from_coo", "ladder_rung", "exact_count_dtype",
           "device_dense_budget", "dense_suff_stats", "dense_cell_loglik",
           "device_room", "placement_rung", "suff_stats_reference",
           "cell_loglik_reference", "LAUNCHES", "MATMULS",
           "K0Plan", "k0_plan", "k0_k_order", "k0_operand",
           "k0_device_operand", "k0_producer", "k0_shape", "k0_control"]

# No counterpart of vireo_tpu/ops/counts.py::_divisible_sharding: there a
# spec axis that does not divide the counts' shape is replicated; here
# the cells split into equal ranges of ceil(C / S) (the model's pool
# padded with zero-count cells where S does not divide C) and the
# variants into equal ranges, the last one short, so every extent fits.

# bytes of one converted block of count rows (the plain versions and the
# reductions)
_CHUNK_BYTES = 1 << 29

# launches of each CUDA kernel of K0
LAUNCHES = {"dense_suff_stats": 0, "dense_cell_loglik": 0}

# calls of DenseCounts' plain contractions of non-int8 counts (bfloat16
# or float32: the pools with counts above 127), on any device
MATMULS = {"suff_stats": 0, "cell_loglik": 0}

_LIB = None


def _row_blocks(n_var, n_cell, itemsize, row_chunk=None):
    """(r0, r1) blocks of variant rows, `row_chunk` rows or about 512 MB
    of `itemsize`-byte values each."""
    rows = row_chunk
    if rows is None:
        rows = _CHUNK_BYTES // max(n_cell * itemsize, 1)
    rows = max(int(rows), 1)
    for r0 in range(0, n_var, rows):
        yield r0, min(r0 + rows, n_var)


def _converted(ad, dp, dtype, row_chunk=None):
    """(r0, r1, AD rows, DP rows) blocks converted to `dtype`."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    for r0, r1 in _row_blocks(ad.shape[0], ad.shape[1], itemsize, row_chunk):
        yield r0, r1, ad[r0:r1].to(dtype), dp[r0:r1].to(dtype)


def suff_stats_reference(ad, dp, W, row_chunk=None):
    """Plain version of K0's suff_stats: (AD @ W, DP @ W) for W
    (n_cell, N) -> two (n_var, N) in W's type, one block of converted
    rows at a time (`row_chunk` rows, or about 512 MB)."""
    S1 = torch.empty((ad.shape[0], W.shape[1]), dtype=W.dtype,
                     device=W.device)
    SS = torch.empty_like(S1)
    for r0, r1, a, d in _converted(ad, dp, W.dtype, row_chunk):
        torch.matmul(a, W, out=S1[r0:r1])
        torch.matmul(d, W, out=SS[r0:r1])
    return S1, SS


def cell_loglik_reference(ad, dp, Wa, Wd, row_chunk=None):
    """Plain version of K0's cell_loglik: AD.T @ Wa + DP.T @ Wd for
    (n_var, N) weights -> (n_cell, N) in the weights' type, one block of
    converted rows at a time."""
    out = torch.zeros((ad.shape[1], Wa.shape[1]), dtype=Wa.dtype,
                      device=Wa.device)
    for r0, r1, a, d in _converted(ad, dp, Wa.dtype, row_chunk):
        out.addmm_(a.t(), Wa[r0:r1])
        out.addmm_(d.t(), Wd[r0:r1])
    return out


def _library():
    global _LIB
    if _LIB is None:
        from ._build import load_library
        lib = load_library("dense_counts")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn in (lib.vireo_dense_suff_stats, lib.vireo_dense_cell_loglik):
            fn.argtypes = [ptr] * 7 + [i32] * 4 + [i64] + [i32] * 6 + [ptr]
            fn.restype = i32
        lib.vireo_dense_operand.argtypes = [i32, ptr, ptr] + [i32] * 3 + [
            ptr, ptr]
        lib.vireo_dense_operand.restype = i32
        lib.vireo_dense_shape.argtypes = [i32, i32, ctypes.POINTER(i32)]
        lib.vireo_dense_shape.restype = i32
        lib.vireo_dense_error_string.argtypes = [i32]
        lib.vireo_dense_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


# K0's kernels (csrc/dense_counts.cu): the output rows (variants for
# suff_stats, cells for cell_loglik) a block owns, and the widest column
# tile; the contracted axis in k-blocks of K0_KBLOCK, split into at most
# K0_MAX_SLICES slices where the tiles leave a tail wave.
K0_TILES = {"suff_stats": (128, 80), "cell_loglik": (256, 64)}
K0_KBLOCK = 64
K0_MAX_SLICES = 8
# the kernels' modes: the contraction, and the two controls that time it
# without its MMAs and without its float32 adds of the k-block sums
K0_MODES = {"full": 0, "no_mma": 1, "no_fold": 2}


@dataclasses.dataclass(frozen=True)
class K0Plan:
    """K0's static tile schedule for one call (`k0_plan`)."""
    name: str
    m_len: int      # output rows: n_var (suff_stats) or n_cell
    k_len: int      # contracted length: n_cell or n_var
    N: int
    bn: int         # column tile
    m_tiles: int
    n_tiles: int
    nkb: int        # k-blocks over k_len
    slices: int
    slice_kb: int   # k-blocks a slice (the last may hold fewer)
    units: int      # slices x m_tiles x n_tiles, slice-major, then
                    # output-row tiles, then column tiles
    grid: int       # persistent blocks: block b takes units b, b + grid, ...


def pick_tile(N, max_bn, unit=16):
    """Column tile: 16 for N <= 16, else as few tiles of at most max_bn
    columns as cover N, balanced, in multiples of `unit`
    (hopper_gemm.cuh::pick_tile)."""
    if N <= 16:
        return 16
    chunks = -(-N // unit)
    tiles = -(-chunks // (max_bn // unit))
    return unit * -(-chunks // tiles)


def k0_plan(name, n_var, n_cell, N, sms):
    """K0's tile schedule for `name` on a card of `sms` SMs: the column
    tile, and the number of slices of the contracted axis (1 to
    K0_MAX_SLICES, whole k-blocks each) that makes the waves of units
    shortest, each extra slice charged 1% for its scratch and the ordered
    adds of the slices."""
    rows, max_bn = K0_TILES[name]
    m_len, k_len = ((n_var, n_cell) if name == "suff_stats"
                    else (n_cell, n_var))
    bn = pick_tile(N, max_bn)
    m_tiles, n_tiles = -(-m_len // rows), -(-N // bn)
    nkb = -(-k_len // K0_KBLOCK)
    best = None
    for want in range(1, min(K0_MAX_SLICES, nkb) + 1):
        slice_kb = -(-nkb // want)
        slices = -(-nkb // slice_kb)
        units = m_tiles * n_tiles * slices
        cost = -(-units // sms) * slice_kb * (1 + 0.01 * (slices - 1))
        if best is None or cost < best[0]:
            best = (cost, slices, slice_kb, units)
    _, slices, slice_kb, units = best
    return K0Plan(name, m_len, k_len, N, bn, m_tiles, n_tiles, nkb, slices,
                  slice_kb, units, min(sms, units))


def k0_k_order(name):
    """Where K0's kernel `name` reads k value L of a k-block, as an array
    over L: suff_stats takes k value L = 16 s + 8 h + 2 c + e (k16 step s,
    register half h, lane column c, element e) from cell
    16 c + 4 s + 2 h + e of the k-block, so a thread's 16 k values are 16
    adjacent count bytes; cell_loglik reads the variants in order."""
    L = np.arange(K0_KBLOCK)
    if name == "cell_loglik":
        return L
    s, h, c, e = L // 16, (L // 8) % 2, (L // 2) % 4, L % 2
    return 16 * c + 4 * s + 2 * h + e


def _k0_ld(name, K):
    """The row length of K0's B operand over K contracted values: whole
    k-blocks for suff_stats, whole 16 bytes (TMA's row stride) for
    cell_loglik."""
    unit = K0_KBLOCK if name == "suff_stats" else 8
    return -(-K // unit) * unit


def k0_operand(name, *mats):
    """The B operand of K0's kernel `name`, the plain version of what its
    operand kernel writes on the card (`k0_device_operand`):
    `split_weights_kmajor`'s three bf16 terms of each weight matrix. For
    suff_stats W's rows (cells) are padded with zero rows to whole
    k-blocks and put in k0_k_order within each: B[p, n, 64 t + L] =
    term_p[64 t + k0_k_order[L], n], zero past n_cell; (3, N, ld) with ld
    the cells rounded up to a whole k-block. For cell_loglik as
    split_weights_kmajor gives it."""
    if name == "cell_loglik":
        return split_weights_kmajor(*mats)
    W, = mats
    k = np.arange(W.shape[0])
    # the row of B that holds cell k
    pos = K0_KBLOCK * (k // K0_KBLOCK) + np.argsort(
        k0_k_order("suff_stats"))[k % K0_KBLOCK]
    Wp = W.new_zeros((_k0_ld("suff_stats", len(k)), W.shape[1]))
    Wp[torch.as_tensor(pos, device=W.device)] = W
    return split_weights_kmajor(Wp)


def k0_device_operand(name, *mats):
    """K0's B operand as its operand kernel writes it (the first launch
    of every K0 call) from contiguous float32 weights on a card: equal to
    k0_operand's bit for bit."""
    K, N = mats[0].shape
    b = torch.empty((3 * len(mats), N, _k0_ld(name, K)),
                    dtype=torch.bfloat16, device=mats[0].device)
    lib = _library()
    launch("dense_operand", lib.vireo_dense_operand,
           (0 if name == "suff_stats" else 1, mats[0].data_ptr(),
            mats[-1].data_ptr(), K, N, b.shape[2], b.data_ptr()),
           mats[0].device, lib.vireo_dense_error_string)
    return b


def k0_producer(ad, dp, pitch):
    """How K0's kernels bring the counts in: "tma" when both matrices
    start on a 16-byte boundary and their rows lie a whole number of 16
    bytes apart (what a TMA tensor map addresses), else "loads" (the
    producer warp's aligned word loads, realigned; a cell_slice view
    from an odd column)."""
    aligned = (ad.data_ptr() % 16 == 0 and dp.data_ptr() % 16 == 0
               and pitch % 16 == 0)
    return "tma" if aligned else "loads"


_SMS = {}


def _sms(device):
    """The card's SM count."""
    key = str(device)
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[key]


def k0_shape(name, bn):
    """K0's kernel `name` at column tile `bn`, from the library: ring
    stages, bytes a stage, threads a block, dynamic shared memory, blocks
    an SM, registers a thread and spilled bytes a thread."""
    out = (ctypes.c_int * 7)()
    err = _library().vireo_dense_shape(
        0 if name == "suff_stats" else 1, bn, out)
    if err:
        raise ValueError("K0 %s has no kernel of tile %d" % (name, bn))
    keys = ("stages", "stage_bytes", "threads", "smem", "blocks_per_sm",
            "registers", "spill_bytes")
    return dict(zip(keys, out))


def _check_launch(name, ad, dp, weights, rows):
    """Validate what the kernels take: two int8 (n_var, n_cell) count
    matrices on one device and float32 weights of `rows` rows and one
    width. Returns (ad, dp, pitch, weights): the counts as they are when
    their cells are contiguous and both rows lie `pitch` bytes apart (a
    cell range of a wider matrix), else contiguous copies; the weights
    contiguous."""
    if ad.dtype != torch.int8 or dp.dtype != torch.int8:
        raise TypeError("%s reads int8 counts, got %s/%s"
                        % (name, ad.dtype, dp.dtype))
    if ad.dim() != 2 or dp.shape != ad.shape:
        raise ValueError("%s: count shapes %s/%s differ"
                         % (name, tuple(ad.shape), tuple(dp.shape)))
    weights = check_weights(name, ad, dp, weights, rows)
    V, C = ad.shape
    pitched = all(C <= 1 or x.stride(1) == 1 for x in (ad, dp)) and (
        V <= 1 or ad.stride(0) == dp.stride(0) >= C)
    if not pitched:
        ad, dp = ad.contiguous(), dp.contiguous()
    pitch = ad.stride(0) if V > 1 else C
    return ad, dp, pitch, weights


def _k0_launch(name, ad, dp, pitch, weights, outs, mode="full"):
    """Launch K0's kernel `name` (a checked call: `_check_launch`) into
    `outs` on the counts' card, by k0_plan's schedule, with a scratch
    of the slices' sums where the plan splits. `mode` is "full", or a
    control (K0_MODES) whose outputs mean nothing."""
    V, C = ad.shape
    N = weights[0].shape[1]
    dev = weights[0].device
    plan = k0_plan(name, V, C, N, _sms(dev))
    # the B operand's scratch, which the call's operand kernel fills
    b = torch.empty((3 * len(weights), N,
                     _k0_ld(name, C if name == "suff_stats" else V)),
                    dtype=torch.bfloat16, device=dev)
    part = None
    if plan.slices > 1:
        part = torch.empty((plan.slices,) + (
            (2, V, N) if name == "suff_stats" else (C, N)),
            dtype=torch.float32, device=dev)
    tma = k0_producer(ad, dp, pitch) == "tma"
    lib = _library()
    fn = (lib.vireo_dense_suff_stats if name == "suff_stats"
          else lib.vireo_dense_cell_loglik)
    args = ((ad.data_ptr(), dp.data_ptr())
            + tuple(w.data_ptr() for w in weights) + (b.data_ptr(),)
            + tuple(o.data_ptr() for o in outs)
            + (0 if part is None else part.data_ptr(), V, C, N, b.shape[2],
               pitch, plan.bn, plan.slices, plan.slice_kb, plan.grid,
               int(tma), K0_MODES[mode]))
    launch("dense_" + name, fn, args, dev, lib.vireo_dense_error_string)
    return plan


def dense_suff_stats(ad, dp, W, row_chunk=None):
    """K0's suff_stats: (AD @ W, DP @ W) for int8 counts and W
    (n_cell, N) -> two (n_var, N). CPU tensors run the plain version
    (`row_chunk` sizes its blocks); CUDA tensors launch the kernel
    (float32 weights only) or raise. Empty counts or weights give zeros
    without a launch."""
    if on_cpu("dense_suff_stats", ad):
        return suff_stats_reference(ad, dp, W, row_chunk)
    ad, dp, pitch, (W,) = _check_launch("dense_suff_stats", ad, dp, [W],
                                        ad.shape[1])
    (V, C), N = ad.shape, W.shape[1]
    if not (V and C and N):
        S1 = torch.zeros((V, N), dtype=torch.float32, device=W.device)
        return S1, torch.zeros_like(S1)
    # the kernel writes every element
    S1 = torch.empty((V, N), dtype=torch.float32, device=W.device)
    SS = torch.empty_like(S1)
    _k0_launch("suff_stats", ad, dp, pitch, [W], (S1, SS))
    LAUNCHES["dense_suff_stats"] += 1
    return S1, SS


def dense_cell_loglik(ad, dp, Wa, Wd, row_chunk=None):
    """K0's cell_loglik: AD.T @ Wa + DP.T @ Wd for int8 counts and
    (n_var, N) weights -> (n_cell, N). CPU tensors run the plain
    version; CUDA tensors launch the kernel (float32 weights only) or
    raise. Empty counts or weights give zeros without a launch."""
    if on_cpu("dense_cell_loglik", ad):
        return cell_loglik_reference(ad, dp, Wa, Wd, row_chunk)
    ad, dp, pitch, (Wa, Wd) = _check_launch(
        "dense_cell_loglik", ad, dp, [Wa, Wd], ad.shape[0])
    (V, C), N = ad.shape, Wa.shape[1]
    if not (V and C and N):
        return torch.zeros((C, N), dtype=torch.float32, device=Wa.device)
    out = torch.empty((C, N), dtype=torch.float32, device=Wa.device)
    _k0_launch("cell_loglik", ad, dp, pitch, [Wa, Wd], (out,))
    LAUNCHES["dense_cell_loglik"] += 1
    return out


def k0_control(name, counts, *weights, mode):
    """One launch of K0's kernel `name` on DenseCounts `counts` in a
    control mode ("no_mma" or "no_fold", K0_MODES), for timing: the same
    plan, ring and fragments; its outputs mean nothing and it counts no
    launch."""
    ad, dp, pitch, weights = _check_launch(
        name, counts.ad, counts.dp, list(weights),
        counts.n_cell if name == "suff_stats" else counts.n_var)
    V, C = ad.shape
    N = weights[0].shape[1]
    shapes = [(V, N), (V, N)] if name == "suff_stats" else [(C, N)]
    outs = [torch.empty(s, dtype=torch.float32, device=ad.device)
            for s in shapes]
    return _k0_launch(name, ad, dp, pitch, weights, outs, mode=mode)


@dataclasses.dataclass(frozen=True)
class DenseCounts:
    """Dense AD/DP counts of shape (n_var, n_cell).

    The contractions of int8 counts are K0 (`dense_suff_stats`,
    `dense_cell_loglik`), on a card its CUDA kernels; those of other
    types are the plain versions, each call counted in `MATMULS` and
    recorded as a `matmul` span inside the call's own. `row_chunk`
    fixes the number of variant rows the plain versions and the
    reductions convert per block; None sizes blocks to about 512 MB of
    the target type (`_CHUNK_BYTES`). The kernels convert nothing in
    device memory.
    """
    ad: torch.Tensor
    dp: torch.Tensor
    row_chunk: int = None

    @property
    def n_var(self):
        return self.ad.shape[0]

    @property
    def n_cell(self):
        return self.ad.shape[1]

    @property
    def device(self):
        return self.ad.device

    def _rows(self, itemsize):
        return _row_blocks(self.n_var, self.n_cell, itemsize, self.row_chunk)

    def _chunks(self, dtype):
        return _converted(self.ad, self.dp, dtype, self.row_chunk)

    def suff_stats(self, W):
        """(AD @ W, DP @ W) for W of shape (n_cell, N) -> two (n_var, N)."""
        with span("suff_stats"):
            if self.ad.dtype == torch.int8:
                return dense_suff_stats(self.ad, self.dp, W, self.row_chunk)
            MATMULS["suff_stats"] += 1
            with span("matmul"):
                return suff_stats_reference(self.ad, self.dp, W,
                                            self.row_chunk)

    def cell_loglik(self, Wa, Wd):
        """AD.T @ Wa + DP.T @ Wd for (n_var, N) weights -> (n_cell, N)."""
        with span("cell_loglik"):
            if self.ad.dtype == torch.int8:
                return dense_cell_loglik(self.ad, self.dp, Wa, Wd,
                                         self.row_chunk)
            MATMULS["cell_loglik"] += 1
            with span("matmul"):
                return cell_loglik_reference(self.ad, self.dp, Wa, Wd,
                                             self.row_chunk)

    def binom_coeff_sum(self):
        """Sum of log C(DP, AD) over DP > 0 entries, accumulated in
        float64 one block of rows at a time; a 0-d float64 tensor."""
        with span("binom"):
            total = torch.zeros((), dtype=torch.float64, device=self.device)
            for _, _, a, d in self._chunks(torch.float64):
                total += log_binom_coeff(d, a).sum()
            return total

    def row_sums(self):
        """(AD.sum(axis=1), DP.sum(axis=1)) -> two (n_var,), int64 for
        integer counts. Summed one block of rows at a time: an integer
        sum converts its whole input to int64 first, 24 GB at 30k
        variants x 100k cells."""
        blocks = [(self.ad[r0:r1].sum(dim=1), self.dp[r0:r1].sum(dim=1))
                  for r0, r1 in self._rows(8)]
        return tuple(torch.cat(x) for x in zip(*blocks))

    def n_vars_per_cell(self):
        """Number of variants with DP > 0 per cell (in blocks of rows, as
        `row_sums`)."""
        n = torch.zeros(self.n_cell, dtype=torch.int64, device=self.device)
        for r0, r1 in self._rows(8):
            n += (self.dp[r0:r1] > 0).sum(dim=0)
        return n

    def var_subset(self, idx):
        """The variant rows `idx` (indices or a boolean mask)."""
        idx = _row_index(idx, self.device)
        return DenseCounts(self.ad[idx], self.dp[idx])

    def cell_slice(self, start, stop):
        """Cells [start, stop)."""
        return DenseCounts(self.ad[:, start:stop], self.dp[:, start:stop])

    def densify(self):
        return self


def _row_index(idx, device):
    """Variant indices (or a boolean mask) as an int64 tensor on
    `device`."""
    idx = np.asarray(idx.cpu() if torch.is_tensor(idx) else idx)
    if idx.dtype == bool:
        idx = np.flatnonzero(idx)
    return torch.as_tensor(idx.astype(np.int64), device=device)


def exact_count_dtype(vmax):
    """Smallest type holding integer counts up to `vmax` exactly: int8
    (<= 127), bfloat16 (<= 256, 8-bit mantissa), else float32 (<= 2^24)."""
    if vmax <= 127:
        return torch.int8
    if vmax <= 256:
        return torch.bfloat16
    return torch.float32


def device_dense_budget(device=None):
    """Device bytes available for the two dense count matrices:
    VIREO_DENSE_BUDGET_GB GiB when that is set (as in the JAX package),
    else 55% of the card's total memory (`torch.cuda.mem_get_info`'s
    total; the JAX package takes 55% of the device's limit), leaving
    room for posteriors and converted blocks; 16 GiB on the CPU.
    `device` defaults to utils/device.py's."""
    env = os.environ.get("VIREO_DENSE_BUDGET_GB")
    if env:
        return float(env) * 2**30
    device = resolve_device(device)
    if device.type == "cuda":
        _, total = torch.cuda.mem_get_info(device)
        return 0.55 * total
    return 16 * 2**30


def device_room(device=None):
    """Bytes this process can still get on the card `device`: its free
    memory and what torch's caching allocator holds reserved but
    unallocated; None off a card."""
    device = resolve_device(device)
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) \
        - torch.cuda.memory_allocated(device)


def _host_union_triplets(AD, DP):
    """Aligned host COO triplets over the union nonzero pattern of AD and
    DP: (rows, cols, ad_vals, dp_vals), (row, col)-sorted, no duplicates.
    The numpy path of vireo_tpu/ops/counts.py::_host_union_triplets."""
    import scipy.sparse as sp

    def canon_csr(X):
        M = sp.csr_matrix(X)
        if not M.has_canonical_format:
            M = M.copy()
            M.sum_duplicates()
        return M

    A = canon_csr(AD)
    D = canon_csr(DP)
    if A.shape != D.shape:
        raise ValueError("AD and DP shapes differ: %s vs %s"
                         % (A.shape, D.shape))
    C = int(A.shape[1])
    if np.array_equal(A.indptr, D.indptr) and \
            np.array_equal(A.indices, D.indices):
        rows = np.repeat(np.arange(A.shape[0], dtype=np.int64),
                         np.diff(A.indptr))
        return rows, A.indices.astype(np.int64), A.data, D.data

    Ia = A.copy()
    Ia.data = np.ones_like(Ia.data)
    Id = D.copy()
    Id.data = np.ones_like(Id.data)
    U = Ia + Id
    rows = np.repeat(np.arange(U.shape[0], dtype=np.int64),
                     np.diff(U.indptr))
    cols = U.indices.astype(np.int64)
    key_u = rows * C + cols

    def align(M):
        Mc = M.tocoo()
        key = Mc.row.astype(np.int64) * C + Mc.col
        out = np.zeros(len(key_u), dtype=np.float64)
        out[np.searchsorted(key_u, key)] = Mc.data
        return out

    return rows, cols, align(A), align(D)


# nonzeros scattered per device call while densifying
_SCATTER_BLOCK = 1 << 22


def _upload_vals(vals, dtype, device):
    """Host count values on `device` as a `dtype` target takes them: up
    in the smallest exact type (int8 for an int8 target, float32
    otherwise), then converted. Values above 127 are clipped to 127 for
    an int8 target (the hybrid base), as the JAX package's int8 scatter
    clips them."""
    if dtype == torch.int8:
        vals = np.minimum(vals, 127).astype(np.int8)
    else:
        vals = np.asarray(vals).astype(np.float32)
    return torch.from_numpy(vals).to(device).to(dtype)


def _compressed(X):
    """X as a canonical scipy CSC or CSR matrix (sorted indices, no
    duplicates): CSC and CSR as they are, anything else (COO, other
    formats, numpy) converted once by `sp.csc_matrix`. A non-canonical
    matrix is summed on a copy: the caller's arrays never change."""
    import scipy.sparse as sp
    if not (sp.issparse(X) and X.format in ("csc", "csr")):
        X = sp.csc_matrix(X)
    if not X.has_canonical_format:
        X = X.copy()
        X.sum_duplicates()
    return X


def _entries(X, device):
    """The nonzeros of X, a CSC or CSR matrix without duplicates, in
    blocks of `_SCATTER_BLOCK`: (rows, cols, values), the indices int64
    tensors on `device`, the values X's host array. indptr goes up once;
    then each block's indices go up as int32, and on the device each
    nonzero's place in indptr gives its index along the compressed axis
    (a CSC's column, a CSR's row)."""
    ptr = torch.from_numpy(X.indptr.astype(np.int64)).to(device)
    nnz = int(X.indptr[-1])
    for lo in range(0, nnz, _SCATTER_BLOCK):
        hi = min(lo + _SCATTER_BLOCK, nnz)
        minor = torch.from_numpy(X.indices[lo:hi].astype(np.int32)) \
            .to(device).long()
        major = torch.searchsorted(
            ptr, torch.arange(lo, hi, device=device), right=True) - 1
        r, c = (minor, major) if X.format == "csc" else (major, minor)
        yield r, c, X.data[lo:hi]


def _place_dense(X, shape, dtype, device):
    """Dense (V, C) tensor of `dtype` on `device` from the compressed
    arrays of X, a CSC or CSR matrix without duplicates (`_compressed`,
    or a block that `_cut_block` cuts from one): each block of
    `_entries` scattered into a zero matrix, the values as `_upload_vals`
    sends them. X may have fewer rows or columns than `shape` (a mesh
    rank's block with its padded cells): those stay zero."""
    V, C = shape
    out = torch.zeros((V, C), dtype=dtype, device=device)
    flat = out.view(-1)
    for r, c, vals in _entries(X, device):
        flat[r * C + c] = _upload_vals(vals, dtype, device)
    return out


def _place_packed(X, shape, device, clip=False):
    """One matrix of PackedCounts, two cells a byte ((V, ceil(C / 2))
    uint8 on `device`), from the compressed arrays of X as `_place_dense`
    takes them.

    Per block of `_entries`, the values of even columns, then those of
    odd columns shifted by 4, are OR-ed into zeroed bytes. Within one
    parity the byte indices are unique, so each read-or-write is exact
    and no atomic byte add is needed. Every value must be <= PACK_MAX
    unless `clip` saturates it there (the packed hybrid base).
    """
    V, C = shape
    Cb = (C + 1) // 2
    out = torch.zeros((V, Cb), dtype=torch.uint8, device=device)
    flat = out.view(-1)
    for r, c, vals in _entries(X, device):
        if clip:
            vals = np.minimum(vals, PACK_MAX)
        v = torch.from_numpy(vals.astype(np.uint8)).to(device)
        idx = r * Cb + (c >> 1)
        odd = (c & 1).bool()
        for sel, shift in ((~odd, 0), (odd, 4)):
            i = idx[sel]
            flat[i] = flat[i] | (v[sel] << shift)
    return out


def _csr_pair(coo):
    """A SparseCounts' AD and DP as host CSR matrices: its (row,
    col)-sorted unique triplets are a canonical CSR once an indptr is
    counted from the rows."""
    import scipy.sparse as sp
    rows = coo.rows_r.cpu().numpy()
    indptr = np.concatenate(
        [[0], np.cumsum(np.bincount(rows, minlength=coo.n_var))])
    cols = coo.cols_r.cpu().numpy()
    return tuple(sp.csr_matrix((v.cpu().numpy(), cols, indptr),
                               shape=coo.shape) for v in (coo.ad_r, coo.dp_r))


@dataclasses.dataclass(frozen=True)
class SparseCounts:
    """COO counts over the union nonzero pattern, in two sort orders.

    `*_r` tensors are sorted by (row, col) and serve `suff_stats` and
    the row reductions; `*_c` tensors are sorted by (col, row) and serve
    `cell_loglik` and `n_vars_per_cell`. Indices are int32, values
    float32 (exact up to 2^24). Each contraction gathers the weight rows
    of a block of `NNZ_BLOCK` nonzeros, scales them by the counts and
    sums them into the output with `index_put_(accumulate=True)`: the
    segment sum of vireo_tpu/ops/counts.py::SparseCounts. It adds the
    terms of each output row in a fixed order (on the CPU, their sort
    order), so the float sums do not change from run to run, where
    `index_add_` adds with atomics on a card, in an order that does.
    """

    rows_r: torch.Tensor
    cols_r: torch.Tensor
    ad_r: torch.Tensor
    dp_r: torch.Tensor
    rows_c: torch.Tensor
    cols_c: torch.Tensor
    ad_c: torch.Tensor
    dp_c: torch.Tensor
    shape: tuple

    # nonzeros per gathered block: bounds the (block, N) temporaries
    NNZ_BLOCK = 1 << 21

    @property
    def n_var(self):
        return self.shape[0]

    @property
    def n_cell(self):
        return self.shape[1]

    @property
    def nnz(self):
        return int(self.rows_r.shape[0])

    @property
    def device(self):
        return self.rows_r.device

    def _blocks(self):
        for lo in range(0, self.nnz, self.NNZ_BLOCK):
            yield slice(lo, min(lo + self.NNZ_BLOCK, self.nnz))

    def suff_stats(self, W):
        """(AD @ W, DP @ W) for W (n_cell, N) -> two (n_var, N)."""
        with span("suff_stats"):
            S1 = torch.zeros((self.n_var, W.shape[1]), dtype=W.dtype,
                             device=W.device)
            SS = torch.zeros_like(S1)
            for b in self._blocks():
                x = W.index_select(0, self.cols_r[b])
                rows = (self.rows_r[b],)
                S1.index_put_(rows, self.ad_r[b, None] * x, accumulate=True)
                SS.index_put_(rows, self.dp_r[b, None] * x, accumulate=True)
            return S1, SS

    def cell_loglik(self, Wa, Wd):
        """AD.T @ Wa + DP.T @ Wd for (n_var, N) weights -> (n_cell, N)."""
        with span("cell_loglik"):
            out = torch.zeros((self.n_cell, Wa.shape[1]), dtype=Wa.dtype,
                              device=Wa.device)
            for b in self._blocks():
                r = self.rows_c[b]
                out.index_put_((self.cols_c[b],),
                               self.ad_c[b, None] * Wa.index_select(0, r)
                               + self.dp_c[b, None] * Wd.index_select(0, r),
                               accumulate=True)
            return out

    def binom_coeff_sum(self):
        """Sum of log C(DP, AD) over the nonzeros, in float64."""
        with span("binom"):
            return log_binom_coeff(self.dp_r.double(),
                                   self.ad_r.double()).sum()

    def row_sums(self):
        """(AD.sum(axis=1), DP.sum(axis=1)) -> two float64 (n_var,)."""
        out = []
        for v in (self.ad_r, self.dp_r):
            s = torch.zeros(self.n_var, dtype=torch.float64,
                            device=self.device)
            out.append(s.index_add_(0, self.rows_r, v.double()))
        return tuple(out)

    def n_vars_per_cell(self):
        """Number of variants with DP > 0 per cell."""
        n = torch.zeros(self.n_cell, dtype=torch.int64, device=self.device)
        return n.index_add_(0, self.cols_c, (self.dp_c > 0).long())

    def max_count(self):
        """Largest count value (a host float)."""
        if self.nnz == 0:
            return 0.0
        return float(torch.maximum(self.ad_r.max(), self.dp_r.max()))

    def pack(self, clip=False):
        """PackedCounts (two cells a byte) on this device, each matrix
        written from its CSR form (`_csr_pair`, `_place_packed`). Every
        count must be <= PACK_MAX unless `clip` saturates it there
        (vireo_tpu/ops/counts.py:280-288)."""
        return PackedCounts(*(_place_packed(X, self.shape, self.device, clip)
                              for X in _csr_pair(self)), self.shape)

    def densify(self, dtype=None, check_overflow=True):
        """Dense (n_var, n_cell) DenseCounts scattered on the device.

        `dtype` defaults to the smallest type that holds every count
        exactly (`exact_count_dtype`). With `check_overflow`, an int8 or
        bfloat16 `dtype` too narrow for the largest count is promoted,
        with the JAX package's note, instead of truncating."""
        vmax = self.max_count()
        if dtype is None:
            dtype = exact_count_dtype(vmax)
        elif check_overflow and dtype in (torch.int8, torch.bfloat16):
            promoted = exact_count_dtype(vmax)
            if (dtype == torch.int8 and vmax > 127) or \
                    (dtype == torch.bfloat16 and vmax > 256):
                print("[vireo] counts up to %.0f exceed the exact range "
                      "of %s; using %s" % (vmax, str(dtype)[6:],
                                           str(promoted)[6:]))
                dtype = promoted
        flat = self.rows_r.long() * self.n_cell + self.cols_r.long()

        def scatter(vals):
            out = torch.zeros(self.shape, dtype=dtype, device=self.device)
            out.view(-1)[flat] = vals.to(dtype)
            return out

        return DenseCounts(scatter(self.ad_r), scatter(self.dp_r))

    def var_subset(self, idx):
        """The variant rows `idx` as a SparseCounts, filtered on the host.
        The JAX package densifies the whole COO pool before it subsets
        (vireo_tpu/models/ambient.py:203-205); the port subsets first,
        since this rung holds pools whose dense layout does not fit the
        card. The kept triplets, and so every sum, are the same."""
        idx = _row_index(idx, "cpu").numpy()
        pos = np.full(self.n_var, -1, np.int64)
        pos[idx] = np.arange(len(idx))
        rows = pos[self.rows_r.cpu().numpy()]
        keep = rows >= 0
        return _sparse_from_triplets(
            rows[keep], self.cols_r.cpu().numpy()[keep],
            self.ad_r.cpu().numpy()[keep], self.dp_r.cpu().numpy()[keep],
            (len(idx), self.n_cell), self.device)


def _sparse_from_triplets(rows, cols, ad_vals, dp_vals, shape, device):
    """SparseCounts on `device` from host COO triplets with unique
    (row, col) pairs. Unlike the JAX package, nnz is not padded: eager
    PyTorch keeps no compiled program whose shape it would fix."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    ad_vals = np.asarray(ad_vals)
    dp_vals = np.asarray(dp_vals)

    def put(order):
        return [torch.from_numpy(np.ascontiguousarray(x[order].astype(t)))
                .to(device) for x, t in ((rows, np.int32), (cols, np.int32),
                                         (ad_vals, np.float32),
                                         (dp_vals, np.float32))]

    return SparseCounts(*put(np.lexsort((cols, rows))),
                        *put(np.lexsort((rows, cols))),
                        (int(shape[0]), int(shape[1])))


def sparse_counts(AD, DP, device=None):
    """SparseCounts over the union nonzero pattern of AD and DP, on
    `device` (default: utils/device.py's)."""
    device = resolve_device(device)
    rows, cols, ad_v, dp_v = _host_union_triplets(AD, DP)
    return _sparse_from_triplets(rows, cols, ad_v, dp_v,
                                 (int(AD.shape[0]), int(AD.shape[1])), device)


@dataclasses.dataclass(frozen=True)
class HybridCounts:
    """A base layout clipped at `cap` plus a COO residual of the deltas
    above it (vireo_tpu/ops/counts.py::HybridCounts).

    Counts split linearly, X = min(X, cap) + max(X - cap, 0), so every
    linear contraction is the base's plus the residual's. The base is an
    int8 DenseCounts (cap 127) or a PackedCounts (cap 15). The one
    non-linear reduction, sum log C(DP, AD), adds `binom_corr`, a
    float64 correction computed once from the true values of the
    overflow entries.
    """
    base: object              # DenseCounts (int8) or PackedCounts
    resid: SparseCounts       # the deltas above the cap
    binom_corr: torch.Tensor  # 0-d float64
    cap: int

    @property
    def n_var(self):
        return self.base.n_var

    @property
    def n_cell(self):
        return self.base.n_cell

    @property
    def device(self):
        return self.base.device

    @property
    def resid_nnz(self):
        return self.resid.nnz

    def suff_stats(self, W):
        with span("suff_stats"):
            b1, b2 = self.base.suff_stats(W)
            r1, r2 = self.resid.suff_stats(W)
            return b1 + r1, b2 + r2

    def cell_loglik(self, Wa, Wd):
        with span("cell_loglik"):
            return (self.base.cell_loglik(Wa, Wd)
                    + self.resid.cell_loglik(Wa, Wd))

    def binom_coeff_sum(self):
        with span("binom"):
            return self.base.binom_coeff_sum() + self.binom_corr

    def row_sums(self):
        ba, bd = self.base.row_sums()
        ra, rd = self.resid.row_sums()
        return ba + ra, bd + rd

    def n_vars_per_cell(self):
        # clipping keeps the DP > 0 pattern (cap >= 1)
        return self.base.n_vars_per_cell()

    def densify(self):
        """The exact dense counts, base plus residual.

        JAX's `densify` returns float32 (vireo_tpu/ops/counts.py:384).
        The port returns the smallest type that holds the true counts
        exactly (int8 up to 127; `exact_count_dtype`): its one caller,
        the ambient phase, reads the selected variants' block in cell
        chunks and converts each to float, so a float32 copy would only
        quadruple the block's memory. The sums are the same
        (tests/test_torch_counts.py)."""
        r = self.resid
        vmax = self.cap + r.max_count() if r.nnz else self.cap
        dtype = exact_count_dtype(vmax)
        b = self.base.densify()
        flat = r.rows_r.long() * self.n_cell + r.cols_r.long()

        def add_resid(x, vals):
            out = x.to(dtype, copy=True)     # never the base's storage
            out.view(-1)[flat] += vals.to(dtype)
            return out

        return DenseCounts(add_resid(b.ad, r.ad_r), add_resid(b.dp, r.dp_r))

    def var_subset(self, idx):
        """The variant rows `idx` without densifying the whole pool: the
        base subsets on the device, the residual is filtered on the host,
        and `binom_corr` is recomputed from the kept entries (true value =
        base value + delta), as vireo_tpu/ops/counts.py:399-438 does."""
        idx = _row_index(idx, "cpu").numpy()
        base = self.base.var_subset(idx)
        r = self.resid
        pos = np.full(self.n_var, -1, np.int64)
        pos[idx] = np.arange(len(idx))
        rows = pos[r.rows_r.cpu().numpy()]
        keep = rows >= 0
        new_rows, new_cols = rows[keep], r.cols_r.cpu().numpy()[keep]
        da = r.ad_r.cpu().numpy()[keep].astype(np.float64)
        dd = r.dp_r.cpu().numpy()[keep].astype(np.float64)

        bd = base.densify()
        at = (torch.as_tensor(new_rows, device=self.device),
              torch.as_tensor(new_cols, device=self.device))
        ba = bd.ad[at].cpu().numpy().astype(np.float64)
        bb = bd.dp[at].cpu().numpy().astype(np.float64)
        corr = float(np.sum(_np_log_binom_coeff(bb + dd, ba + da))
                     - np.sum(_np_log_binom_coeff(bb, ba)))
        resid = _sparse_from_triplets(new_rows, new_cols, da, dd,
                                      (len(idx), self.n_cell), self.device)
        return HybridCounts(base, resid,
                            torch.tensor(corr, dtype=torch.float64,
                                         device=self.device), self.cap)

    def cell_slice(self, start, stop):
        """Cells [start, stop) without densifying the pool
        (vireo_tpu/ops/counts.py:440-470): the base slices on the device
        (a packed base unpacks only the slice's bytes, as int8), the
        residual is filtered on the host and `binom_corr` recomputed from
        the kept entries."""
        start, stop = int(start), int(stop)
        base = self.base.cell_slice(start, stop)
        r = self.resid
        rows, cols = r.rows_r.cpu().numpy(), r.cols_r.cpu().numpy()
        keep = (cols >= start) & (cols < stop)
        new_rows, new_cols = rows[keep], cols[keep] - start
        da = r.ad_r.cpu().numpy()[keep].astype(np.float64)
        dd = r.dp_r.cpu().numpy()[keep].astype(np.float64)
        at = (torch.as_tensor(new_rows, device=self.device).long(),
              torch.as_tensor(new_cols, device=self.device).long())
        ba = base.ad[at].cpu().numpy().astype(np.float64)
        bb = base.dp[at].cpu().numpy().astype(np.float64)
        corr = float(np.sum(_np_log_binom_coeff(bb + dd, ba + da))
                     - np.sum(_np_log_binom_coeff(bb, ba)))
        resid = _sparse_from_triplets(new_rows, new_cols, da, dd,
                                      (self.n_var, base.n_cell), self.device)
        return HybridCounts(base, resid,
                            torch.tensor(corr, dtype=torch.float64,
                                         device=self.device), self.cap)


Counts = (DenseCounts, SparseCounts, HybridCounts)


def _np_log_binom_coeff(dp, ad, max_val=700.0):
    """Host float64 log C(dp, ad), with ops.math.log_binom_coeff's 700
    clip and 0 where dp == 0."""
    from scipy.special import gammaln
    dp = np.asarray(dp, np.float64)
    ad = np.asarray(ad, np.float64)
    val = gammaln(dp + 1.0) - gammaln(ad + 1.0) - gammaln(dp - ad + 1.0)
    val = np.minimum(val, max_val)
    return np.where(dp > 0, val, 0.0)


def _over_cap(AD, DP, cap):
    """Aligned host triplets (`_host_union_triplets`) of the entries
    where compressed AD or DP exceeds `cap`, with their true values:
    both matrices are restricted to that pattern before they are
    aligned, so the union spans the residual and not the pool."""
    over = (AD > cap) + (DP > cap)
    return _host_union_triplets(AD.multiply(over), DP.multiply(over))


def _union_nnz(AD, DP):
    """Entries in the union of the stored patterns of two compressed
    matrices, explicit zeros included: the length of
    `_host_union_triplets`' arrays."""
    def stored(X):
        return type(X)((np.ones(X.nnz, bool), X.indices, X.indptr),
                       shape=X.shape)
    return (stored(AD) + stored(DP)).nnz


def _hybrid(AD, DP, over, shape, cap, kind, device):
    """HybridCounts on `device` of compressed AD and DP: the base each
    matrix on its own, clipped at `cap` (an "int8" base, cap 127, by
    `_place_dense`; a "packed" base, cap 15, by `_place_packed`), and
    the residual and `binom_corr` from `over`, the over-cap entries'
    triplets (`_over_cap`)."""
    rows, cols, ad_v, dp_v = over
    at = np.asarray(ad_v, np.float64)
    dt = np.asarray(dp_v, np.float64)
    corr = float(np.sum(_np_log_binom_coeff(dt, at))
                 - np.sum(_np_log_binom_coeff(np.minimum(dt, cap),
                                              np.minimum(at, cap))))
    n_over = len(at)
    # the share of the union of the patterns, which holds either matrix
    if n_over > 0.1 * max(AD.nnz, DP.nnz, 1):
        total = _union_nnz(AD, DP)
        if n_over > 0.1 * total:
            print("[vireo] warning: %.0f%% of counts exceed the %s cap %d "
                  "- the hybrid residual is unusually large and per-"
                  "iteration cost grows with it"
                  % (100 * n_over / total, kind, cap))
    resid = _sparse_from_triplets(rows, cols, np.maximum(at - cap, 0.0),
                                  np.maximum(dt - cap, 0.0), shape, device)
    if kind == "int8":
        base = DenseCounts(*(_place_dense(X, shape, torch.int8, device)
                             for X in (AD, DP)))
    elif kind == "packed":
        base = PackedCounts(*(_place_packed(X, shape, device, clip=True)
                              for X in (AD, DP)), shape)
    else:
        raise ValueError("unknown hybrid base kind %r" % (kind,))
    return HybridCounts(base, resid, torch.tensor(corr, dtype=torch.float64,
                                                  device=device), int(cap))


def hybrid_from_coo(coo, cap, kind):
    """HybridCounts from a SparseCounts' full-precision triplets, on its
    device: `kind` "int8" (cap 127) or "packed" (cap 15)."""
    AD, DP = _csr_pair(coo)
    return _hybrid(AD, DP, _over_cap(AD, DP, cap), coo.shape, cap, kind,
                   coo.device)


def dense_counts(AD, DP, dtype=torch.float32, device=None):
    """DenseCounts of numpy or scipy AD/DP in `dtype`, on `device`
    (default: utils/device.py's)."""
    device = resolve_device(device)

    def put(X):
        X = X.toarray() if hasattr(X, "toarray") else np.asarray(X)
        return torch.as_tensor(X).to(device=device, dtype=dtype)

    return DenseCounts(put(AD), put(DP))


def _dense_bytes(shape, vmax):
    """Bytes of the two dense matrices in `exact_count_dtype(vmax)`."""
    itemsize = torch.empty((), dtype=exact_count_dtype(vmax)).element_size()
    return 2 * shape[0] * shape[1] * itemsize


def ladder_rung(shape, vmax, budget, packed_budget=None):
    """The rung `counts_from_scipy` places a (n_var, n_cell) pool with
    largest count `vmax` on, under a budget of `budget` bytes
    (`packed_budget` for the packed rungs, default the same), in the
    order of vireo_tpu/ops/counts.py:1533-1614:

    - "dense": both matrices in `exact_count_dtype(vmax)` fit;
    - "int8-hybrid": vmax > 127 and two int8 matrices fit;
    - "packed": vmax <= 15 and two packed matrices fit (n_var * n_cell
      bytes, as the JAX package counts them);
    - "packed-hybrid": vmax > 15 and two packed matrices fit;
    - "coo": nothing else fits.

    VIREO_NO_HYBRID=1 skips both hybrid rungs and VIREO_NO_PACKED=1 both
    packed ones.
    """
    if packed_budget is None:
        packed_budget = budget
    n_elems = int(shape[0]) * int(shape[1])
    if _dense_bytes(shape, vmax) <= budget:
        return "dense"
    no_hybrid = os.environ.get("VIREO_NO_HYBRID", "0") == "1"
    packed_ok = os.environ.get("VIREO_NO_PACKED", "0") != "1"
    if vmax > 127 and 2 * n_elems <= budget and not no_hybrid:
        return "int8-hybrid"
    if vmax <= PACK_MAX and n_elems <= packed_budget and packed_ok:
        return "packed"
    if vmax > PACK_MAX and n_elems <= packed_budget and packed_ok \
            and not no_hybrid:
        return "packed-hybrid"
    return "coo"


def _shard_factor(mesh):
    """Number of ranks a mesh splits the dense layouts over (the extents
    count_spec uses: vars x cells): the dense ladder's budget aggregates
    over them (vireo_tpu/ops/counts.py:1424-1437)."""
    return 1 if mesh is None else mesh.size


def _cell_axis_of(mesh):
    """The axis a mesh splits cells along (None without a mesh)."""
    from ..parallel.mesh import CELL_AXIS
    return None if mesh is None or not mesh.has(CELL_AXIS) else CELL_AXIS


def _packed_shard_factor(mesh):
    """Number of ways the packed rungs' budget aggregates: the cell
    extent only, as vireo_tpu/ops/counts.py:1462-1474 counts it (its
    packed layout is 1-D over cells). The port's packed blocks split the
    variants too on a vars axis, so this sizing is on the safe side."""
    return 1 if mesh is None else mesh.extent(_cell_axis_of(mesh))


def _rung_ways(rung, shape, vmax, mesh):
    """(bytes, ways): what `ladder_rung` charges `rung` against its
    budget, and the number of ranks of `mesh` that share those bytes."""
    n_elems = int(shape[0]) * int(shape[1])
    if rung == "dense":
        return _dense_bytes(shape, vmax), _shard_factor(mesh)
    if rung == "int8-hybrid":
        return 2 * n_elems, _shard_factor(mesh)
    if rung in ("packed", "packed-hybrid"):
        return n_elems, _packed_shard_factor(mesh)
    return 0, 1


def placement_rung(shape, vmax, device=None, dense_budget=None, mesh=None,
                   verbose=False):
    """(rung, dense budget): the rung `counts_from_scipy` places a
    (n_var, n_cell) pool with largest count `vmax` on.

    `ladder_rung` picks it under `dense_budget` bytes, or by default
    under `device_dense_budget`, which reads the card's total memory and
    not what the process already holds (on a mesh, the smallest rank's
    budget times the ranks that share each layout). The default then
    holds the rung to `device_room`: where a rank's share of the rung's
    bytes exceeds it, the rung is picked again under 55% of that room
    (the smallest rank's), so a pool never fails to place where a lower
    rung fits. An explicit `dense_budget` or VIREO_DENSE_BUDGET_GB is
    taken as it is."""
    if mesh is not None:
        # the smallest rank's figures, so that every rank picks one rung
        from ..parallel.mesh import world_min
    if dense_budget is not None:
        budget = packed_budget = dense_budget
    elif mesh is None:
        budget = packed_budget = device_dense_budget(device)
    else:
        least = world_min(device_dense_budget(device))
        budget = least * _shard_factor(mesh)
        packed_budget = least * _packed_shard_factor(mesh)
    rung = ladder_rung(shape, vmax, budget, packed_budget)
    if dense_budget is not None or os.environ.get("VIREO_DENSE_BUDGET_GB"):
        return rung, budget
    room = device_room(device)
    if room is None:
        return rung, budget
    if mesh is not None:
        room = world_min(room)
    need, ways = _rung_ways(rung, shape, vmax, mesh)
    if need <= room * ways:
        return rung, budget
    budget = 0.55 * room * _shard_factor(mesh)
    again = ladder_rung(shape, vmax, budget,
                        0.55 * room * _packed_shard_factor(mesh))
    if verbose and (mesh is None or mesh.is_root):
        print("[vireo] the %s rung needs %.1f GiB a rank, and the card "
              "can still give %.1f GiB: the %s rung, picked under %.1f "
              "GiB" % (rung, need / ways / 2**30, room / 2**30, again,
                       0.55 * room / 2**30))
    return again, budget


# the hybrid rungs' caps and base layouts
_HYBRIDS = {"int8-hybrid": (127, "int8"),
            "packed-hybrid": (PACK_MAX, "packed")}


def _place_rung(rung, AD, DP, shape, vmax, device):
    """The counts object of `rung` for a (V, C) block of compressed AD
    and DP (`_compressed`, or the blocks `_cut_block` cuts from them),
    each matrix placed on its own by the writer of its layout: the dense
    rung in `exact_count_dtype(vmax)` by `_place_dense`, the packed rung
    by `_place_packed`, the hybrids' bases by either, clipped. Only what
    holds AD and DP on one pattern aligns them (`_host_union_triplets`):
    a hybrid's residual, from its over-cap entries (`_over_cap`), and
    the COO rung, from the whole block."""
    if rung in _HYBRIDS:
        cap, kind = _HYBRIDS[rung]
        with span("place.union"):
            over = _over_cap(AD, DP, cap)
        with span("place.upload"):
            return _hybrid(AD, DP, over, shape, cap, kind, device)
    if rung == "coo":
        with span("place.union"):
            triplets = _host_union_triplets(AD, DP)
        with span("place.upload"):
            return _sparse_from_triplets(*triplets, shape, device)
    with span("place.upload"):
        if rung == "packed":
            return PackedCounts(*(_place_packed(X, shape, device)
                                  for X in (AD, DP)), shape)
        dtype = exact_count_dtype(vmax)
        return DenseCounts(*(_place_dense(X, shape, dtype, device)
                             for X in (AD, DP)))


def _value_range(*mats):
    """(smallest, largest) stored value of scipy/numpy count matrices
    (0 included)."""
    import scipy.sparse as sp
    lo = hi = 0.0
    for X in mats:
        data = X.data if sp.issparse(X) else np.asarray(X)
        if data.size:
            lo, hi = min(lo, float(data.min())), max(hi, float(data.max()))
    return lo, hi


def _cut_block(X, var_range, cell_range):
    """The (variant range, cell range) block of X as scipy CSC, in block
    coordinates: a range past X's edge (a mesh's padded cells) is cut
    short."""
    import scipy.sparse as sp
    (v0, v1), (c0, c1) = var_range, cell_range
    X = X.tocsc() if sp.issparse(X) else sp.csc_matrix(np.asarray(X))
    return X[:, c0:c1][v0:v1]


def _mesh_counts(rung, AD, DP, shape, vmax, mesh, device):
    """This rank's block of `rung` as a ShardedCounts: the packed rungs
    on the packed cell grid of vireo_tpu/ops/packed.py:616-620 (the
    model keeps the pool's n_cell; the grid's extra cells are zero),
    the others on equal ranges of cells, the pool padded with zero-count
    cells to a multiple of the cell shards: the rung placed from each
    matrix's block (`_place_rung`), so a rank reads only its share of
    the pool."""
    from ..parallel.mesh import Layout, ShardedCounts, CELL_AXIS
    from .packed import MeshPackedCounts, packed_cell_block
    V, C = shape
    S = mesh.extent(CELL_AXIS)
    if rung in ("packed", "packed-hybrid"):
        lay = Layout.even(mesh, (V, C), cell_block=packed_cell_block(C, S))
        stored = packed_cell_block(C, S)
    else:
        lay = Layout.even(mesh, (V, S * -(-C // S)))
        stored = lay.n_cell_local
    cells = (lay.cells[0], lay.cells[0] + stored)
    local_shape = (lay.n_var_local, stored)
    local = _place_rung(rung, *(_cut_block(X, lay.vars, cells)
                                for X in (AD, DP)), local_shape, vmax, device)
    cls = MeshPackedCounts if rung == "packed" else ShardedCounts
    return cls(local, lay)


def counts_from_scipy(AD, DP, device=None, dense_budget=None, verbose=False,
                      mesh=None):
    """Place a scipy/numpy AD-DP pair on `device` (default:
    utils/device.py's) on the rung that `placement_rung` picks: the one
    `ladder_rung` picks under `dense_budget` bytes (default
    `device_dense_budget(device)`, held to what the card can still
    give).

    The dense rung holds the counts in `exact_count_dtype` of their
    largest value, at every size (the JAX package keeps pools of at most
    64M elements in the caller's float type instead; int8 converts to
    float exactly, so the contractions give the same numbers, and the
    fused doublet E-step then sees int8 counts at every size).

    With a `mesh` (parallel/mesh.py), every rank passes the whole pool;
    the rung is one for all ranks, picked from the global shape and
    largest count under the budget the mesh spans: an explicit
    `dense_budget` is the total, the default is the smallest rank's
    budget times the mesh's size for the dense rungs and times its cell
    extent for the packed ones (vireo_tpu/ops/counts.py:1521-1532).
    Each rank places its block on the mesh's device and gets a
    ShardedCounts (MeshPackedCounts on the packed rung); its n_cell is
    the pool's, rounded up to the cell shards except on the packed
    rungs.
    """
    if mesh is not None:
        device = mesh.device if device is None else device
    with span("place.rung"):
        AD, DP = _compressed(AD), _compressed(DP)
        if AD.shape != DP.shape:
            raise ValueError("AD and DP shapes differ: %s vs %s"
                             % (AD.shape, DP.shape))
        vmin, vmax = _value_range(AD, DP)
        device = resolve_device(device)
        if vmin < 0:
            raise ValueError("counts must be non-negative")
        shape = (int(AD.shape[0]), int(AD.shape[1]))
        rung, budget = placement_rung(shape, vmax, device, dense_budget,
                                      mesh, verbose)
    if verbose and (mesh is None or mesh.is_root):
        what = {
            "dense": "densified as %s (%.1f GiB)" % (
                str(exact_count_dtype(vmax)).replace("torch.", ""),
                _dense_bytes(shape, vmax) / 2**30),
            "int8-hybrid": "split into int8 base + overflow residual "
                           "(%.1f GiB)" % (2 * shape[0] * shape[1] / 2**30),
            "packed": "packed 2-per-byte (%.1f GiB)"
                      % (shape[0] * shape[1] / 2**30),
            "packed-hybrid": "split into packed nibble base + overflow "
                             "residual (%.1f GiB)"
                             % (shape[0] * shape[1] / 2**30),
            "coo": "too large for a dense layout (%.1f GiB > budget %.1f "
                   "GiB); using COO segment sums"
                   % (_dense_bytes(shape, vmax) / 2**30, budget / 2**30),
        }[rung]
        print("[vireo] %dx%d counts (max %.0f) on %s: %s%s"
              % (shape[0], shape[1], vmax, device, what,
                 "" if mesh is None else ", split over %d ranks (mesh %s)"
                 % (mesh.size, mesh.shape)))
    if mesh is not None:
        # each rank reads only its block
        return _mesh_counts(rung, AD, DP, shape, vmax, mesh, device)
    return _place_rung(rung, AD, DP, shape, vmax, device)
