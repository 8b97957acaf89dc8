"""4-bit nibble-packed dense counts, the capacity rung of the ladder
(counterpart of vireo_tpu/ops/packed.py::PackedCounts).

When every AD/DP value is <= 15 (`PACK_MAX`), two cells fit in one
byte: the packed layout holds a pool in half the device memory of dense
int8, so a card holds pools twice as large without falling back to the
COO rung.

Layout, as in the JAX package (vireo_tpu/ops/packed.py:16-20 and
`pack_nibbles`): `ad_p` and `dp_p` are (n_var, ceil(n_cell / 2)) uint8,
and byte [v, j] holds cell 2j in its low nibble and cell 2j + 1 in its
high nibble. There is no padding to a block grid; when n_cell is odd
the high nibble of each row's last byte is zero, and the kernels mask
it.

The two contractions are the port's K2 and K3:

- `suff_stats`  (K2): S1 = AD @ W, SS = DP @ W
- `cell_loglik` (K3): AD.T @ Wa + DP.T @ Wd

For tensors on a card each launches its CUDA kernel
(csrc/packed_counts.cu, float32 weights only) or raises. Both run on
the tensor cores on the three bf16 terms of each weight matrix that
`split_bf16x3` gives, which sum to it exactly, so they form the same
products as the plain versions; `split_weights_kmajor` writes those
terms as the kernels' B operand. For tensors on the CPU each runs its
plain version (`suff_stats_reference`,
`cell_loglik_reference`), which unpacks a block of rows to the weights'
type and calls `torch.matmul` on `lo @ W[0::2] + hi @ W[1::2]`; on the
CPU that is float64, so the port's CPU runs stay exact. `LAUNCHES`
counts each kernel's launches.

The reductions, `densify`, `var_subset` and `cell_slice` are plain
PyTorch (the reductions over blocks of rows).

On a mesh, `MeshPackedCounts` is a rank's PackedCounts block behind
`parallel.mesh.ShardedCounts`: K2 and K3 run on each rank's block and
their results are all-reduced (`pack_scipy_sharded`).
"""

import ctypes
import dataclasses

import torch

from ._launch import launch, on_cpu
from .math import log_binom_coeff
from ..parallel.mesh import ShardedCounts

__all__ = ["PACK_MAX", "PackedCounts", "pack_dense", "packed_suff_stats",
           "packed_cell_loglik", "suff_stats_reference",
           "cell_loglik_reference", "split_bf16x3", "split_weights_kmajor",
           "LAUNCHES", "MeshPackedCounts", "pack_scipy_sharded",
           "packed_cell_block", "pack_nibbles"]

PACK_MAX = 15  # the largest count a nibble holds exactly

# launches of each CUDA kernel (K2, K3)
LAUNCHES = {"suff_stats": 0, "cell_loglik": 0}

# bytes of one unpacked float block of rows (per plane)
_CHUNK_BYTES = 1 << 28

_LIB = None


def _unpack(p, dtype):
    """(lo, hi) nibble planes of packed bytes `p`, in `dtype`."""
    return (p & 0xF).to(dtype), (p >> 4).to(dtype)


def _row_blocks(n_var, n_byte, itemsize):
    rows = max(_CHUNK_BYTES // max(n_byte * itemsize, 1), 1)
    for r0 in range(0, n_var, rows):
        yield r0, min(r0 + rows, n_var)


def suff_stats_reference(ad_p, dp_p, n_cell, W):
    """Plain version of K2: (AD @ W, DP @ W) for W (n_cell, N), in W's
    type, one block of unpacked rows at a time."""
    V, Cb = ad_p.shape
    n_odd = n_cell // 2
    w_even, w_odd = W[0::2].contiguous(), W[1::2].contiguous()
    S1 = torch.empty((V, W.shape[1]), dtype=W.dtype, device=W.device)
    SS = torch.empty_like(S1)
    for r0, r1 in _row_blocks(V, Cb, W.element_size()):
        for p, out in ((ad_p, S1), (dp_p, SS)):
            lo, hi = _unpack(p[r0:r1], W.dtype)
            torch.matmul(lo, w_even, out=out[r0:r1])
            out[r0:r1].addmm_(hi[:, :n_odd], w_odd)
    return S1, SS


def cell_loglik_reference(ad_p, dp_p, n_cell, Wa, Wd):
    """Plain version of K3: AD.T @ Wa + DP.T @ Wd for (n_var, N)
    weights -> (n_cell, N) in cell order, in the weights' type."""
    V, Cb = ad_p.shape
    N = Wa.shape[1]
    even = torch.zeros((Cb, N), dtype=Wa.dtype, device=Wa.device)
    odd = torch.zeros_like(even)
    for r0, r1 in _row_blocks(V, Cb, Wa.element_size()):
        for p, w in ((ad_p, Wa), (dp_p, Wd)):
            lo, hi = _unpack(p[r0:r1], Wa.dtype)
            even.addmm_(lo.t(), w[r0:r1])
            odd.addmm_(hi.t(), w[r0:r1])
    return torch.stack([even, odd], dim=1).reshape(2 * Cb, N)[:n_cell]


def split_bf16x3(W):
    """Three bf16 tensors hi, mid, lo with hi + mid + lo == W exactly for
    float32 W with |W| >= 2^-110 or W == 0: hi is W rounded to bf16, and
    each difference is exact in float32 (the operands lie within a
    factor 2) and has at most 16, then 8, significant bits. Below 2^-110
    the last term falls under bf16's subnormal step 2^-133, so the sum
    is within 2^-134 of W."""
    hi = W.to(torch.bfloat16)
    r = W - hi.to(torch.float32)
    mid = r.to(torch.bfloat16)
    lo = (r - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def split_weights_kmajor(*mats):
    """The kernels' B operand: the three terms of each (K, N) matrix
    (K2: W over the cells; K3: Wa, then Wd, over the variants),
    transposed to (3 x len(mats), N, ld) bf16 with the contracted axis
    contiguous. ld is K rounded up to a whole 16 bytes, the unit of
    TMA's row strides; the kernels read nothing past K, and those
    entries are zero."""
    K, N = mats[0].shape
    b = torch.zeros((3 * len(mats), N, -(-K // 8) * 8),
                    dtype=torch.bfloat16, device=mats[0].device)
    for i, W in enumerate(mats):
        for p, term in enumerate(split_bf16x3(W)):
            b[3 * i + p, :, :K] = term.t()
    return b


def _library():
    global _LIB
    if _LIB is None:
        from ._build import load_library
        lib = load_library("packed_counts")
        ptr = ctypes.c_void_p
        lib.vireo_packed_suff_stats.argtypes = [ptr] * 5 + [
            ctypes.c_int] * 4 + [ptr]
        lib.vireo_packed_suff_stats.restype = ctypes.c_int
        lib.vireo_packed_cell_loglik.argtypes = [ptr] * 4 + [
            ctypes.c_int] * 4 + [ptr]
        lib.vireo_packed_cell_loglik.restype = ctypes.c_int
        lib.vireo_packed_error_string.argtypes = [ctypes.c_int]
        lib.vireo_packed_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check_launch(name, ad_p, dp_p, n_cell, weights, rows):
    """Validate what the kernels take: uint8 packed counts of n_cell
    cells and float32 weights of `rows` rows and one width, all on one
    device; returns the contiguous operands."""
    V, Cb = ad_p.shape
    if ad_p.dtype != torch.uint8 or dp_p.dtype != torch.uint8:
        raise TypeError("%s reads uint8 packed counts, got %s/%s"
                        % (name, ad_p.dtype, dp_p.dtype))
    if dp_p.shape != ad_p.shape or Cb != (n_cell + 1) // 2:
        raise ValueError("%s: packed shapes %s/%s do not hold %d cells"
                         % (name, tuple(ad_p.shape), tuple(dp_p.shape),
                            n_cell))
    if V == 0 or n_cell == 0:
        raise ValueError("%s: empty counts (%d x %d)" % (name, V, n_cell))
    for w in weights:
        if w.dtype != torch.float32:
            raise TypeError("%s takes float32 weights, got %s"
                            % (name, w.dtype))
        if w.device != ad_p.device or dp_p.device != ad_p.device:
            raise ValueError("%s: operands on %s, %s and %s"
                             % (name, ad_p.device, dp_p.device, w.device))
        if w.dim() != 2 or w.shape != (rows, weights[0].shape[-1]):
            raise ValueError("%s: weights of shape %s, not (%d, N)"
                             % (name, tuple(w.shape), rows))
    return (ad_p.contiguous(), dp_p.contiguous(),
            [w.contiguous() for w in weights])


def _run(name, fn, args, device):
    launch(name, fn, args, device, _library().vireo_packed_error_string)
    LAUNCHES[name] += 1


def packed_suff_stats(ad_p, dp_p, n_cell, W):
    """K2: (AD @ W, DP @ W) -> two (n_var, N). CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise."""
    if on_cpu("suff_stats", ad_p):
        return suff_stats_reference(ad_p, dp_p, n_cell, W)
    ad_p, dp_p, (W,) = _check_launch("suff_stats", ad_p, dp_p, n_cell, [W],
                                     n_cell)
    V, N = ad_p.shape[0], W.shape[1]
    w3 = split_weights_kmajor(W)
    S1 = torch.empty((V, N), dtype=torch.float32, device=W.device)
    SS = torch.empty_like(S1)
    _run("suff_stats", _library().vireo_packed_suff_stats,
         (ad_p.data_ptr(), dp_p.data_ptr(), w3.data_ptr(), S1.data_ptr(),
          SS.data_ptr(), V, n_cell, N, w3.shape[2]), W.device)
    return S1, SS


def packed_cell_loglik(ad_p, dp_p, n_cell, Wa, Wd):
    """K3: AD.T @ Wa + DP.T @ Wd -> (n_cell, N) in cell order. CPU
    tensors run the plain version; CUDA tensors launch the kernel or
    raise."""
    if on_cpu("cell_loglik", ad_p):
        return cell_loglik_reference(ad_p, dp_p, n_cell, Wa, Wd)
    ad_p, dp_p, (Wa, Wd) = _check_launch("cell_loglik", ad_p, dp_p, n_cell,
                                         [Wa, Wd], ad_p.shape[0])
    V, N = ad_p.shape[0], Wa.shape[1]
    b6 = split_weights_kmajor(Wa, Wd)
    out = torch.empty((n_cell, N), dtype=torch.float32, device=Wa.device)
    _run("cell_loglik", _library().vireo_packed_cell_loglik,
         (ad_p.data_ptr(), dp_p.data_ptr(), b6.data_ptr(), out.data_ptr(),
          V, n_cell, N, b6.shape[2]), Wa.device)
    return out


@dataclasses.dataclass(frozen=True)
class PackedCounts:
    """Nibble-packed AD/DP counts of `shape` (n_var, n_cell), two cells
    a byte."""
    ad_p: torch.Tensor       # (n_var, ceil(n_cell / 2)) uint8
    dp_p: torch.Tensor
    shape: tuple

    @property
    def n_var(self):
        return self.shape[0]

    @property
    def n_cell(self):
        return self.shape[1]

    @property
    def device(self):
        return self.ad_p.device

    def suff_stats(self, W):
        """(AD @ W, DP @ W) for W (n_cell, N) -> two (n_var, N)."""
        return packed_suff_stats(self.ad_p, self.dp_p, self.n_cell, W)

    def cell_loglik(self, Wa, Wd):
        """AD.T @ Wa + DP.T @ Wd for (n_var, N) weights -> (n_cell, N)."""
        return packed_cell_loglik(self.ad_p, self.dp_p, self.n_cell, Wa, Wd)

    def _blocks(self, dtype):
        """(lo, hi) planes of AD and DP, one block of rows at a time."""
        itemsize = torch.empty((), dtype=dtype).element_size()
        for r0, r1 in _row_blocks(self.n_var, self.ad_p.shape[1], itemsize):
            yield (r0, r1, _unpack(self.ad_p[r0:r1], dtype),
                   _unpack(self.dp_p[r0:r1], dtype))

    def binom_coeff_sum(self):
        """Sum of log C(DP, AD) over DP > 0 entries, accumulated in
        float64 (the zero padding nibble adds 0); a 0-d float64 tensor."""
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for _, _, (a_lo, a_hi), (d_lo, d_hi) in self._blocks(torch.float64):
            total += log_binom_coeff(d_lo, a_lo).sum()
            total += log_binom_coeff(d_hi, a_hi).sum()
        return total

    def row_sums(self):
        """(AD.sum(axis=1), DP.sum(axis=1)) -> two exact int64 (n_var,)."""
        ad = torch.empty(self.n_var, dtype=torch.int64, device=self.device)
        dp = torch.empty_like(ad)
        for r0, r1, (a_lo, a_hi), (d_lo, d_hi) in self._blocks(torch.int64):
            ad[r0:r1] = (a_lo + a_hi).sum(dim=1)
            dp[r0:r1] = (d_lo + d_hi).sum(dim=1)
        return ad, dp

    def n_vars_per_cell(self):
        """Number of variants with DP > 0 per cell."""
        Cb = self.dp_p.shape[1]
        even = torch.zeros(Cb, dtype=torch.int64, device=self.device)
        odd = torch.zeros_like(even)
        for _, _, _, (d_lo, d_hi) in self._blocks(torch.uint8):
            even += (d_lo > 0).sum(dim=0)
            odd += (d_hi > 0).sum(dim=0)
        return torch.stack([even, odd], dim=1).reshape(2 * Cb)[:self.n_cell]

    def densify(self, dtype=torch.int8):
        """Unpack to a DenseCounts (int8 by default; twice the memory)."""
        from .counts import DenseCounts

        def full(p):
            lo, hi = _unpack(p, dtype)
            return torch.stack([lo, hi], dim=2).reshape(
                self.n_var, -1)[:, :self.n_cell].contiguous()

        return DenseCounts(full(self.ad_p), full(self.dp_p))

    def var_subset(self, idx):
        """The variant rows `idx` (indices or a boolean mask), still
        packed."""
        from .counts import _row_index
        idx = _row_index(idx, self.device)
        return PackedCounts(self.ad_p[idx], self.dp_p[idx],
                            (int(idx.shape[0]), self.n_cell))

    def cell_slice(self, start, stop):
        """Cells [start, stop) as an int8 DenseCounts, unpacking only the
        bytes that hold them (a whole densify would double the memory the
        packed rung saves; vireo_tpu/ops/packed.py:344-360)."""
        from .counts import DenseCounts
        start, stop = int(start), int(stop)
        b0, b1 = start // 2, -(-stop // 2)
        off = start - 2 * b0

        def part(p):
            lo, hi = _unpack(p[:, b0:b1], torch.int8)
            full = torch.stack([lo, hi], dim=2).reshape(self.n_var, -1)
            return full[:, off:off + max(stop - start, 0)].contiguous()

        return DenseCounts(part(self.ad_p), part(self.dp_p))


def pack_nibbles(x):
    """(V, C) integer counts in [0, 15] -> (V, ceil(C / 2)) uint8 bytes."""
    x = torch.as_tensor(x)
    V, C = x.shape
    if C % 2:
        x = torch.cat([x, x.new_zeros((V, 1))], dim=1)
    x = x.to(torch.uint8)
    return x[:, 0::2] | (x[:, 1::2] << 4)


def pack_dense(ad, dp):
    """PackedCounts from dense (n_var, n_cell) counts (numpy or torch,
    on the tensors' device); every value must lie in [0, PACK_MAX]."""
    ad, dp = torch.as_tensor(ad), torch.as_tensor(dp)
    for name, x in (("AD", ad), ("DP", dp)):
        if x.numel() and (x.min() < 0 or x.max() > PACK_MAX):
            raise ValueError("%s holds counts outside [0, %d]"
                             % (name, PACK_MAX))
    return PackedCounts(pack_nibbles(ad), pack_nibbles(dp),
                        (int(ad.shape[0]), int(ad.shape[1])))


# --------------------------------------------------------------------
# the packed rung on a mesh
# --------------------------------------------------------------------

def packed_cell_block(n_cell, n_shards, block_c=2048):
    """Cells of each rank's packed block: ceil(n_cell / n_shards) rounded
    up to whole kernel blocks of bytes, as
    vireo_tpu/ops/packed.py:616-620 rounds them (two cells a byte,
    blocks of min(block_c, the bytes rounded to 128)). The port's kernels
    mask ragged edges, so the rounding keeps only the JAX package's
    ranges; the grid's extra cells hold zeros."""
    def up(x, m):
        return -(-x // m) * m
    c2 = -(-(-(-int(n_cell) // int(n_shards))) // 2)
    bc = min(block_c, up(max(c2, 1), 128))
    return 2 * up(max(c2, 1), bc)


class MeshPackedCounts(ShardedCounts):
    """The packed rung on a mesh (vireo_tpu/ops/packed.py:432-593): each
    rank holds a PackedCounts block of its cells (of its variants too on
    a vars axis), on the JAX package's cell grid or on the ranges a
    loader gives (`pack_scipy_sharded`). `suff_stats` runs K2 on the
    block and all-reduces the (n_var_local, N) statistics over the
    cells; `cell_loglik` runs K3 on the block (its sums over variants
    all-reduced on a vars axis). The model's n_cell is the pool's; the
    grid's extra cells are zero and never leave the block."""

    @property
    def n_shards(self):
        from ..parallel.mesh import CELL_AXIS
        return self.mesh.extent(CELL_AXIS)

    @property
    def c2_local(self):
        """Bytes of a row of this rank's block (two cells a byte)."""
        return self.local.ad_p.shape[1]

    @property
    def n_cell_pad(self):
        return 2 * self.c2_local * self.n_shards


def pack_scipy_sharded(AD, DP, mesh, axis=None, block_c=2048,
                       cell_range=None, device=None):
    """A MeshPackedCounts of a scipy/numpy AD-DP pair with every count
    <= PACK_MAX (the ladder checks the largest first).

    Without `cell_range`, AD and DP are the whole pool on every rank:
    cells split into the ranges of `packed_cell_block` (the JAX
    package's grid) and each rank packs its range, on the mesh's device.
    With `cell_range`, (lo, hi, c_local, n_cell) from
    `parallel.loader.load_cellSNP_sharded`, AD and DP are this rank's
    columns [lo, hi) of an n_cell pool split into ranges of c_local.
    `axis` names the cell axis (default "cells")."""
    from ..parallel.mesh import Layout, CELL_AXIS
    from .counts import _value_range, _block_union, _pack_triplets
    if axis not in (None, CELL_AXIS):
        raise ValueError("the packed layout splits the cell axis, %r"
                         % (CELL_AXIS,))
    device = mesh.device if device is None else torch.device(device)
    vmin, vmax = _value_range(AD, DP)
    if vmin < 0 or vmax > PACK_MAX:
        raise ValueError("packed counts hold values in [0, %d]" % PACK_MAX)
    V = int(AD.shape[0])
    S = mesh.extent(CELL_AXIS)
    if cell_range is None:
        C = int(AD.shape[1])
        block = packed_cell_block(C, S, block_c)
        lay = Layout.even(mesh, (V, C), cell_block=block)
        c0 = lay.cells[0]
    else:
        lo, hi, block, C = (int(x) for x in cell_range)
        lay = Layout.even(mesh, (V, C), cell_block=block)
        if lay.cells != (lo, hi) or AD.shape[1] != hi - lo:
            raise ValueError("cells [%d, %d) are not this rank's range %s"
                             % (lo, hi, lay.cells))
        c0 = 0
    r, c, a, d = _block_union(AD, DP, lay.vars, (c0, c0 + block))
    local = _pack_triplets(r, c, a, d, (lay.n_var_local, block), device)
    return MeshPackedCounts(local, lay)
