"""Allele-count matrices on the device: the single-device capacity ladder
of vireo_tpu/ops/counts.py.

Every model-side use of the data is one of two contractions:

- ``suff_stats(W)``:       (S1, SS) = (AD @ W, DP @ W)    variant side
- ``cell_loglik(Wa, Wd)``: AD.T @ Wa + DP.T @ Wd          cell side

Four interchangeable classes implement them, and `counts_from_scipy`
picks one by the pool's size and largest count (`ladder_rung`):

- ``DenseCounts``: AD and DP dense, (n_var, n_cell), in the smallest
  type that holds every count exactly (`exact_count_dtype`): int8 up to
  127, which is what real pools give. PyTorch has no int8 x float
  matmul, so the contractions convert the counts to the weights' type
  one block of variant rows at a time and hand each block to
  `torch.matmul`. The conversion is exact, so the result equals a
  product with the whole matrix converted, up to the order of the float
  sums; a whole-matrix conversion would instead cost a 12 GB float32
  copy per matrix per call at 30k variants x 100k cells.
- ``PackedCounts`` (ops/packed.py): two cells a byte when every count is
  <= 15, with the CUDA kernels K2 and K3.
- ``HybridCounts``: an int8 or packed base clipped at its cap plus a COO
  residual of the few deltas above it.
- ``SparseCounts``: COO triplets, gathered and summed in a fixed order
  (`index_put_(accumulate=True)`).
"""

import dataclasses
import os

import numpy as np
import torch

from ..utils.device import resolve_device
from .math import log_binom_coeff
from .packed import PACK_MAX, PackedCounts

__all__ = ["DenseCounts", "SparseCounts", "HybridCounts",
           "counts_from_scipy", "sparse_counts", "hybrid_from_coo",
           "ladder_rung", "exact_count_dtype", "device_dense_budget"]

# bytes of one converted block of count rows
_CHUNK_BYTES = 1 << 29


@dataclasses.dataclass(frozen=True)
class DenseCounts:
    """Dense AD/DP counts of shape (n_var, n_cell).

    `row_chunk` fixes the number of variant rows converted per block;
    None sizes blocks to about 512 MB of the target type.
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

    def _chunks(self, dtype):
        rows = self.row_chunk
        if rows is None:
            itemsize = torch.empty((), dtype=dtype).element_size()
            rows = _CHUNK_BYTES // max(self.n_cell * itemsize, 1)
        rows = max(int(rows), 1)
        for r0 in range(0, self.n_var, rows):
            r1 = min(r0 + rows, self.n_var)
            yield r0, r1, self.ad[r0:r1].to(dtype), self.dp[r0:r1].to(dtype)

    def suff_stats(self, W):
        """(AD @ W, DP @ W) for W of shape (n_cell, N) -> two (n_var, N)."""
        S1 = torch.empty((self.n_var, W.shape[1]), dtype=W.dtype,
                         device=W.device)
        SS = torch.empty_like(S1)
        for r0, r1, a, d in self._chunks(W.dtype):
            torch.matmul(a, W, out=S1[r0:r1])
            torch.matmul(d, W, out=SS[r0:r1])
        return S1, SS

    def cell_loglik(self, Wa, Wd):
        """AD.T @ Wa + DP.T @ Wd for (n_var, N) weights -> (n_cell, N)."""
        out = torch.zeros((self.n_cell, Wa.shape[1]), dtype=Wa.dtype,
                          device=Wa.device)
        for r0, r1, a, d in self._chunks(Wa.dtype):
            out.addmm_(a.t(), Wa[r0:r1])
            out.addmm_(d.t(), Wd[r0:r1])
        return out

    def binom_coeff_sum(self):
        """Sum of log C(DP, AD) over DP > 0 entries, accumulated in
        float64 one block of rows at a time; a 0-d float64 tensor."""
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for _, _, a, d in self._chunks(torch.float64):
            total += log_binom_coeff(d, a).sum()
        return total

    def row_sums(self):
        """(AD.sum(axis=1), DP.sum(axis=1)) -> two (n_var,)."""
        return self.ad.sum(dim=1), self.dp.sum(dim=1)

    def n_vars_per_cell(self):
        """Number of variants with DP > 0 per cell."""
        return (self.dp > 0).sum(dim=0)


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
    else 55% of the card's free memory (`torch.cuda.mem_get_info`),
    leaving room for posteriors and converted blocks; 16 GiB on the
    CPU. `device` defaults to utils/device.py's."""
    env = os.environ.get("VIREO_DENSE_BUDGET_GB")
    if env:
        return float(env) * 2**30
    device = resolve_device(device)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return 0.55 * free
    return 16 * 2**30


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


def _scatter_dense(rows, cols, vals, shape, dtype, device):
    """Dense (V, C) tensor of `dtype` on `device` from host triplets.

    Indices go up as int32 and values in the smallest exact type (int8
    for int8 targets, float32 otherwise), in blocks; each block is
    scattered into a zero matrix on the device. Values above 127 are
    clipped to 127 for an int8 target (the hybrid base), as the JAX
    package's int8 scatter clips them.
    """
    V, C = shape
    out = torch.zeros((V, C), dtype=dtype, device=device)
    flat = out.view(-1)
    vals = np.asarray(vals)
    if dtype == torch.int8:
        vals = np.minimum(vals, 127)
    send = np.int8 if dtype == torch.int8 else np.float32
    for lo in range(0, len(rows), _SCATTER_BLOCK):
        hi = min(lo + _SCATTER_BLOCK, len(rows))
        r = torch.from_numpy(rows[lo:hi].astype(np.int32)).to(device)
        c = torch.from_numpy(cols[lo:hi].astype(np.int32)).to(device)
        v = torch.from_numpy(vals[lo:hi].astype(send)).to(device)
        flat[r.long() * C + c.long()] = v.to(dtype)
    return out


def _pack_triplets(rows, cols, ad_v, dp_v, shape, device, clip=False):
    """PackedCounts on `device` from host triplets with unique (row, col).

    Per block of triplets, the values of even columns, then those of odd
    columns shifted by 4, are OR-ed into zeroed bytes. Within one parity
    the byte indices are unique, so each read-or-write is exact and no
    atomic byte add is needed. Every value must be <= PACK_MAX unless
    `clip` saturates it there (the packed hybrid base).
    """
    if clip:
        ad_v = np.minimum(ad_v, PACK_MAX)
        dp_v = np.minimum(dp_v, PACK_MAX)
    V, C = (int(s) for s in shape)
    Cb = (C + 1) // 2
    ad_p = torch.zeros((V, Cb), dtype=torch.uint8, device=device)
    dp_p = torch.zeros_like(ad_p)
    flats = (ad_p.view(-1), dp_p.view(-1))
    vals = (np.asarray(ad_v), np.asarray(dp_v))
    for lo in range(0, len(rows), _SCATTER_BLOCK):
        hi = min(lo + _SCATTER_BLOCK, len(rows))
        r = torch.from_numpy(rows[lo:hi].astype(np.int32)).to(device)
        c = torch.from_numpy(cols[lo:hi].astype(np.int32)).to(device)
        idx = r.long() * Cb + (c >> 1).long()
        odd = (c & 1).bool()
        for flat, v in zip(flats, vals):
            v = torch.from_numpy(v[lo:hi].astype(np.uint8)).to(device)
            for sel, shift in ((~odd, 0), (odd, 4)):
                i = idx[sel]
                flat[i] = flat[i] | (v[sel] << shift)
    return PackedCounts(ad_p, dp_p, (V, C))


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
        return log_binom_coeff(self.dp_r.double(), self.ad_r.double()).sum()

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
        b1, b2 = self.base.suff_stats(W)
        r1, r2 = self.resid.suff_stats(W)
        return b1 + r1, b2 + r2

    def cell_loglik(self, Wa, Wd):
        return (self.base.cell_loglik(Wa, Wd)
                + self.resid.cell_loglik(Wa, Wd))

    def binom_coeff_sum(self):
        return self.base.binom_coeff_sum() + self.binom_corr

    def row_sums(self):
        ba, bd = self.base.row_sums()
        ra, rd = self.resid.row_sums()
        return ba + ra, bd + rd

    def n_vars_per_cell(self):
        # clipping keeps the DP > 0 pattern (cap >= 1)
        return self.base.n_vars_per_cell()


def _np_log_binom_coeff(dp, ad, max_val=700.0):
    """Host float64 log C(dp, ad), with ops.math.log_binom_coeff's 700
    clip and 0 where dp == 0."""
    from scipy.special import gammaln
    dp = np.asarray(dp, np.float64)
    ad = np.asarray(ad, np.float64)
    val = gammaln(dp + 1.0) - gammaln(ad + 1.0) - gammaln(dp - ad + 1.0)
    val = np.minimum(val, max_val)
    return np.where(dp > 0, val, 0.0)


def _hybrid_from_triplets(rows, cols, ad_v, dp_v, shape, cap, kind, device):
    """HybridCounts on `device` from host triplets: an "int8" base
    (cap 127) or a "packed" base (cap 15), and the residual."""
    ar = np.asarray(ad_v, np.float64)
    dr = np.asarray(dp_v, np.float64)
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    m = (ar > cap) | (dr > cap)
    at, dt = ar[m], dr[m]
    corr = float(np.sum(_np_log_binom_coeff(dt, at))
                 - np.sum(_np_log_binom_coeff(np.minimum(dt, cap),
                                              np.minimum(at, cap))))
    n_over = int(m.sum())
    if n_over > 0.1 * max(len(ar), 1):
        print("[vireo] warning: %.0f%% of counts exceed the %s cap %d "
              "- the hybrid residual is unusually large and per-"
              "iteration cost grows with it"
              % (100 * n_over / len(ar), kind, cap))
    resid = _sparse_from_triplets(rows[m], cols[m], np.maximum(at - cap, 0.0),
                                  np.maximum(dt - cap, 0.0), shape, device)
    if kind == "int8":
        base = DenseCounts(
            _scatter_dense(rows, cols, ar, shape, torch.int8, device),
            _scatter_dense(rows, cols, dr, shape, torch.int8, device))
    elif kind == "packed":
        base = _pack_triplets(rows, cols, ar, dr, shape, device, clip=True)
    else:
        raise ValueError("unknown hybrid base kind %r" % (kind,))
    return HybridCounts(base, resid, torch.tensor(corr, dtype=torch.float64,
                                                  device=device), int(cap))


def hybrid_from_coo(coo, cap, kind):
    """HybridCounts from a SparseCounts' full-precision triplets, on its
    device: `kind` "int8" (cap 127) or "packed" (cap 15)."""
    return _hybrid_from_triplets(
        coo.rows_r.cpu().numpy(), coo.cols_r.cpu().numpy(),
        coo.ad_r.cpu().numpy(), coo.dp_r.cpu().numpy(), coo.shape, cap,
        kind, coo.device)


def _dense_bytes(shape, vmax):
    """Bytes of the two dense matrices in `exact_count_dtype(vmax)`."""
    itemsize = torch.empty((), dtype=exact_count_dtype(vmax)).element_size()
    return 2 * shape[0] * shape[1] * itemsize


def ladder_rung(shape, vmax, budget):
    """The rung `counts_from_scipy` places a (n_var, n_cell) pool with
    largest count `vmax` on, under a budget of `budget` bytes, in the
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
    n_elems = int(shape[0]) * int(shape[1])
    if _dense_bytes(shape, vmax) <= budget:
        return "dense"
    no_hybrid = os.environ.get("VIREO_NO_HYBRID", "0") == "1"
    packed_ok = os.environ.get("VIREO_NO_PACKED", "0") != "1"
    if vmax > 127 and 2 * n_elems <= budget and not no_hybrid:
        return "int8-hybrid"
    if vmax <= PACK_MAX and n_elems <= budget and packed_ok:
        return "packed"
    if vmax > PACK_MAX and n_elems <= budget and packed_ok and not no_hybrid:
        return "packed-hybrid"
    return "coo"


def counts_from_scipy(AD, DP, device=None, dense_budget=None, verbose=False):
    """Place a scipy/numpy AD-DP pair on `device` (default:
    utils/device.py's) on the rung that `ladder_rung` picks under
    `dense_budget` bytes (default `device_dense_budget(device)`).

    The dense rung holds the counts in `exact_count_dtype` of their
    largest value, at every size (the JAX package keeps pools of at most
    64M elements in the caller's float type instead; int8 converts to
    float exactly, so the contractions give the same numbers, and the
    fused doublet E-step then sees int8 counts at every size).
    """
    device = resolve_device(device)
    rows, cols, ad_v, dp_v = _host_union_triplets(AD, DP)
    vmax = float(max(ad_v.max() if len(ad_v) else 0.0,
                     dp_v.max() if len(dp_v) else 0.0))
    if float(min(ad_v.min() if len(ad_v) else 0.0,
                 dp_v.min() if len(dp_v) else 0.0)) < 0:
        raise ValueError("counts must be non-negative")
    shape = (int(AD.shape[0]), int(AD.shape[1]))
    budget = device_dense_budget(device) if dense_budget is None \
        else dense_budget
    rung = ladder_rung(shape, vmax, budget)
    if verbose:
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
        print("[vireo] %dx%d counts (max %.0f) on %s: %s"
              % (shape[0], shape[1], vmax, device, what))
    if rung == "dense":
        dtype = exact_count_dtype(vmax)
        return DenseCounts(
            _scatter_dense(rows, cols, ad_v, shape, dtype, device),
            _scatter_dense(rows, cols, dp_v, shape, dtype, device))
    if rung == "int8-hybrid":
        return _hybrid_from_triplets(rows, cols, ad_v, dp_v, shape, 127,
                                     "int8", device)
    if rung == "packed":
        return _pack_triplets(rows, cols, ad_v, dp_v, shape, device)
    if rung == "packed-hybrid":
        return _hybrid_from_triplets(rows, cols, ad_v, dp_v, shape, PACK_MAX,
                                     "packed", device)
    return _sparse_from_triplets(rows, cols, ad_v, dp_v, shape, device)
