"""Allele-count matrices on the device: the dense rung of
vireo_tpu/ops/counts.py.

Every model-side use of the data is one of two contractions:

- ``suff_stats(W)``:       (S1, SS) = (AD @ W, DP @ W)    variant side
- ``cell_loglik(Wa, Wd)``: AD.T @ Wa + DP.T @ Wd          cell side

AD and DP are held dense, (n_var, n_cell), in the smallest type that
holds every count exactly (`exact_count_dtype`): int8 up to 127, which
is what real pools give. PyTorch has no int8 x float matmul, so the
contractions convert the counts to the weights' type one block of
variant rows at a time and hand each block to `torch.matmul`. The
conversion is exact, so the result equals a product with the whole
matrix converted, up to the order of the float sums; a whole-matrix
conversion would instead cost a 12 GB float32 copy per matrix per call
at 30k variants x 100k cells.

Only the dense rung is here. Pools that do not fit it raise
NotImplementedError; the hybrid, packed and COO rungs are later items
of ROADMAP.md.
"""

import dataclasses

import numpy as np
import torch

from .math import log_binom_coeff

__all__ = ["DenseCounts", "counts_from_scipy", "exact_count_dtype",
           "device_dense_budget"]

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
    """Device bytes available for the two dense count matrices: 55% of
    the card's free memory (`torch.cuda.mem_get_info`), leaving room for
    posteriors and converted blocks; 16 GiB on the CPU."""
    device = torch.device("cpu" if device is None else device)
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
    scattered into a zero matrix on the device.
    """
    V, C = shape
    out = torch.zeros((V, C), dtype=dtype, device=device)
    flat = out.view(-1)
    send = np.int8 if dtype == torch.int8 else np.float32
    for lo in range(0, len(rows), _SCATTER_BLOCK):
        hi = min(lo + _SCATTER_BLOCK, len(rows))
        r = torch.from_numpy(rows[lo:hi].astype(np.int32)).to(device)
        c = torch.from_numpy(cols[lo:hi].astype(np.int32)).to(device)
        v = torch.from_numpy(np.asarray(vals[lo:hi]).astype(send)).to(device)
        flat[r.long() * C + c.long()] = v.to(dtype)
    return out


def counts_from_scipy(AD, DP, device=None, dense_budget=None, verbose=False):
    """Place a scipy/numpy AD-DP pair on `device` as DenseCounts.

    Counts are densified on the device in `exact_count_dtype` of their
    largest value, at every size (the JAX package keeps pools of at most
    64M elements in the caller's float type instead; int8 converts to
    float exactly, so the contractions give the same numbers, and the
    fused doublet E-step then sees int8 counts at every size).
    """
    device = torch.device("cpu" if device is None else device)
    rows, cols, ad_v, dp_v = _host_union_triplets(AD, DP)
    vmax = float(max(ad_v.max() if len(ad_v) else 0.0,
                     dp_v.max() if len(dp_v) else 0.0))
    if float(min(ad_v.min() if len(ad_v) else 0.0,
                 dp_v.min() if len(dp_v) else 0.0)) < 0:
        raise ValueError("counts must be non-negative")
    shape = (int(AD.shape[0]), int(AD.shape[1]))
    dtype = exact_count_dtype(vmax)
    itemsize = torch.empty((), dtype=dtype).element_size()
    need = 2 * shape[0] * shape[1] * itemsize
    budget = device_dense_budget(device) if dense_budget is None \
        else dense_budget
    if need > budget:
        raise NotImplementedError(
            "%dx%d counts (max %.0f) need %.1f GiB as dense %s, above the "
            "%.1f GiB budget; the hybrid, packed and COO rungs are not "
            "ported yet (ROADMAP.md, queue 1: sparse, hybrid and packed "
            "rungs)" % (shape[0], shape[1], vmax, need / 2**30,
                        str(dtype).replace("torch.", ""), budget / 2**30))
    if verbose:
        print("[vireo] %dx%d counts (max %.0f) densified on %s as %s "
              "(%.1f GiB)" % (shape[0], shape[1], vmax, device,
                              str(dtype).replace("torch.", ""),
                              need / 2**30))
    ad = _scatter_dense(rows, cols, ad_v, shape, dtype, device)
    dp = _scatter_dense(rows, cols, dp_v, shape, dtype, device)
    return DenseCounts(ad, dp)
