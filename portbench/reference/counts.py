"""The plain reference's count matrices and its two contractions.

The counts are made dense again from the host's scipy matrices, the
same matrices the program is given, as int8 on the device (every count
of the benchmark's pools is below 128). The contractions convert one
block of variant rows at a time to the arithmetic's type and hand it to
`torch.matmul`:

    stats(W)        = (AD @ W, DP @ W)          W: (n_cell, M)
    loglik(Wa, Wd)  = AD.T @ Wa + DP.T @ Wd     Wa, Wd: (n_var, M)

`Arith` names the arithmetic: "float64" is the reference; "tf32" is
its control, float32 state with every contraction's operands rounded to
TF32 (10 mantissa bits, to nearest even) and summed in float32, which is
what a TF32 tensor-core product does; "float32" is float32 throughout
with TF32 off, the configuration's own precision.
"""

import numpy as np
import torch

__all__ = ["Arith", "RefCounts", "to_tf32"]

# bytes of one converted block of count rows
BLOCK_BYTES = 1 << 30


def to_tf32(x):
    """float32 `x` rounded to TF32's 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    i = (i + 0x0FFF + lsb) & -0x2000
    return i.view(torch.float32)


class Arith:
    """The type of the state and the rounding of the contractions."""

    def __init__(self, name):
        if name not in ("float64", "float32", "tf32"):
            raise ValueError("arithmetic is float64, float32 or tf32, not %r"
                             % name)
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32
        # float32 products in float32: the tf32 arithmetic rounds its
        # operands itself
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def operand(self, x):
        x = x.to(self.dtype)
        return to_tf32(x) if self.name == "tf32" else x


class RefCounts:
    """Dense int8 AD and DP on `device`, built from host scipy matrices."""

    def __init__(self, AD, DP, device):
        self.n_var, self.n_cell = (int(s) for s in DP.shape)
        self.ad = self._dense(AD, device)
        self.dp = self._dense(DP, device)

    def _dense(self, X, device):
        coo = X.tocoo()
        coo.sum_duplicates()
        if coo.data.size and (coo.data.max() > 127 or coo.data.min() < 0):
            raise ValueError("the reference holds counts in [0, 127]")
        out = torch.zeros((self.n_var, self.n_cell), dtype=torch.int8,
                          device=device)
        flat = out.view(-1)
        step = 1 << 24
        for lo in range(0, coo.nnz, step):
            hi = min(lo + step, coo.nnz)
            idx = (torch.from_numpy(coo.row[lo:hi].astype(np.int64))
                   * self.n_cell
                   + torch.from_numpy(coo.col[lo:hi].astype(np.int64)))
            vals = torch.from_numpy(coo.data[lo:hi].astype(np.int8))
            flat[idx.to(device)] = vals.to(device)
        return out

    def _blocks(self, dtype):
        size = torch.empty((), dtype=dtype).element_size()
        rows = max(BLOCK_BYTES // (self.n_cell * size), 1)
        for r0 in range(0, self.n_var, rows):
            r1 = min(r0 + rows, self.n_var)
            yield r0, r1, self.ad[r0:r1].to(dtype), self.dp[r0:r1].to(dtype)

    def stats(self, W, arith):
        W = arith.operand(W)
        S1 = torch.empty((self.n_var, W.shape[1]), dtype=arith.dtype,
                         device=W.device)
        SS = torch.empty_like(S1)
        for r0, r1, a, d in self._blocks(arith.dtype):
            torch.matmul(a, W, out=S1[r0:r1])
            torch.matmul(d, W, out=SS[r0:r1])
        return S1, SS

    def loglik(self, Wa, Wd, arith):
        Wa, Wd = arith.operand(Wa), arith.operand(Wd)
        out = torch.zeros((self.n_cell, Wa.shape[1]), dtype=arith.dtype,
                          device=Wa.device)
        for r0, r1, a, d in self._blocks(arith.dtype):
            out.addmm_(a.t(), Wa[r0:r1])
            out.addmm_(d.t(), Wd[r0:r1])
        return out

    def binom_sum(self):
        """Sum over DP > 0 of log C(DP, AD), each clipped at 700, in
        float64."""
        total = torch.zeros((), dtype=torch.float64, device=self.ad.device)
        for _, _, a, d in self._blocks(torch.float64):
            val = (torch.lgamma(d + 1) - torch.lgamma(a + 1)
                   - torch.lgamma(d - a + 1)).clamp(max=700.0)
            total += torch.where(d > 0, val, 0.0).sum()
        return float(total)
