"""The benchmark's pool generator: a copy of the program's
`vireo_tpu_torch/sim/synth.py::synth_pool_dense_device`, kept here so
that a change to the program cannot change the yardstick, and widened
by a heavy tail of depth that a configuration asks for.

It samples the genotype-free Vireo model on the card from a
torch.Generator seeded with the run's seed: Beta(0.8, 0.8) allele
frequencies, Binomial(2) genotypes, uniform donors, doublets at
`doublet_rate` (second donor never the first), coverage
Bernoulli(`density`), depth 1 + Poisson(`mean_extra_depth`) capped at
`max_depth`, and the allele count as `max_depth` Bernoulli layers.

The heavy tail: a share `hot_share` of the covered entries gets an
extra depth drawn uniformly from the integers of `hot_depth` = [lo, hi),
as highly expressed genes, or reads counted in place of UMIs, give
real pools; the allele count of such an entry is drawn again as
Binomial(depth, p) at its own allele rate. Without `hot_share` no draw
is added, and the pool is the one the generator made before it had a
tail. The matrices are int8 where every count can fit (`max_depth` plus
the largest extra at most 127), else int16; a configuration whose
counts could pass 32,767 is refused.

`to_host` turns the dense matrices into the scipy CSC float64 pair that
`read_cellSNP` returns: AD holds only its own nonzeros.
"""

import numpy as np
import torch

__all__ = ["MAXD", "count_dtype", "make_pool", "to_host"]

# default depth cap: P(1 + Poisson(0.6) > 12) ~ 1e-11
MAXD = 12


def _beta_sym(shape, a, g, device):
    """Beta(a, a) draws for a <= 1 by Johnk's rejection, in logs."""
    out = torch.empty(shape, dtype=torch.float32, device=device)
    todo = torch.ones(shape, dtype=torch.bool, device=device)
    while bool(todo.any()):
        n = int(todo.sum())
        lx = torch.log(torch.rand(n, generator=g, device=device)) / a
        ly = torch.log(torch.rand(n, generator=g, device=device)) / a
        ok = torch.logaddexp(lx, ly) <= 0
        vals = torch.sigmoid(lx - ly)
        idx = todo.nonzero().squeeze(1)
        out[idx[ok]] = vals[ok]
        todo[idx[ok]] = False
    return out


def count_dtype(max_depth=MAXD, hot_share=0.0, hot_depth=None):
    """The type of a pool's count matrices: int8 where the largest count
    it can draw (`max_depth`, plus `hot_depth`'s largest extra where
    `hot_share` > 0) is at most 127, else int16. Refuses a pool whose
    counts could pass 32,767, and malformed depth keys."""
    if int(max_depth) != max_depth or max_depth < 1:
        raise ValueError("max_depth is a whole number of 1 or more, not %r"
                         % (max_depth,))
    if not 0.0 <= hot_share <= 1.0:
        raise ValueError("hot_share is a share in [0, 1], not %r"
                         % (hot_share,))
    largest = int(max_depth)
    if hot_share > 0:
        if hot_depth is None or len(hot_depth) != 2:
            raise ValueError("a hot_share needs hot_depth, [lo, hi) of the "
                             "extra depth")
        lo, hi = hot_depth
        if int(lo) != lo or int(hi) != hi or not 0 <= lo < hi:
            raise ValueError("hot_depth is [lo, hi) with whole numbers "
                             "0 <= lo < hi, not %r" % (hot_depth,))
        largest += int(hi) - 1
    for dtype in (torch.int8, torch.int16):
        if largest <= torch.iinfo(dtype).max:
            return dtype
    raise ValueError("counts up to %d: the pool's matrices hold at most %d "
                     "(int16)" % (largest, torch.iinfo(torch.int16).max))


def make_pool(n_var, n_cell, n_donor, doublet_rate, density,
              mean_extra_depth, seed, device, theta=(0.01, 0.5, 0.99),
              max_depth=MAXD, hot_share=0.0, hot_depth=None,
              row_chunk=2000):
    """The pool on `device`: dict(ad, dp) (n_var, n_cell) tensors in
    `count_dtype` and the truth donor, donor2 (-1 for a singlet), GT as
    numpy."""
    dtype = count_dtype(max_depth, hot_share, hot_depth)
    max_depth = int(max_depth)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    af = _beta_sym((n_var,), 0.8, g, device)
    GT = ((torch.rand((n_var, n_donor), generator=g, device=device)
           < af[:, None]).to(torch.int8)
          + (torch.rand((n_var, n_donor), generator=g, device=device)
             < af[:, None]).to(torch.int8))
    donor = torch.randint(0, n_donor, (n_cell,), generator=g, device=device)
    donor2 = torch.full((n_cell,), -1, dtype=torch.int64, device=device)
    if doublet_rate > 0:
        is_dbl = torch.rand(n_cell, generator=g, device=device) \
            < doublet_rate
        d2 = torch.randint(0, n_donor, (n_cell,), generator=g,
                           device=device)
        d2 = torch.where(d2 == donor, (d2 + 1) % n_donor, d2)
        donor2 = torch.where(is_dbl, d2, donor2)
    dbl = donor2 >= 0
    d2c = torch.where(dbl, donor2, 0)

    theta_arr = torch.as_tensor(theta, dtype=torch.float32, device=device)
    ad_all = torch.empty((n_var, n_cell), dtype=dtype, device=device)
    dp_all = torch.empty_like(ad_all)
    rate = torch.full((min(row_chunk, n_var), n_cell), mean_extra_depth,
                      dtype=torch.float32, device=device)
    for r0 in range(0, n_var, row_chunk):
        r1 = min(r0 + row_chunk, n_var)
        R = r1 - r0
        covered = torch.rand((R, n_cell), generator=g, device=device) \
            < density
        extra = torch.poisson(rate[:R], generator=g)
        dp = torch.where(covered, (1 + extra).clamp(max=max_depth), 0).to(
            dtype)
        del covered, extra
        pt = theta_arr[GT[r0:r1].long()]
        p1 = pt[:, donor]
        p = 0.5 * (p1 + torch.where(dbl, pt[:, d2c], p1))
        del p1
        ad = torch.zeros((R, n_cell), dtype=dtype, device=device)
        for layer in range(max_depth):
            u = torch.rand((R, n_cell), generator=g, device=device)
            ad += (u < p) & (dp > layer)
        del u
        if hot_share > 0:
            _heat(ad.view(-1), dp.view(-1), p.view(-1), hot_share,
                  hot_depth, g)
        ad_all[r0:r1] = ad
        dp_all[r0:r1] = dp
        del p, ad, dp
    return dict(ad=ad_all, dp=dp_all, donor=donor.cpu().numpy(),
                donor2=donor2.cpu().numpy(), GT=GT.cpu().numpy())


def _heat(ad, dp, p, hot_share, hot_depth, g):
    """In place on one block's flat counts: a `hot_share` of the covered
    entries gets an extra depth uniform on [lo, hi), and its allele
    count drawn again as Binomial(depth, p)."""
    covered = dp.nonzero().squeeze(1)
    hot = covered[torch.rand(covered.numel(), generator=g,
                             device=dp.device) < hot_share]
    lo, hi = (int(x) for x in hot_depth)
    dp[hot] += torch.randint(lo, hi, (hot.numel(),), generator=g,
                             device=dp.device).to(dp.dtype)
    ad[hot] = torch.binomial(dp[hot].to(torch.float32), p[hot],
                             generator=g).to(ad.dtype)


def _csc(X, block_entries=1 << 27):
    """scipy CSC float64 of the dense int8 or int16 device matrix `X`, its
    nonzeros found on the device a block of cells at a time."""
    import scipy.sparse as sp
    V, C = X.shape
    XT = X.t()
    rows, cols, vals = [], [], []
    step = max(block_entries // max(V, 1), 1)
    for c0 in range(0, C, step):
        block = XT[c0:c0 + step]
        nz = block.nonzero()
        cols.append((nz[:, 0] + c0).to(torch.int32).cpu().numpy())
        rows.append(nz[:, 1].to(torch.int32).cpu().numpy())
        vals.append(block[nz[:, 0], nz[:, 1]].cpu().numpy())
    cols = np.concatenate(cols)
    indptr = np.zeros(C + 1, np.int64)
    np.cumsum(np.bincount(cols, minlength=C), out=indptr[1:])
    return sp.csc_matrix((np.concatenate(vals).astype(np.float64),
                          np.concatenate(rows), indptr), shape=(V, C))


def to_host(pool):
    """(AD, DP) as scipy CSC float64 (n_var, n_cell), AD with its own
    nonzeros only."""
    return _csc(pool["ad"]), _csc(pool["dp"])
