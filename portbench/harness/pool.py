"""The benchmark's pool generator: a copy of the program's
`vireo_tpu_torch/sim/synth.py::synth_pool_dense_device`, kept here so
that a change to the program cannot change the yardstick.

It samples the genotype-free Vireo model on the card from a
torch.Generator seeded with the run's seed: Beta(0.8, 0.8) allele
frequencies, Binomial(2) genotypes, uniform donors, doublets at
`doublet_rate` (second donor never the first), coverage
Bernoulli(`density`), depth 1 + Poisson(`mean_extra_depth`) capped at
MAXD, and the allele count as MAXD Bernoulli layers. `to_host` turns
the dense int8 matrices into the scipy CSC float64 pair that
`read_cellSNP` returns: AD holds only its own nonzeros.
"""

import numpy as np
import torch

__all__ = ["MAXD", "make_pool", "to_host"]

# depth cap: P(1 + Poisson(0.6) > 12) ~ 1e-11
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


def make_pool(n_var, n_cell, n_donor, doublet_rate, density,
              mean_extra_depth, seed, device, theta=(0.01, 0.5, 0.99),
              row_chunk=2000):
    """The pool on `device`: dict(ad, dp) int8 (n_var, n_cell) tensors
    and the truth donor, donor2 (-1 for a singlet), GT as numpy."""
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
    ad8 = torch.empty((n_var, n_cell), dtype=torch.int8, device=device)
    dp8 = torch.empty_like(ad8)
    rate = torch.full((min(row_chunk, n_var), n_cell), mean_extra_depth,
                      dtype=torch.float32, device=device)
    for r0 in range(0, n_var, row_chunk):
        r1 = min(r0 + row_chunk, n_var)
        R = r1 - r0
        covered = torch.rand((R, n_cell), generator=g, device=device) \
            < density
        extra = torch.poisson(rate[:R], generator=g)
        dp = torch.where(covered, (1 + extra).clamp(max=MAXD), 0).to(
            torch.int8)
        del covered, extra
        pt = theta_arr[GT[r0:r1].long()]
        p1 = pt[:, donor]
        p = 0.5 * (p1 + torch.where(dbl, pt[:, d2c], p1))
        del p1
        ad = torch.zeros((R, n_cell), dtype=torch.int8, device=device)
        for layer in range(MAXD):
            u = torch.rand((R, n_cell), generator=g, device=device)
            ad += (u < p) & (dp > layer)
        ad8[r0:r1] = ad
        dp8[r0:r1] = dp
        del p, ad, dp, u
    return dict(ad=ad8, dp=dp8, donor=donor.cpu().numpy(),
                donor2=donor2.cpu().numpy(), GT=GT.cpu().numpy())


def _csc(X, block_entries=1 << 27):
    """scipy CSC float64 of the dense int8 device matrix `X`, its
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
