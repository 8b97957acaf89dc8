"""Synthetic multiplexed-pool generators with ground truth (counterpart
of vireo_tpu/sim/synth.py).

AD/DP count matrices are sampled from the generative model the engine
fits (donor genotypes -> binomial allele counts), with doublet cells
mixed from donor pairs, together with the ground-truth cell->donor
table. `synth_pool_counts` is numpy, with the JAX package's draws in the
same order, so one seed gives the same pool in both packages;
`synth_pool_dense_device` samples the same model on the device, from a
torch.Generator, straight into int8 dense counts.
"""

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["synth_pool_counts", "synth_pool_dense_device"]

# depth cap of the device generator: P(1 + Poisson(0.6) > 12) ~ 1e-11
MAXD = 12


def synth_pool_counts(n_var=30000, n_cell=100000, n_donor=16,
                      doublet_rate=0.0, density=0.01, mean_extra_depth=0.6,
                      theta=(0.01, 0.5, 0.99), seed=0):
    """Sample a synthetic pool.

    Returns dict with:
      AD, DP: scipy.sparse.csc_matrix (n_var, n_cell)
      donor:  (n_cell,) primary donor index
      donor2: (n_cell,) second donor for doublets, else -1
      GT:     (n_var, n_donor) true genotypes in {0,1,2}
    """
    import scipy.sparse as sp
    rng = np.random.RandomState(seed)

    # donor genotypes: per-variant population allele frequency
    af = rng.beta(0.8, 0.8, size=n_var)
    GT = rng.binomial(2, af[:, None], size=(n_var, n_donor)).astype(np.int8)

    donor = rng.randint(0, n_donor, size=n_cell)
    donor2 = np.full(n_cell, -1, dtype=np.int64)
    n_doublet = int(n_cell * doublet_rate)
    if n_doublet > 0:
        dbl_idx = rng.choice(n_cell, size=n_doublet, replace=False)
        d2 = rng.randint(0, n_donor, size=n_doublet)
        # avoid same-donor "doublets"
        same = d2 == donor[dbl_idx]
        d2[same] = (d2[same] + 1) % n_donor
        donor2[dbl_idx] = d2

    # sparse site coverage: variant popularity ~ Gamma, cells uniform
    w = rng.gamma(1.0, 1.0, size=n_var)
    w /= w.sum()
    nnz_target = int(density * n_var * n_cell)
    rows = rng.choice(n_var, size=nnz_target, p=w)
    cols = rng.randint(0, n_cell, size=nnz_target)
    key = rows.astype(np.int64) * n_cell + cols
    key = np.unique(key)
    rows = (key // n_cell).astype(np.int32)
    cols = (key % n_cell).astype(np.int32)
    nnz = len(rows)

    dp = 1 + rng.poisson(mean_extra_depth, size=nnz)

    theta = np.asarray(theta)
    p1 = theta[GT[rows, donor[cols]]]
    is_dbl = donor2[cols] >= 0
    p2 = np.where(is_dbl, theta[GT[rows, np.where(is_dbl, donor2[cols], 0)]],
                  p1)
    p = 0.5 * (p1 + p2)
    ad = rng.binomial(dp, p)

    DP = sp.csc_matrix((dp.astype(np.float64), (rows, cols)),
                       shape=(n_var, n_cell))
    AD = sp.csc_matrix((ad.astype(np.float64), (rows, cols)),
                       shape=(n_var, n_cell))
    AD.eliminate_zeros()
    return dict(AD=AD, DP=DP, donor=donor, donor2=donor2, GT=GT)


def _beta_sym(shape, a, g, device):
    """Beta(a, a) draws for a <= 1 by Johnk's rejection on the generator's
    uniforms: X = U^(1/a), Y = V^(1/a), accepted when X + Y <= 1, then
    X / (X + Y); in logs, so small powers do not underflow."""
    out = torch.empty(shape, dtype=torch.float32, device=device)
    todo = torch.ones(shape, dtype=torch.bool, device=device)
    while bool(todo.any()):
        n = int(todo.sum())
        lx = torch.log(torch.rand(n, generator=g, device=device)) / a
        ly = torch.log(torch.rand(n, generator=g, device=device)) / a
        ok = torch.logaddexp(lx, ly) <= 0
        vals = torch.sigmoid(lx - ly)       # X / (X + Y)
        idx = todo.nonzero().squeeze(1)
        out[idx[ok]] = vals[ok]
        todo[idx[ok]] = False
    return out


def synth_pool_dense_device(n_var=30000, n_cell=100000, n_donor=16,
                            doublet_rate=0.0, density=0.01,
                            mean_extra_depth=0.6,
                            theta=(0.01, 0.5, 0.99), seed=0,
                            row_chunk=2000, device=None):
    """Sample the model of `synth_pool_counts` on `device` (default:
    utils/device.py's) as int8 DenseCounts, with no host pool and no
    upload.

    Beta(0.8, 0.8) allele frequencies, Binomial(2) genotypes, uniform
    donors, doublets at `doublet_rate` (Bernoulli per cell, second donor
    never the first), coverage Bernoulli(`density`), depth
    1 + Poisson(`mean_extra_depth`) capped at MAXD, and the binomial
    allele count drawn as MAXD Bernoulli layers. Rows are generated
    `row_chunk` at a time, which bounds the temporaries. The statistics
    are those of `synth_pool_counts` (its coverage draws variants by a
    Gamma popularity with replacement, so its density is a little
    lower); the bytes differ, as the JAX package's do.

    Returns dict(counts=DenseCounts, donor, donor2, GT) with the truth as
    numpy arrays, as `synth_pool_counts` gives it.
    """
    from ..ops.counts import DenseCounts
    device = resolve_device(device)
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
        pt = theta_arr[GT[r0:r1].long()]                  # (R, K)
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
    return dict(counts=DenseCounts(ad8, dp8), donor=donor.cpu().numpy(),
                donor2=donor2.cpu().numpy(), GT=GT.cpu().numpy())
