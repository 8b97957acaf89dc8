"""Synthetic multiplexed-pool generator with ground truth (numpy only;
counterpart of vireo_tpu/sim/synth.py::synth_pool_counts, with the same
draws in the same order, so one seed gives the same pool in both
packages).

AD/DP count matrices are sampled from the generative model the engine
fits (donor genotypes -> binomial allele counts), with doublet cells
mixed from donor pairs, together with the ground-truth cell->donor
table.
"""

import numpy as np

__all__ = ["synth_pool_counts"]


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
