"""Model selection: ELBO sweeps over the number of donors or clones
(counterpart of vireo_tpu/engine/select.py).

Each K's restarts run as one batched fit on counts placed once for the
whole sweep. Seeded sweeps draw every K's inits from numpy's global
stream in the reference's order (`wrap._seeded_batched_init`: on the
host, or regenerated on the device for large streams); unseeded sweeps
seed a device generator per K from that stream (`rng.randint(2**31)`).
JAX's forced device-init path (VIREO_DEVICE_INIT=1), which reuses one
seed for every K, is not ported.
"""

import numpy as np
import torch

from ..ops.counts import counts_from_scipy
from ..models.vireo import VireoConfig, default_priors, fit_vb
from ..models.bmm import BinomMixtureVB
from ..utils.device import default_dtype

__all__ = ["sweep_n_donor", "sweep_n_clone"]


def _as_counts(AD, DP, device):
    if hasattr(AD, "suff_stats"):       # already a counts object
        return AD
    return counts_from_scipy(AD, DP, device=device)


def _report(label, K, elbos):
    print("[vireo] %s=%d ELBO range [%.1f, %.1f, %.1f]"
          % (label, K, elbos.min(), np.median(elbos), elbos.max()))


def sweep_n_donor(AD, DP=None, n_donor_list=(2, 3, 4, 5, 6, 7, 8),
                  n_init=20, max_iter_init=20, delay_fit_theta=3,
                  random_seed=None, dtype=None, verbose=True, device=None):
    """Genotype-free ELBO sweep over candidate donor counts.

    Returns {K: np.array of per-restart ELBOs (the binomial constant
    added)} plus "best", the K of the largest ELBO: the notebook recipe
    of comparing `ELBO_inits` across K. AD may be a counts object, whose
    device is then the sweep's."""
    from .wrap import _seeded_batched_init, _device_batched_init

    counts = _as_counts(AD, DP, device)
    device = counts.device
    dtype = dtype or default_dtype(device)
    if random_seed is not None:
        np.random.seed(random_seed)
    rng = np.random

    binom = float(counts.binom_coeff_sum())
    out = {}
    for K in n_donor_list:
        cfg = VireoConfig(n_var=counts.n_var, n_cell=counts.n_cell,
                          n_donor=int(K))
        priors = default_priors(cfg, dtype=dtype, device=device)
        if random_seed is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(int(rng.randint(2 ** 31)))
            batched = _device_batched_init(cfg, n_init, None, gen, dtype,
                                           device)
        else:
            batched = _seeded_batched_init(cfg, n_init, None, rng, dtype,
                                           device)
        res = fit_vb(counts, batched, priors, cfg, max_iter=max_iter_init,
                     min_iter=5, delay_fit_theta=delay_fit_theta)
        out[int(K)] = res.elbo_ref + binom
        if verbose:
            _report("K", K, out[int(K)])

    out["best"] = int(max(n_donor_list, key=lambda K: out[int(K)].max()))
    return out


def sweep_n_clone(AD, DP=None, n_clone_list=(2, 3, 4, 5), n_init=50,
                  min_iter=30, random_seed=None, dtype=None, verbose=True,
                  device=None):
    """Clone-count sweep of the binomial mixture model (the mito
    notebook workflow). Returns {K: ELBO_inits array, "best": K}. Each K
    reseeds numpy's stream with `random_seed` (when given), as each
    `BinomMixtureVB.fit` does."""
    counts = _as_counts(AD, DP, device)
    out = {}
    for K in n_clone_list:
        model = BinomMixtureVB(n_cell=counts.n_cell, n_var=counts.n_var,
                               n_donor=int(K), dtype=dtype,
                               device=counts.device)
        model.fit(counts, n_init=n_init, min_iter=min_iter,
                  random_seed=random_seed)
        out[int(K)] = np.asarray(model.ELBO_inits)
        if verbose:
            _report("n_clone", K, out[int(K)])
    out["best"] = int(max(n_clone_list, key=lambda K: out[int(K)].max()))
    return out
