"""Single-pass ("fused") Vireo EM for large dense pools (counterpart of
vireo_tpu/models/vireo_fused.py).

Each iteration carries the sufficient statistics (S1, SS) instead of
reading the counts for them: the theta and GT updates use the previous
pass's statistics, and one launch of K1 (ops/fused_em.py) computes the
cell E-step and the next statistics from the same counts, so the counts
are read once per iteration. The update sequence is em_step's; K1 rounds
the weights and the assignments to bf16 and sums in float32.

The counts are an unpadded int8 DenseCounts: K1 masks ragged edges, so
where the JAX package pads variants to a multiple of 32 and cells to its
cell block, and pads the state and priors to match, the port does not.
For pools of 50k+ cells; the unfused `fit_vb` in float32 stays the
default of `vireo_wrap`.
"""

import dataclasses

import numpy as np
import torch

from ..ops.counts import DenseCounts
from ..ops.fused_em import fused_estep_stats
from .vireo import VireoState, updates_from_stats

__all__ = ["FusedData", "prepare_fused", "fused_em_iteration",
           "run_fused_iters_n", "fused_fit_vb"]


@dataclasses.dataclass(frozen=True)
class FusedData:
    """int8 (n_var, n_cell) counts for K1."""
    ad: torch.Tensor
    dp: torch.Tensor

    @property
    def n_var(self):
        return self.ad.shape[0]

    @property
    def n_cell(self):
        return self.ad.shape[1]


def prepare_fused(counts):
    """FusedData from a DenseCounts. Counts of another type are turned
    into int8 when every count is <= 127; larger counts raise
    ValueError, as does any other counts class (the JAX package clips
    such counts to 127 without a word)."""
    if not isinstance(counts, DenseCounts):
        raise ValueError("prepare_fused takes a DenseCounts, got %s"
                         % type(counts).__name__)
    ad, dp = counts.ad, counts.dp
    if ad.dtype != torch.int8 or dp.dtype != torch.int8:
        vmax = max(float(ad.max()) if ad.numel() else 0.0,
                   float(dp.max()) if dp.numel() else 0.0)
        if vmax > 127:
            raise ValueError("the fused fit reads int8 counts; the largest "
                             "count is %g > 127" % vmax)
        ad, dp = ad.to(torch.int8), dp.to(torch.int8)
    return FusedData(ad=ad, dp=dp)


def _initial_stats(data, state):
    """(S1, SS) for the initial id_prob, float32: one plain pass of the
    counts with bf16(id) before the fused loop takes over."""
    idb = state.id_prob.to(torch.bfloat16).to(torch.float32)
    return DenseCounts(data.ad, data.dp).suff_stats(idb)


def fused_em_iteration(data, S1, SS, state, priors, cfg, update_theta):
    """One restructured iteration: the theta/GT updates from (S1, SS) =
    (AD @ id, DP @ id) of the previous pass, then one K1 launch for the
    new (S1, SS), id_prob and ELBO terms. Returns (S1, SS, state, elbo).
    The ID prior must be one row broadcast over the cells."""
    if priors.id_log.shape[0] != 1:
        raise ValueError("the fused fit takes a row-broadcast ID prior, "
                         "got id_log of shape %s"
                         % (tuple(priors.id_log.shape),))
    beta_mu, beta_sum, gt_prob, (Wfa, Wfd), kl_params = \
        updates_from_stats(S1, SS, state, priors, cfg, update_theta)

    S1n, SSn, id_prob, _, lb_p, kl_id = fused_estep_stats(
        data.ad, data.dp, Wfa.to(torch.float32), Wfd.to(torch.float32),
        priors.id_log.to(torch.float32).reshape(1, -1))

    elbo = lb_p - kl_id - kl_params
    new_state = VireoState(beta_mu=beta_mu, beta_sum=beta_sum,
                           gt_prob=gt_prob, id_prob=id_prob)
    return S1n, SSn, new_state, elbo


def run_fused_iters_n(data, state, priors, cfg, n_iters):
    """Exactly `n_iters` fused iterations with every update on; returns
    (state, elbo of the last)."""
    S1, SS = _initial_stats(data, state)
    elbo = torch.tensor(float("-inf"), dtype=torch.float32)
    for _ in range(int(n_iters)):
        S1, SS, state, elbo = fused_em_iteration(data, S1, SS, state,
                                                 priors, cfg, True)
    return state, elbo


def fused_fit_vb(data, state, priors, cfg, max_iter=200, min_iter=5,
                 epsilon_conv=1e-2, delay_fit_theta=0):
    """The fused fit to convergence: the reference's stop test, in
    float32 on the host after each iteration, as the JAX package
    evaluates it. Returns (state, elbo_ref, elbo_final, n_iter), where
    elbo_ref is the second-to-last iteration's ELBO (the reference's
    recorded final ELBO)."""
    S1, SS = _initial_stats(data, state)
    f32 = np.float32
    eps, tiny = f32(epsilon_conv), f32(1e-6)
    it, prev, curr = 0, f32(-np.inf), f32(-np.inf)
    while True:
        with np.errstate(invalid="ignore"):
            delta = curr - prev
        if it >= max_iter or (it - 1 > min_iter and -tiny <= delta < eps):
            break
        S1, SS, state, elbo = fused_em_iteration(
            data, S1, SS, state, priors, cfg,
            update_theta=(it >= delay_fit_theta))
        prev, curr = curr, f32(elbo.item())
        it += 1
    return state, prev, curr, it
