"""Doublet detection: one E-step over an expanded donor space
(counterpart of vireo_tpu/models/doublet.py).

The donor axis grows by the C(K,2) donor pairs and the genotype axis by
the C(G,2) genotype combinations; the assignment E-step then runs once
on the expanded tensors. By default, as in the JAX package, it runs
unfused: the expanded log-likelihood through the counts' own
`cell_loglik` (K0 for an int8 DenseCounts, K3 for packed counts), the
softmax on the device, then `Vireo.update_GT_prob`'s full E-step for
the GT refresh. Under VIREO_FUSED_DOUBLET (`takes_fused_estep`, the
same values and warning as the JAX package's `_fused_doublet_mode`) an
int8 DenseCounts with a row prior and at most `fused_em.MAX_K` columns
goes through the fused kernel K1 (ops/fused_em.py), which rounds W and
the assignments to bf16 and also yields the singlet-slice statistics
for the GT refresh. `interpret` asks for K1's math: its plain version
on the CPU, the kernel on a card, as `1` does.

One difference from the JAX package, under the knob only: bfloat16
dense counts (counts above 127) stay unfused, as K1 reads int8 bytes.
A mesh (a ShardedCounts) goes unfused, as in the JAX package, whose
Pallas pass is not SPMD-partitioned.
"""

import dataclasses
import itertools
import os
import warnings

import numpy as np
import torch

from ..ops import fused_em
from ..ops.counts import DenseCounts
from ..ops.math import normalize, softmax_from_loglik, digamma_triplet
from ..parallel.mesh import CELL_AXIS

__all__ = ["add_doublet_theta", "add_doublet_GT", "predict_doublet",
           "fused_doublet_estep", "doublet_loglik", "takes_fused_estep"]


def _pair_idx(n):
    return np.array(list(itertools.combinations(range(n), 2)),
                    dtype=np.int64).reshape(-1, 2)


def add_doublet_theta(beta_mu, beta_sum):
    """Doublet allelic-rate categories: mean of the pair's means and the
    geometric mean of their concentrations (vireo_doublet.py:85-102)."""
    gi = torch.as_tensor(_pair_idx(beta_mu.shape[1]), device=beta_mu.device)
    mu_db = (beta_mu[:, gi[:, 0]] + beta_mu[:, gi[:, 1]]) / 2.0
    sum_db = torch.sqrt(beta_sum[:, gi[:, 0]] * beta_sum[:, gi[:, 1]])
    return (torch.cat([beta_mu, mu_db], dim=-1),
            torch.cat([beta_sum, sum_db], dim=-1))


def add_doublet_GT(GT_prob):
    """Expanded genotype tensor (n_var, K + C(K,2), G + C(G,2))
    (vireo_doublet.py:105-136)."""
    V, K, G = GT_prob.shape
    dev = GT_prob.device
    gi = torch.as_tensor(_pair_idx(G), device=dev)
    si = torch.as_tensor(_pair_idx(K), device=dev)
    g1, g2 = gi[:, 0], gi[:, 1]

    A = GT_prob[:, si[:, 0], :]        # (V, P, G)
    B = GT_prob[:, si[:, 1], :]
    same = A * B                       # shared-genotype categories
    cross = A[:, :, g1] * B[:, :, g2] + A[:, :, g2] * B[:, :, g1]
    GT_pairs = normalize(torch.cat([same, cross], dim=2), axis=2)

    GT_singlet = torch.cat(
        [GT_prob, GT_prob.new_zeros((V, K, len(gi)))], dim=2)
    return torch.cat([GT_singlet, GT_pairs], dim=1)


def _doublet_weights(gt_both, beta_mu_both, beta_sum_both):
    """Fold the expanded genotype tensor and theta digammas into the two
    (n_var, K_expanded) weight matrices of the cell E-step."""
    d1, d2, ds = digamma_triplet(beta_mu_both * beta_sum_both,
                                 (1.0 - beta_mu_both) * beta_sum_both)
    Wa = torch.sum(gt_both * d1[:, None, :], dim=-1)
    Wb = torch.sum(gt_both * d2[:, None, :], dim=-1)
    Ws = torch.sum(gt_both * ds[:, None, :], dim=-1)
    return Wa - Wb, Wb - Ws


def doublet_loglik(counts, gt_both, beta_mu_both, beta_sum_both):
    """(n_cell, K + C(K,2)) assignment log-likelihood over the expanded
    space (vireo_doublet.py:52-62)."""
    Wfa, Wfd = _doublet_weights(gt_both, beta_mu_both, beta_sum_both)
    return counts.cell_loglik(Wfa, Wfd)


def _doublet_posterior(counts, gt_both, beta_mu_both, beta_sum_both,
                       log_prior_row, n_donor):
    """Unfused E-step posterior and doublet log-likelihood ratio."""
    logLik = doublet_loglik(counts, gt_both, beta_mu_both, beta_sum_both)
    post = softmax_from_loglik(logLik, log_prior_row[None, :])
    llr = (logLik[:, n_donor:].amax(dim=1)
           - logLik[:, :n_donor].amax(dim=1))
    return post, llr


def fused_doublet_estep(counts, gt_both, mu_both, sum_both,
                        log_prior_both, n_donor):
    """The expanded-space E-step and the singlet-slice sufficient
    statistics for the follow-up GT update, from one call of the fused
    kernel. Weights are cast to float32 before the kernel rounds them to
    bf16, as in the JAX package. Returns (S1, SS, ID_prob_both,
    logLik_ID), float32."""
    Wfa, Wfd = _doublet_weights(gt_both, mu_both, sum_both)
    prior = torch.as_tensor(np.asarray(log_prior_both),
                            device=counts.device).to(torch.float32)
    S1, SS, id_prob, loglik, _, _ = fused_em.fused_estep_stats(
        counts.ad, counts.dp, Wfa.to(torch.float32), Wfd.to(torch.float32),
        prior.reshape(1, -1), stats_cols=n_donor)
    return S1, SS, id_prob, loglik


def takes_fused_estep(counts, n_cols, row_prior):
    """Whether the doublet E-step over `n_cols` assignment columns goes
    through K1 (the JAX package's `_fused_doublet_mode`): only when
    VIREO_FUSED_DOUBLET is 1, on, yes, kernel or interpret (all launch
    K1 on a card and run its plain version on the CPU), for int8 dense
    counts on one device, a row-broadcast ID prior, and no more columns
    than K1 takes."""
    knob = os.environ.get("VIREO_FUSED_DOUBLET", "0").lower()
    if knob in ("0", "off", "no", ""):
        return False
    if knob not in ("1", "on", "yes", "kernel", "interpret"):
        warnings.warn("VIREO_FUSED_DOUBLET=%r is not a valid value "
                      "(use 0/1/interpret); keeping the default XLA "
                      "path" % knob)
        return False
    return (row_prior and isinstance(counts, DenseCounts)
            and counts.ad.dtype == torch.int8 and n_cols <= fused_em.MAX_K)


def predict_doublet(vobj, AD, DP=None, update_GT=True, update_ID=True,
                    doublet_rate_prior=None):
    """Predict doublets from a fitted model (vireo_doublet.py:11-82).

    `vobj` is a fitted `models.vireo.Vireo`; returns numpy
    (prob_doublet, prob_singlet, logLik_ratio) and, like the reference,
    refreshes vobj's ID_prob/GT_prob in place when asked.
    """
    counts = vobj._as_counts(AD, DP)
    K = vobj.n_donor
    n_cell = counts.n_cell
    layout = getattr(counts, "layout", None)

    def host(x):
        """A rank's cells' rows -> the global array on the host."""
        if layout is not None:
            x = layout.gather(x, CELL_AXIS, 0)
        return x.cpu().numpy()

    gt_both = add_doublet_GT(vobj.state.gt_prob)
    mu_both, sum_both = add_doublet_theta(vobj.state.beta_mu,
                                          vobj.state.beta_sum)
    n_pair = gt_both.shape[1] - K

    if doublet_rate_prior is None:
        doublet_rate_prior = min(0.5, n_cell / 100000)

    id_prior_np = vobj.ID_prior
    row_prior = id_prior_np.shape[0] == 1
    fused = takes_fused_estep(counts, K + n_pair, row_prior)
    S1 = SS = None
    if row_prior:
        prior_row = np.concatenate(
            [id_prior_np[0] * (1 - doublet_rate_prior),
             np.full(n_pair, doublet_rate_prior / n_pair)])
        if fused:
            S1, SS, post, logLik_ID = fused_doublet_estep(
                counts, gt_both, mu_both, sum_both, np.log(prior_row), K)
            llr = (logLik_ID[:, K:].amax(dim=1)
                   - logLik_ID[:, :K].amax(dim=1))
        else:
            post, llr = _doublet_posterior(
                counts, gt_both, mu_both, sum_both,
                torch.as_tensor(np.log(prior_row)).to(
                    device=counts.device, dtype=vobj.dtype), K)
        ID_prob_both = host(post)
        logLik_ratio = host(llr)
    else:
        id_prior = np.broadcast_to(id_prior_np, (n_cell, K))
        prior_both = np.concatenate(
            [id_prior * (1 - doublet_rate_prior),
             np.full((n_cell, n_pair), doublet_rate_prior / n_pair)],
            axis=1)
        if layout is not None:
            prior_both = layout.take(prior_both, CELL_AXIS, 0)
        logLik_ID = doublet_loglik(counts, gt_both, mu_both, sum_both)
        ID_prob_both = softmax_from_loglik(
            logLik_ID, torch.as_tensor(np.log(prior_both)).to(
                device=logLik_ID.device, dtype=logLik_ID.dtype))
        ID_prob_both = host(ID_prob_both)
        logLik_ID = host(logLik_ID)
        logLik_ratio = (logLik_ID[:, K:].max(axis=1)
                        - logLik_ID[:, :K].max(axis=1))

    if update_ID:
        vobj.ID_prob = ID_prob_both[:, :K]
        if update_GT and S1 is not None:
            # GT refresh straight from the kernel's singlet statistics:
            # no further pass over the counts
            from .vireo import updates_from_stats
            cfg = dataclasses.replace(vobj.config, learn_GT=True,
                                      learn_theta=False)
            _, _, gt_prob, _, _ = updates_from_stats(
                S1.to(vobj.dtype), SS.to(vobj.dtype), vobj.state,
                vobj.priors, cfg, update_theta=False)
            vobj.state = dataclasses.replace(vobj.state, gt_prob=gt_prob)
        elif update_GT:
            vobj.update_GT_prob(counts, None)
    elif update_GT:
        print("For update_GT, please turn on update_ID.")

    return ID_prob_both[:, K:], ID_prob_both[:, :K], logLik_ratio
