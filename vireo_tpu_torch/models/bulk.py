"""Bulk-sample donor deconvolution: EM over the donor fractions of a
multiplexed bulk sample (counterpart of vireo_tpu/models/bulk.py).

A bulk sample's alt and total counts per variant are a mixture over
donors, whose alt rate at a variant is GT_prob @ theta. The EM runs on
the device in the working type (float64 on the CPU, float32 on a card)
with the stop rule of vireo_tpu/models/bulk.py:53-58, read on the host
once an iteration.
"""

import numpy as np
import torch

from ..utils.device import resolve_device, default_dtype, numpy_dtype

__all__ = ["VireoBulk", "LikRatio_test", "fit_bulk_em", "bulk_loglik"]


def _mix_rate(gt_prob, theta, psi):
    """Per-variant alt-allele rate of the pooled sample:
    sum_k psi_k * sum_g GT[v,k,g] * theta_g."""
    return torch.einsum("vkg,g,k->v", gt_prob, theta, psi)


def bulk_loglik(ad, bd, gt_prob, theta, psi):
    """Binomial log-likelihood of the bulk counts under (theta, psi)."""
    rate = _mix_rate(gt_prob, theta, psi)
    return torch.sum(ad * torch.log(rate) + bd * torch.log(1.0 - rate))


def fit_bulk_em(ad, bd, gt_prob, psi, theta, max_iter=200, min_iter=5,
                epsilon_conv=1e-3, learn_theta=True, delay_fit_theta=0):
    """The EM loop; returns (psi, theta, n_iter, loglik trace (max_iter,),
    NaN past n_iter).

    One iteration: each donor's responsibility for the alt reads (weights
    psi * the donor's alt rate) and the ref reads (psi * its ref rate),
    count-weighted into a new psi; a per-genotype-category theta from the
    same responsibilities when `learn_theta` and past `delay_fit_theta`;
    then the log-likelihood. It stops past min_iter once a gain lies in
    [0, epsilon_conv) (a decrease keeps it running; `warn_from_trace`
    reports it), or at max_iter."""
    np_t = numpy_dtype(psi.dtype).type
    eps = np_t(epsilon_conv)
    trace = np.full(max_iter, np.nan, np_t)
    prev = curr = np_t(-np.inf)
    it = 0
    while it < max_iter and not (it - 1 > min_iter and curr >= prev
                                 and curr - prev < eps):
        donor_rate = torch.einsum("vkg,g->vk", gt_prob, theta)   # (V, K)
        w_alt = donor_rate * psi
        w_ref = (1.0 - donor_rate) * psi
        r_alt = w_alt / w_alt.sum(dim=1, keepdim=True)
        r_ref = w_ref / w_ref.sum(dim=1, keepdim=True)

        psi_new = ad @ r_alt + bd @ r_ref
        psi_new = psi_new / psi_new.sum()
        if learn_theta and it >= delay_fit_theta:
            s1 = ad @ torch.einsum("vkg,vk->vg", gt_prob, r_alt)
            s2 = bd @ torch.einsum("vkg,vk->vg", gt_prob, r_ref)
            theta = s1 / (s1 + s2)
        psi = psi_new
        prev, curr = curr, np_t(float(bulk_loglik(ad, bd, gt_prob, theta,
                                                  psi)))
        trace[it] = curr
        it += 1
    return psi, theta, it, trace


class VireoBulk:
    """Donor fractional abundance psi in a multiplexed bulk sample, given
    genotype probabilities (vireo_bulk.py:8-117)."""

    def __init__(self, n_donor, n_GT=3, psi_init=None,
                 theta_init=(0.01, 0.5, 0.99), dtype=None, device=None):
        self.n_GT = n_GT
        self.n_donor = n_donor
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        # drawn even when inits are given: numpy's stream moves as the
        # reference's does
        self.psi = np.random.dirichlet([1] * n_donor)
        self.theta = np.random.rand(n_GT)
        if psi_init is not None:
            if n_donor != len(psi_init):
                print("Warning: n_donor != len(psi_init)")
            else:
                self.psi = np.asarray(psi_init, np.float64)
        if theta_init is not None:
            if n_GT != len(theta_init):
                print("Warning: n_GT != len(theta_init)")
            else:
                self.theta = np.asarray(theta_init, np.float64)

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x, np.float64),
                               device=self.device).to(self.dtype)

    def fit(self, AD, DP, GT_prob, max_iter=200, min_iter=5,
            epsilon_conv=1e-3, learn_theta=True, delay_fit_theta=0,
            model="EM", verbose=False):
        """Run the EM; logLik is the last iteration's log-likelihood and
        logLik_all the trace before it (vireo_bulk.py:106-108)."""
        ad, dp = self._tensor(AD), self._tensor(DP)
        psi, theta, n_it, trace = fit_bulk_em(
            ad, dp - ad, self._tensor(GT_prob), self._tensor(self.psi),
            self._tensor(self.theta), max_iter=max_iter, min_iter=min_iter,
            epsilon_conv=epsilon_conv, learn_theta=learn_theta,
            delay_fit_theta=delay_fit_theta)
        self.psi = psi.cpu().numpy()
        self.theta = theta.cpu().numpy()
        if verbose:
            from .vireo import warn_from_trace
            warn_from_trace(trace, n_it, max_iter, min_iter, style="bulk")
        self.logLik = trace[n_it - 1]
        self.logLik_all = trace[:max(n_it - 1, 0)]

    def LR_test(self, **kwargs):
        return LikRatio_test(psi=self.psi, theta=self.theta, **kwargs)


def LikRatio_test(psi, psi_null, AD, DP, GT_prob, theta, log=False,
                  device=None):
    """Chi-square likelihood-ratio test of a donor-abundance null
    (vireo_bulk.py:120-167): 2 (LL(psi) - LL(psi_null)) on
    len(psi_null) - 1 degrees of freedom. The log-likelihoods are taken
    on `device` (default: utils/device.py's) in its working type."""
    from scipy.stats import chi2
    device = resolve_device(device)
    dtype = default_dtype(device)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64),
                               device=device).to(dtype)

    ad, dp, gt, th = t(AD), t(DP), t(GT_prob), t(theta)

    def ll(p):
        return float(bulk_loglik(ad, dp - ad, gt, th, t(p)))

    LR = 2.0 * (ll(psi) - ll(psi_null))
    df = len(psi_null) - 1
    pval = chi2.logsf(LR, df) if log else chi2.sf(LR, df)
    return LR, pval
