"""Binomial mixture model (clone reconstruction) with batched restarts
(counterpart of vireo_tpu/models/bmm.py).

Per-variant, per-cluster Beta posteriors and no genotype tensor. The
n_init restarts run as one batched fit, as vireo's warm restarts do in
`models/vireo.py`: the restarts' (C, K) assignments are folded into the
columns of one `suff_stats` and one `cell_loglik` call an iteration
(N = n_init x K; K2 and K3 on packed counts), and each restart stops at
its own convergence test (`vireo.converge`).
"""

import dataclasses

import numpy as np
import torch

from ..ops.math import (softmax_from_loglik, kl_categorical, beta_entropy,
                        digamma_triplet)
from ..utils.device import resolve_device, default_dtype
from .vireo import _fold, _unfold, converge, warn_from_trace

__all__ = ["BmmState", "BmmPriors", "bmm_step", "fit_bmm", "BinomMixtureVB"]


@dataclasses.dataclass
class BmmState:
    """Posterior parameters; each field may carry a leading restart axis
    R."""
    beta_mu: torch.Tensor    # ([R,] n_var, n_donor)
    beta_sum: torch.Tensor   # ([R,] n_var, n_donor)
    id_prob: torch.Tensor    # ([R,] n_cell, n_donor)

    @property
    def n_batch(self):
        """Number of restarts, or None for a single state."""
        return self.id_prob.shape[0] if self.id_prob.ndim == 3 else None

    def take(self, idx):
        """Restart `idx` (an int drops the axis; a tensor keeps it)."""
        return BmmState(self.beta_mu[idx], self.beta_sum[idx],
                        self.id_prob[idx])

    def put_(self, idx, other):
        """Write the restarts `other` into positions `idx`, in place."""
        self.beta_mu[idx] = other.beta_mu
        self.beta_sum[idx] = other.beta_sum
        self.id_prob[idx] = other.id_prob

    def clone(self):
        return BmmState(self.beta_mu.clone(), self.beta_sum.clone(),
                        self.id_prob.clone())


@dataclasses.dataclass
class BmmPriors:
    theta_s1: torch.Tensor   # (n_var, n_donor)
    theta_s2: torch.Tensor
    id_log: torch.Tensor     # (1 or n_cell, n_donor)


def bmm_step(counts, state, priors, fix_beta_sum=False):
    """One coordinate-ascent iteration in the reference's order (theta
    update, expected log-likelihood, ID update, ELBO); returns (state',
    loglik_id, elbo), the ELBO per restart for a batched state."""
    R = state.n_batch
    if R is None:
        S1, SS = counts.suff_stats(state.id_prob)
    else:
        S1, SS = (_unfold(s, R) for s in counts.suff_stats(
            _fold(state.id_prob)))
    S2 = SS - S1
    t1 = S1 + priors.theta_s1
    t2 = S2 + priors.theta_s2
    beta_mu = t1 / (t1 + t2)
    beta_sum = state.beta_sum if fix_beta_sum else (t1 + t2)
    s1 = beta_mu * beta_sum
    s2 = (1.0 - beta_mu) * beta_sum

    d1, d2, ds = digamma_triplet(s1, s2)
    # E[logLik] = AD.T @ d1 + BD.T @ d2 - DP.T @ ds, folded to two terms
    if R is None:
        loglik_id = counts.cell_loglik(d1 - d2, d2 - ds)
    else:
        loglik_id = _unfold(counts.cell_loglik(_fold(d1 - d2),
                                               _fold(d2 - ds)), R)
    id_prob = softmax_from_loglik(loglik_id, priors.id_log, axis=-1)

    b = 0 if R is None else 1
    LB_p = (loglik_id * id_prob).sum(dim=(-2, -1))
    KL_ID = kl_categorical(id_prob, priors.id_log, batch_ndim=b)
    KL_theta = beta_entropy(s1, s2, priors.theta_s1, priors.theta_s2,
                            batch_ndim=b)
    return BmmState(beta_mu, beta_sum, id_prob), loglik_id, \
        LB_p - KL_ID - KL_theta


def fit_bmm(counts, state, priors, max_iter=200, min_iter=20,
            epsilon_conv=1e-2, fix_beta_sum=False):
    """The VB loop with the reference's convergence test (a gain in
    [-1e-6, epsilon_conv) past min_iter, bmm_model.py:178-201). Returns
    (state, elbo_ref, elbo_final, n_iter, trace), per restart for a
    batched state."""
    def step(st, n):
        st, _, elbo = bmm_step(counts, st, priors, fix_beta_sum=fix_beta_sum)
        return st, elbo

    return converge(step, state, max_iter, min_iter, epsilon_conv)


class BinomMixtureVB:
    """The reference class API (bmm_model.py:9-263). `fit` runs all
    n_init random restarts as one batched fit, keeps the best by final
    ELBO, and refits it to convergence."""

    def __init__(self, n_cell, n_var, n_donor, fix_beta_sum=False,
                 beta_mu_init=None, beta_sum_init=None, ID_prob_init=None,
                 dtype=None, device=None):
        self.n_var = n_var
        self.n_cell = n_cell
        self.n_donor = n_donor
        self.fix_beta_sum = fix_beta_sum
        self.beta_mu_init = beta_mu_init
        self.beta_sum_init = beta_sum_init
        self.ID_prob_init = ID_prob_init
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        self.set_prior()
        self.set_initial(beta_mu_init, beta_sum_init, ID_prob_init)

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x), device=self.device).to(
            self.dtype)

    def set_initial(self, beta_mu_init=None, beta_sum_init=None,
                    ID_prob_init=None, rng=None):
        """Defaults per bmm_model.py:65-85: beta_mu 0.5, beta_sum 30,
        ID_prob drawn from `rng` (numpy's global stream by default) and
        normalised in float64."""
        if rng is None:
            rng = np.random
        beta_mu = (np.ones((self.n_var, self.n_donor)) * 0.5
                   if beta_mu_init is None else np.asarray(beta_mu_init))
        beta_sum = (np.ones(beta_mu.shape) * 30.0
                    if beta_sum_init is None else np.asarray(beta_sum_init))
        if ID_prob_init is None:
            id_prob = rng.rand(self.n_cell, self.n_donor)
        else:
            id_prob = np.asarray(ID_prob_init, np.float64)
        id_prob = id_prob / id_prob.sum(1, keepdims=True)
        self.state = BmmState(self._tensor(beta_mu), self._tensor(beta_sum),
                              self._tensor(id_prob))
        self.ELBO_iters = np.array([])

    def set_prior(self, ID_prior=None, beta_mu_prior=None,
                  beta_sum_prior=None):
        """Defaults per bmm_model.py:87-105: Beta(1, 1) (mu 0.5, sum 2)
        and a uniform ID prior."""
        if beta_mu_prior is None:
            beta_mu_prior = np.ones((self.n_var, self.n_donor)) * 0.5
        if beta_sum_prior is None:
            beta_sum_prior = np.ones(np.shape(beta_mu_prior)) * 2.0
        beta_mu_prior = np.asarray(beta_mu_prior, np.float64)
        beta_sum_prior = np.asarray(beta_sum_prior, np.float64)
        if ID_prior is not None:
            id_prior = np.asarray(ID_prior, np.float64)
            if id_prior.ndim == 1:
                id_prior = id_prior[None, :]
        else:
            id_prior = np.full((1, self.n_donor), 1.0 / self.n_donor)
        self.priors = BmmPriors(
            self._tensor(beta_mu_prior * beta_sum_prior),
            self._tensor((1 - beta_mu_prior) * beta_sum_prior),
            self._tensor(np.log(id_prior)))

    @property
    def beta_mu(self):
        return self.state.beta_mu.cpu().numpy()

    @property
    def beta_sum(self):
        return self.state.beta_sum.cpu().numpy()

    @property
    def ID_prob(self):
        return self.state.id_prob.cpu().numpy()

    @property
    def theta_s1(self):
        return self.beta_mu * self.beta_sum

    @property
    def theta_s2(self):
        return (1 - self.beta_mu) * self.beta_sum

    def _as_counts(self, AD, DP):
        """Any counts object as it is (every rung: DenseCounts,
        PackedCounts, HybridCounts, SparseCounts); scipy or numpy counts
        placed by `counts_from_scipy`. JAX's version accepts only its
        dense and sparse classes (vireo_tpu/models/bmm.py:175-179)."""
        from ..ops.counts import counts_from_scipy
        if hasattr(AD, "suff_stats"):
            return AD
        return counts_from_scipy(AD, DP, device=self.device)

    def fit(self, AD, DP=None, n_init=10, max_iter=200, max_iter_pre=100,
            random_seed=None, min_iter=20, epsilon_conv=1e-2,
            verbose=True, rng=None):
        """Multi-init fit (bmm_model.py:204-263): batched warm restarts,
        best-ELBO selection, a long refit, and the binomial constant
        added to every reported ELBO (`ELBO_inits`, `ELBO_iters`)."""
        if random_seed is not None:
            np.random.seed(random_seed)
        if rng is None:
            rng = np.random
        counts = self._as_counts(AD, DP)
        binom_coeff = float(counts.binom_coeff_sum())

        # restart inits drawn one after another (the reference's order)
        inits = []
        for _ in range(n_init):
            self.set_initial(self.beta_mu_init, self.beta_sum_init,
                             self.ID_prob_init, rng=rng)
            inits.append(self.state)
        batched = BmmState(*(torch.stack([getattr(s, f.name) for s in inits])
                             for f in dataclasses.fields(BmmState)))

        st_all, elbo_ref, _, n_it, traces = fit_bmm(
            counts, batched, self.priors, max_iter=max_iter_pre,
            min_iter=min_iter, epsilon_conv=epsilon_conv,
            fix_beta_sum=self.fix_beta_sum)
        best = int(np.argmax(elbo_ref))
        self.ELBO_inits = elbo_ref + binom_coeff

        if verbose:
            # the reference's per-restart self-checks (bmm_model.py:
            # 190-199), replayed from the traces
            for i in range(n_init):
                warn_from_trace(traces[i], n_it[i], max_iter_pre, min_iter,
                                style="bmm")

        n_best = int(n_it[best])
        warm_trace = traces[best][:max(n_best - 1, 0)]
        st, _, _, it2, trace2 = fit_bmm(
            counts, st_all.take(best), self.priors, max_iter=max_iter,
            min_iter=min_iter, epsilon_conv=epsilon_conv,
            fix_beta_sum=self.fix_beta_sum)
        self.state = st
        if verbose:
            warn_from_trace(trace2, it2, max_iter, min_iter, style="bmm")
        final_trace = trace2[:max(int(it2) - 1, 0)]
        self.ELBO_iters = np.concatenate([warm_trace, final_trace]) \
            + binom_coeff
        return self
