"""Core Vireo model: coordinate-ascent VB as plain functions on tensors
(counterpart of vireo_tpu/models/vireo.py).

- state and priors are small dataclasses of tensors; one EM iteration
  is ``em_step(counts, state, priors, cfg, update_theta)``;
- the fit loop is a Python loop with the reference's exact convergence
  predicate, synchronising once per iteration for the ELBO;
- a state may carry a leading restart axis R (where the JAX package
  vmaps): the restarts' (C, K) assignments are folded into one
  (C, R*K) operand, so each contraction over the counts is one matmul
  for all restarts, and the fit loop stops each restart at its own
  convergence and freezes it while the others run.

A thin OO wrapper ``Vireo`` mirrors the reference class API.
"""

import dataclasses

import numpy as np
import torch

from ..ops.math import (softmax_from_loglik, kl_categorical, beta_entropy,
                        digamma_triplet)
from ..utils.device import resolve_device, default_dtype, numpy_dtype

__all__ = ["VireoConfig", "VireoState", "VireoPriors", "FitResult",
           "em_step", "fit_vb", "run_em_iters", "init_state",
           "default_priors", "random_init_arrays", "warn_from_trace",
           "updates_from_stats", "state_from_numpy", "state_to_numpy",
           "priors_from_numpy", "priors_to_numpy", "Vireo"]


def warn_from_trace(trace, n_iter, max_iter, min_iter):
    """Replay the reference's runtime self-checks from a fit's ELBO
    trace: warn on any ELBO decrease > 1e-6 past min_iter and on hitting
    max_iter without convergence. Returns the number of decreases.
    (The JAX package's `style` variants serve BMM and bulk, which are
    not ported yet.)"""
    trace = np.asarray(trace)
    n_decrease = 0
    for it in range(int(n_iter)):
        if it > min_iter:
            if trace[it] < trace[it - 1] - 1e-6:
                n_decrease += 1
                print("Warning: Lower bound decreases!\n")
            elif it == max_iter - 1:
                print("Warning: VB did not converge!\n")
    return n_decrease


@dataclasses.dataclass(frozen=True)
class VireoConfig:
    """Static model configuration (reference constructor flags)."""
    n_var: int
    n_cell: int
    n_donor: int
    n_GT: int = 3
    learn_GT: bool = True
    learn_theta: bool = True
    ASE_mode: bool = False
    fix_beta_sum: bool = False

    @property
    def theta_len(self):
        return self.n_var if self.ASE_mode else 1


_STATE_FIELDS = ("beta_mu", "beta_sum", "gt_prob", "id_prob")
_PRIOR_FIELDS = ("theta_s1", "theta_s2", "id_log", "gt_log")


@dataclasses.dataclass
class VireoState:
    """Variational posterior parameters; each field may carry a leading
    restart axis R."""
    beta_mu: torch.Tensor    # ([R,] theta_len, n_GT)
    beta_sum: torch.Tensor   # ([R,] theta_len, n_GT)
    gt_prob: torch.Tensor    # ([R,] n_var, n_donor, n_GT)
    id_prob: torch.Tensor    # ([R,] n_cell, n_donor)

    @property
    def n_batch(self):
        """Number of restarts, or None for a single state."""
        return self.id_prob.shape[0] if self.id_prob.ndim == 3 else None

    def take(self, idx):
        """Restart `idx` (an int drops the axis; a tensor keeps it)."""
        return VireoState(*(getattr(self, f)[idx] for f in _STATE_FIELDS))

    def put_(self, idx, other):
        """Write the restarts `other` into positions `idx`, in place."""
        for f in _STATE_FIELDS:
            getattr(self, f)[idx] = getattr(other, f)


@dataclasses.dataclass
class VireoPriors:
    """Prior hyper-parameters, log-space for the categorical priors."""
    theta_s1: torch.Tensor   # (1 or theta_len, n_GT)
    theta_s2: torch.Tensor
    id_log: torch.Tensor     # (1 or n_cell, n_donor)
    gt_log: torch.Tensor     # (1 or n_var, n_donor, n_GT)


@dataclasses.dataclass
class FitResult:
    """Outcome of `fit_vb`; numpy values per restart for a batched
    state, scalars for a single one."""
    state: VireoState
    elbo_ref: np.ndarray     # reference-compatible final ELBO (ELBO_[-1])
    elbo_final: np.ndarray   # ELBO of the last executed iteration
    n_iter: np.ndarray
    elbo_trace: np.ndarray   # ([R,] max_iter), NaN beyond n_iter


def _to_tensor(x, dtype, device):
    return torch.as_tensor(np.array(x), device=device).to(dtype)


def state_from_numpy(fields, dtype=None, device=None):
    """A VireoState from a mapping of the JAX VireoState's field names
    to arrays (e.g. ``{f: np.asarray(getattr(jax_state, f)) ...}``)."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    return VireoState(*(_to_tensor(fields[f], dtype, device)
                        for f in _STATE_FIELDS))


def state_to_numpy(state):
    return {f: getattr(state, f).detach().cpu().numpy()
            for f in _STATE_FIELDS}


def priors_from_numpy(fields, dtype=None, device=None):
    """A VireoPriors from a mapping of the JAX VireoPriors' field names
    to arrays."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    return VireoPriors(*(_to_tensor(fields[f], dtype, device)
                         for f in _PRIOR_FIELDS))


def priors_to_numpy(priors):
    return {f: getattr(priors, f).detach().cpu().numpy()
            for f in _PRIOR_FIELDS}


def random_init_arrays(cfg, rng=None, dtype=np.float64):
    """Draw (ID_prob, GT_prob) inits in the reference's order: ID_prob
    first, then GT_prob, from numpy's legacy stream."""
    if rng is None:
        rng = np.random
    id_prob = rng.rand(cfg.n_cell, cfg.n_donor)
    id_prob = id_prob / id_prob.sum(axis=1, keepdims=True)
    gt_prob = rng.rand(cfg.n_var, cfg.n_donor, cfg.n_GT)
    gt_prob = gt_prob / gt_prob.sum(axis=2, keepdims=True)
    return id_prob.astype(dtype), gt_prob.astype(dtype)


def init_state(cfg, beta_mu_init=None, beta_sum_init=None,
               ID_prob_init=None, GT_prob_init=None, rng=None,
               dtype=None, device=None):
    """A VireoState with the reference's defaults. Random draws happen in
    the same order and only for the fields left unset, and every field
    is renormalised in float64 on the host before it is placed, as in
    vireo_tpu/models/vireo.py:132-168."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    if rng is None:
        rng = np.random
    L, G = cfg.theta_len, cfg.n_GT
    if beta_mu_init is None:
        beta_mu = np.ones((L, G)) * np.linspace(0.01, 0.99, G)[None, :]
    else:
        beta_mu = np.broadcast_to(np.asarray(beta_mu_init, np.float64),
                                  (L, G)).copy()
    if beta_sum_init is None:
        beta_sum = np.ones((L, G)) * 50.0
    else:
        beta_sum = np.broadcast_to(np.asarray(beta_sum_init, np.float64),
                                   (L, G)).copy()

    if ID_prob_init is None:
        ID_prob_init = rng.rand(cfg.n_cell, cfg.n_donor)
    ID_prob_init = np.asarray(ID_prob_init, np.float64)
    ID_prob_init = ID_prob_init / ID_prob_init.sum(1, keepdims=True)

    if GT_prob_init is None:
        GT_prob_init = rng.rand(cfg.n_var, cfg.n_donor, cfg.n_GT)
    GT_prob_init = np.asarray(GT_prob_init, np.float64)
    GT_prob_init = GT_prob_init / GT_prob_init.sum(-1, keepdims=True)

    return VireoState(beta_mu=_to_tensor(beta_mu, dtype, device),
                      beta_sum=_to_tensor(beta_sum, dtype, device),
                      gt_prob=_to_tensor(GT_prob_init, dtype, device),
                      id_prob=_to_tensor(ID_prob_init, dtype, device))


def default_priors(cfg, GT_prior=None, ID_prior=None, beta_mu_prior=None,
                   beta_sum_prior=None, min_GP=0.00001, dtype=None,
                   device=None):
    """Priors with the reference's defaults and GT clipping."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    G = cfg.n_GT
    if beta_mu_prior is None:
        beta_mu_prior = np.linspace(0.01, 0.99, G)[None, :]
    beta_mu_prior = np.asarray(beta_mu_prior, np.float64)
    if beta_sum_prior is None:
        beta_sum_prior = np.ones(beta_mu_prior.shape) * 50.0
    beta_sum_prior = np.asarray(beta_sum_prior, np.float64)

    theta_s1 = beta_mu_prior * beta_sum_prior
    theta_s2 = (1.0 - beta_mu_prior) * beta_sum_prior

    if ID_prior is None:
        id_prior = np.full((1, cfg.n_donor), 1.0 / cfg.n_donor)
    else:
        id_prior = np.asarray(ID_prior, np.float64)
        if id_prior.ndim == 1:
            id_prior = id_prior[None, :]

    if GT_prior is None:
        gt_prior = np.full((1, cfg.n_donor, G), 1.0 / G)
    else:
        gt_prior = np.asarray(GT_prior, np.float64).copy()
        if gt_prior.ndim == 2:
            gt_prior = gt_prior[None, :, :]
        gt_prior = np.clip(gt_prior, min_GP, 1.0 - min_GP)
        gt_prior = gt_prior / gt_prior.sum(axis=-1, keepdims=True)

    return VireoPriors(theta_s1=_to_tensor(theta_s1, dtype, device),
                       theta_s2=_to_tensor(theta_s2, dtype, device),
                       id_log=_to_tensor(np.log(id_prior), dtype, device),
                       gt_log=_to_tensor(np.log(gt_prior), dtype, device))


def _theta_suff(S, gt_prob, ase_mode):
    """sum over donors (and variants unless ASE) of S[v,k]*GT[v,k,g]:
    ([R,] V, K) x ([R,] V, K, G) -> ([R,] V or 1, G)."""
    per_var = torch.einsum("...vk,...vkg->...vg", S, gt_prob)
    if ase_mode:
        return per_var
    return per_var.sum(dim=-2, keepdim=True)


def updates_from_stats(S1, SS, state, priors, cfg, update_theta):
    """theta + GT coordinate updates from S1 = AD @ ID_prob and
    SS = DP @ ID_prob (vireo_model.py:165-219).

    Returns (beta_mu, beta_sum, gt_prob, (Wfold_a, Wfold_d),
    KL_GT + KL_theta), where the W matrices fold the reference's three
    transposed products per genotype category into two:
    logLik_ID = AD.T @ Wfold_a + DP.T @ Wfold_d.
    """
    b = state.gt_prob.ndim - 3
    S2 = SS - S1

    t1 = priors.theta_s1 + _theta_suff(S1, state.gt_prob, cfg.ASE_mode)
    t2 = priors.theta_s2 + _theta_suff(S2, state.gt_prob, cfg.ASE_mode)
    if update_theta and cfg.learn_theta:
        beta_mu = t1 / (t1 + t2)
        beta_sum = state.beta_sum if cfg.fix_beta_sum else (t1 + t2)
    else:
        beta_mu, beta_sum = state.beta_mu, state.beta_sum

    d1, d2, ds = digamma_triplet(beta_mu * beta_sum,
                                 (1.0 - beta_mu) * beta_sum)  # ([R,] L, G)
    d1, d2, ds = (x.unsqueeze(-2) for x in (d1, d2, ds))      # ([R,] L, 1, G)

    if cfg.learn_GT:
        logLik_GT = (S1.unsqueeze(-1) * d1 + S2.unsqueeze(-1) * d2
                     - SS.unsqueeze(-1) * ds)
        gt_prob = softmax_from_loglik(logLik_GT, priors.gt_log, axis=-1)
    else:
        gt_prob = state.gt_prob

    Wa = torch.sum(gt_prob * d1, dim=-1)
    Wb = torch.sum(gt_prob * d2, dim=-1)
    Ws = torch.sum(gt_prob * ds, dim=-1)

    KL_GT = kl_categorical(gt_prob, priors.gt_log, batch_ndim=b)
    s1 = beta_mu * beta_sum
    s2 = (1.0 - beta_mu) * beta_sum
    KL_theta = beta_entropy(s1, s2, priors.theta_s1, priors.theta_s2,
                            batch_ndim=b)
    return beta_mu, beta_sum, gt_prob, (Wa - Wb, Wb - Ws), KL_GT + KL_theta


def _fold(x):
    """(R, A, K) -> (A, R*K): restarts side by side as matmul columns."""
    R, A, K = x.shape
    return x.permute(1, 0, 2).reshape(A, R * K)


def _unfold(y, R):
    """(A, R*K) -> (R, A, K)."""
    A = y.shape[0]
    return y.reshape(A, R, -1).permute(1, 0, 2)


def em_step(counts, state, priors, cfg, update_theta):
    """One coordinate-ascent iteration; returns (state', loglik_id, elbo).

    Update order matches the reference: theta (from the previous GT/ID
    posteriors), then GT (with fresh digammas), then ID, then the ELBO
    on the refreshed posteriors. A batched state gives per-restart
    ELBOs.
    """
    R = state.n_batch
    if R is None:
        S1, SS = counts.suff_stats(state.id_prob)
    else:
        S1, SS = (_unfold(s, R) for s in counts.suff_stats(
            _fold(state.id_prob)))

    beta_mu, beta_sum, gt_prob, (Wfa, Wfd), kl_params = \
        updates_from_stats(S1, SS, state, priors, cfg, update_theta)

    if R is None:
        loglik_id = counts.cell_loglik(Wfa, Wfd)
    else:
        loglik_id = _unfold(counts.cell_loglik(_fold(Wfa), _fold(Wfd)), R)
    id_prob = softmax_from_loglik(loglik_id, priors.id_log, axis=-1)

    LB_p = (loglik_id * id_prob).sum(dim=(-2, -1))
    KL_ID = kl_categorical(id_prob, priors.id_log,
                           batch_ndim=0 if R is None else 1)
    elbo = LB_p - KL_ID - kl_params

    new_state = VireoState(beta_mu=beta_mu, beta_sum=beta_sum,
                           gt_prob=gt_prob, id_prob=id_prob)
    return new_state, loglik_id, elbo


def fit_vb(counts, state, priors, cfg, max_iter=200, min_iter=5,
           epsilon_conv=1e-2, delay_fit_theta=0):
    """Run coordinate ascent to convergence (vireo_model.py:251-276).

    The convergence predicate is the reference's, evaluated in the
    state's float type, including its quirk that the recorded final
    ELBO (`elbo_ref`, used to pick among restarts) is the ELBO of the
    second-to-last executed iteration. For a batched state each restart
    runs until its own predicate stops it, and is then left as it was
    while the others go on: the semantics of the JAX package's vmap of
    a while_loop.
    """
    single = state.n_batch is None
    st = VireoState(*(getattr(state, f).unsqueeze(0)
                      for f in _STATE_FIELDS)) if single else state
    R = st.n_batch
    np_t = numpy_dtype(st.id_prob.dtype).type
    eps, tiny = np_t(epsilon_conv), np_t(1e-6)

    it = np.zeros(R, np.int64)
    prev = np.full(R, -np.inf, np_t)
    curr = np.full(R, -np.inf, np_t)
    trace = np.full((R, max_iter), np.nan, np_t)

    def running():
        with np.errstate(invalid="ignore"):
            delta = curr - prev
            breaked = (it - 1 > min_iter) & (delta >= -tiny) & (delta < eps)
        return ~((it >= max_iter) | breaked)

    active = running()
    n = 0
    owned = False   # st holds no tensor of the caller's, so put_ is safe
    while active.any():
        idx = np.nonzero(active)[0]
        if active.all():
            st, _, elbo = em_step(counts, st, priors, cfg,
                                  update_theta=(n >= delay_fit_theta))
            owned = False   # a field not updated is the input's tensor
        else:
            tidx = torch.as_tensor(idx, device=st.id_prob.device)
            new, _, elbo = em_step(counts, st.take(tidx), priors, cfg,
                                   update_theta=(n >= delay_fit_theta))
            if not owned:
                st = VireoState(*(getattr(st, f).clone()
                                  for f in _STATE_FIELDS))
                owned = True
            st.put_(tidx, new)
        elbo = elbo.detach().cpu().numpy().astype(np_t)
        trace[idx, it[idx]] = elbo
        prev[idx] = curr[idx]
        curr[idx] = elbo
        it[idx] += 1
        n += 1
        active = running()

    if single:
        return FitResult(state=st.take(0), elbo_ref=prev[0],
                         elbo_final=curr[0], n_iter=int(it[0]),
                         elbo_trace=trace[0])
    return FitResult(state=st, elbo_ref=prev, elbo_final=curr, n_iter=it,
                     elbo_trace=trace)


def run_em_iters(counts, state, priors, cfg, n_iters):
    """Run exactly `n_iters` EM iterations with every update on (no
    convergence check). Returns (state, last_elbo)."""
    elbo = torch.tensor(float("-inf"), dtype=state.id_prob.dtype)
    for _ in range(int(n_iters)):
        state, _, elbo = em_step(counts, state, priors, cfg,
                                 update_theta=True)
    return state, elbo


class Vireo:
    """OO wrapper mirroring the reference `Vireo` class API on top of the
    functional pieces. Posterior properties return numpy copies; `fit`
    takes numpy/scipy AD, DP or any prebuilt counts object (DenseCounts,
    PackedCounts, HybridCounts, SparseCounts)."""

    def __init__(self, n_cell, n_var, n_donor, n_GT=3, learn_GT=True,
                 learn_theta=True, ASE_mode=False, fix_beta_sum=False,
                 beta_mu_init=None, beta_sum_init=None, ID_prob_init=None,
                 GT_prob_init=None, dtype=None, rng=None, state_init=None,
                 device=None):
        """`state_init`: adopt an existing VireoState as it is, with no
        host inits drawn or renormalised."""
        self.config = VireoConfig(
            n_var=n_var, n_cell=n_cell, n_donor=n_donor, n_GT=n_GT,
            learn_GT=learn_GT, learn_theta=learn_theta, ASE_mode=ASE_mode,
            fix_beta_sum=fix_beta_sum)
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        self._rng = rng
        self.ELBO_ = np.zeros(0)
        if state_init is not None:
            self.state = state_init
        else:
            self.set_initial(beta_mu_init, beta_sum_init, ID_prob_init,
                             GT_prob_init)
        self.set_prior()

    @property
    def n_var(self):
        return self.config.n_var

    @property
    def n_cell(self):
        return self.config.n_cell

    @property
    def n_donor(self):
        return self.config.n_donor

    @property
    def n_GT(self):
        return self.config.n_GT

    @property
    def beta_mu(self):
        return self.state.beta_mu.cpu().numpy()

    @property
    def beta_sum(self):
        return self.state.beta_sum.cpu().numpy()

    @property
    def ID_prob(self):
        return self.state.id_prob.cpu().numpy()

    @ID_prob.setter
    def ID_prob(self, value):
        self.state = dataclasses.replace(
            self.state, id_prob=torch.as_tensor(value).to(
                device=self.device, dtype=self.dtype))

    @property
    def GT_prob(self):
        return self.state.gt_prob.cpu().numpy()

    @property
    def ID_prior(self):
        return np.exp(self.priors.id_log.cpu().numpy())

    @property
    def theta_s1(self):
        return self.beta_mu * self.beta_sum

    @property
    def theta_s2(self):
        return (1 - self.beta_mu) * self.beta_sum

    @property
    def ELBO_iters(self):
        return self.ELBO_

    def set_initial(self, beta_mu_init=None, beta_sum_init=None,
                    ID_prob_init=None, GT_prob_init=None):
        self.state = init_state(
            self.config, beta_mu_init, beta_sum_init, ID_prob_init,
            GT_prob_init, rng=self._rng, dtype=self.dtype,
            device=self.device)

    def set_prior(self, GT_prior=None, ID_prior=None, beta_mu_prior=None,
                  beta_sum_prior=None, min_GP=0.00001):
        self.priors = default_priors(
            self.config, GT_prior, ID_prior, beta_mu_prior,
            beta_sum_prior, min_GP, dtype=self.dtype, device=self.device)

    def _as_counts(self, AD, DP):
        from ..ops.counts import counts_from_scipy
        if hasattr(AD, "suff_stats"):
            return AD
        return counts_from_scipy(AD, DP, device=self.device)

    def fit(self, AD, DP=None, max_iter=200, min_iter=5, epsilon_conv=1e-2,
            delay_fit_theta=0, verbose=True, **kwargs):
        """Single coordinate-ascent fit (multi-init lives in
        engine.wrap.vireo_wrap)."""
        counts = self._as_counts(AD, DP)
        res = fit_vb(counts, self.state, self.priors, self.config,
                     max_iter=max_iter, min_iter=min_iter,
                     epsilon_conv=epsilon_conv,
                     delay_fit_theta=delay_fit_theta)
        self.state = res.state
        if verbose:
            warn_from_trace(res.elbo_trace, res.n_iter, max_iter, min_iter)
        # the reference keeps ELBO[:it], it being the last executed index
        elbo_hist = res.elbo_trace[:max(res.n_iter - 1, 0)]
        elbo_hist = elbo_hist + float(counts.binom_coeff_sum())
        self.ELBO_ = np.append(self.ELBO_, elbo_hist)
        return self

    def update_ID_prob(self, AD, DP):
        """One E-step refresh (vireo_model.py:187-201)."""
        counts = self._as_counts(AD, DP)
        cfg_fixed = dataclasses.replace(self.config, learn_GT=False,
                                        learn_theta=False)
        st, loglik_id, _ = em_step(counts, self.state, self.priors,
                                   cfg_fixed, update_theta=False)
        self.state = st
        return loglik_id.cpu().numpy()

    def update_GT_prob(self, AD, DP):
        """One GT-step refresh keeping theta/ID (vireo_model.py:204-219)."""
        counts = self._as_counts(AD, DP)
        cfg = dataclasses.replace(self.config, learn_GT=True,
                                  learn_theta=False)
        keep_id = self.state.id_prob
        st, _, _ = em_step(counts, self.state, self.priors, cfg,
                           update_theta=False)
        self.state = dataclasses.replace(st, id_prob=keep_id)
