"""The plain reference of Vireo's variational EM, written from the
upstream equations (vireoSNP's `vireo_model.py`, `vireo_wrap.py`,
`vireo_doublet.py`) in plain PyTorch. It imports nothing of the program.

One EM iteration, per restart r:

    S1 = AD @ ID,  SS = DP @ ID,  S2 = SS - S1                (V, K)
    theta (from iteration `delay_fit_theta` on):
        s1 = prior_s1 + sum_vk S1 GT,  s2 = prior_s2 + sum_vk S2 GT
        mu = s1 / (s1 + s2),  sum = s1 + s2                    (G,)
    d1, d2, ds = digamma(mu sum), digamma((1 - mu) sum), digamma(sum)
    GT = softmax_g(S1 d1 + S2 d2 - SS ds + log GT_prior)       (V, K, G)
    loglik = AD.T @ (GT.d1 - GT.d2) + DP.T @ (GT.d2 - GT.ds)   (C, K)
    ID = softmax_k(loglik + log ID_prior)
    ELBO = sum(loglik ID) - KL(ID) - KL(GT) - KL(theta)

A fit stops at the first iteration i > min_iter whose ELBO rose by
less than `epsilon_conv` and fell by no more than 1e-6, or at max_iter;
its recorded ELBO is that of the iteration before the last, as
upstream's `ELBO_[:it]` keeps. The restarts are independent: they share
one contraction (their assignments side by side as columns) and each is
frozen once its own test stops it.

Seeded inits are drawn from numpy's legacy stream seeded once, restart
by restart, the assignments (n_cell, K) first and the genotypes
(n_var, K, G) second, each normalised in float64 (upstream's
`Vireo.set_initial`, called once a restart by `vireo_wrap`).
"""

import itertools

import numpy as np
import torch

from .counts import Arith, RefCounts

__all__ = ["Arith", "RefCounts", "draw_inits", "fit", "warm", "finish",
           "vireo_wrap", "sweep_n_donor", "doublet"]

N_GT = 3
THETA_MU = np.linspace(0.01, 0.99, N_GT)
THETA_SUM = 50.0


def _xlogy_kl(P, log_prior):
    """sum P (log P - log prior), zero terms where P is 0, per leading
    restart."""
    logP = torch.log(torch.where(P > 0, P, torch.ones_like(P)))
    terms = torch.where(P > 0, P * (logP - log_prior), torch.zeros_like(P))
    return terms.reshape(P.shape[0], -1).sum(-1)


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def _beta_kl(p1, p2, q1, q2):
    """KL(Beta(p1, p2) || Beta(q1, q2)), elementwise."""
    dg = torch.special.digamma
    return (_betaln(q1, q2) - _betaln(p1, p2) + (p1 - q1) * dg(p1)
            + (p2 - q2) * dg(p2) + (q1 + q2 - p1 - p2) * dg(p1 + p2))


def _softmax(x, dim):
    x = x - x.amax(dim=dim, keepdim=True)
    e = torch.exp(x)
    return e / e.sum(dim=dim, keepdim=True)


def _digammas(mu, total):
    dg = torch.special.digamma
    return dg(mu * total), dg((1 - mu) * total), dg(total)


def draw_inits(rs, n_init, n_var, n_cell, K):
    """`n_init` restarts' (ID, GT) inits from numpy RandomState `rs`, in
    upstream's order, normalised in float64."""
    ids = np.empty((n_init, n_cell, K))
    gts = np.empty((n_init, n_var, K, N_GT))
    for r in range(n_init):
        x = rs.rand(n_cell, K)
        ids[r] = x / x.sum(1, keepdims=True)
        g = rs.rand(n_var, K, N_GT)
        gts[r] = g / g.sum(-1, keepdims=True)
    return ids, gts


class _State:
    """Restart-batched posteriors: ID (R, C, K), GT (R, V, K, G), theta
    mu and sum (R, G)."""

    def __init__(self, ID, GT, mu, total):
        self.ID, self.GT, self.mu, self.total = ID, GT, mu, total

    def where(self, keep, other):
        """This state where `keep` (R,) is true, `other` elsewhere."""
        def pick(a, b):
            k = keep.reshape((-1,) + (1,) * (a.ndim - 1))
            return torch.where(k, a, b)
        return _State(pick(self.ID, other.ID), pick(self.GT, other.GT),
                      pick(self.mu, other.mu), pick(self.total, other.total))

    def take(self, r):
        return _State(self.ID[r:r + 1], self.GT[r:r + 1], self.mu[r:r + 1],
                      self.total[r:r + 1])


def _fold(x):
    """(R, A, K) -> (A, R*K)."""
    R, A, K = x.shape
    return x.permute(1, 0, 2).reshape(A, R * K)


def _unfold(y, R):
    """(A, R*K) -> (R, A, K)."""
    return y.reshape(y.shape[0], R, -1).permute(1, 0, 2)


def _step(counts, st, arith, update_theta):
    """One EM iteration of every restart; returns (state', ELBO (R,))."""
    R, _, K = st.ID.shape
    dt = arith.dtype
    dev = st.ID.device
    q_mu = torch.as_tensor(THETA_MU, dtype=dt, device=dev)
    q1, q2 = q_mu * THETA_SUM, (1 - q_mu) * THETA_SUM

    S1, SS = (_unfold(s, R) for s in counts.stats(_fold(st.ID), arith))
    S2 = SS - S1
    mu, total = st.mu, st.total
    if update_theta:
        s1 = q1 + torch.einsum("rvk,rvkg->rg", S1, st.GT)
        s2 = q2 + torch.einsum("rvk,rvkg->rg", S2, st.GT)
        mu, total = s1 / (s1 + s2), s1 + s2
    d1, d2, ds = (d[:, None, None, :] for d in _digammas(mu, total))
    log_gt_prior = float(np.log(1.0 / N_GT))
    GT = _softmax(S1[..., None] * d1 + S2[..., None] * d2
                  - SS[..., None] * ds + log_gt_prior, dim=-1)
    Wa, Wb, Ws = ((GT * d).sum(-1) for d in (d1, d2, ds))
    loglik = _unfold(counts.loglik(_fold(Wa - Wb), _fold(Wb - Ws), arith), R)
    log_id_prior = float(np.log(1.0 / K))
    ID = _softmax(loglik + log_id_prior, dim=-1)

    elbo = ((loglik * ID).reshape(R, -1).sum(-1)
            - _xlogy_kl(ID, torch.full_like(ID, log_id_prior))
            - _xlogy_kl(GT, torch.full_like(GT, log_gt_prior))
            - _beta_kl(mu * total, (1 - mu) * total, q1, q2).sum(-1))
    return _State(ID, GT, mu, total), elbo


def fit(counts, st, arith, max_iter, min_iter=5, epsilon_conv=1e-2,
        delay_fit_theta=0):
    """Run every restart of `st` to its own stop. Returns (state,
    recorded ELBO per restart (numpy), iterations per restart)."""
    R = st.ID.shape[0]
    trace = np.full((R, max_iter), np.nan)
    n_iter = np.zeros(R, np.int64)
    active = np.ones(R, bool)
    for i in range(max_iter):
        new, elbo = _step(counts, st, arith, update_theta=i >= delay_fit_theta)
        keep = torch.as_tensor(active, device=st.ID.device)
        st = new.where(keep, st)
        elbo = elbo.cpu().numpy().astype(np.float64)
        for r in np.flatnonzero(active):
            trace[r, i] = elbo[r]
            n_iter[r] = i + 1
            if i > min_iter:
                delta = trace[r, i] - trace[r, i - 1]
                if -1e-6 <= delta < epsilon_conv:
                    active[r] = False
        if not active.any():
            break
    recorded = trace[np.arange(R), np.maximum(n_iter - 2, 0)]
    return st, recorded, n_iter


def _inits(rs, n_init, counts, K, arith, device):
    ids, gts = draw_inits(rs, n_init, counts.n_var, counts.n_cell, K)
    dt = arith.dtype
    mu = torch.as_tensor(THETA_MU, dtype=dt, device=device).expand(
        n_init, N_GT).contiguous()
    total = torch.full((n_init, N_GT), THETA_SUM, dtype=dt, device=device)
    return _State(torch.as_tensor(ids, device=device).to(dt),
                  torch.as_tensor(gts, device=device).to(dt), mu, total)


def _pairs(n):
    return list(itertools.combinations(range(n), 2))


def doublet(counts, st, arith, doublet_rate):
    """upstream `predict_doublet` on the single fitted state `st`:
    the assignment E-step over the K donors and their C(K,2) pairs, then
    the genotype refresh from the singlet posteriors. Returns numpy
    (singlet probs (C, K), doublet probs (C, P), LLR (C,)) and the
    refreshed GT (V, K, G)."""
    GT, mu, total = st.GT[0], st.mu[0], st.total[0]
    V, K, G = GT.shape
    dpair = _pairs(K)
    gpair = _pairs(G)
    a = GT[:, [p[0] for p in dpair], :]
    b = GT[:, [p[1] for p in dpair], :]
    cross = [a[:, :, g1] * b[:, :, g2] + a[:, :, g2] * b[:, :, g1]
             for g1, g2 in gpair]
    gt_pairs = torch.cat([a * b, torch.stack(cross, -1)], -1)
    gt_pairs = gt_pairs / gt_pairs.sum(-1, keepdim=True)
    gt_single = torch.cat([GT, GT.new_zeros((V, K, len(gpair)))], -1)
    gt_both = torch.cat([gt_single, gt_pairs], 1)
    mu_both = torch.cat([mu, torch.stack([(mu[g1] + mu[g2]) / 2
                                          for g1, g2 in gpair])])
    sum_both = torch.cat([total, torch.stack([torch.sqrt(total[g1]
                                                         * total[g2])
                                              for g1, g2 in gpair])])
    d1, d2, ds = _digammas(mu_both, sum_both)
    Wa, Wb, Ws = ((gt_both * d).sum(-1) for d in (d1, d2, ds))
    loglik = counts.loglik(Wa - Wb, Wb - Ws, arith)
    P = len(dpair)
    prior = np.concatenate([np.full(K, (1 - doublet_rate) / K),
                            np.full(P, doublet_rate / P)])
    post = _softmax(loglik + torch.as_tensor(np.log(prior), device=loglik.device,
                                             dtype=loglik.dtype), dim=1)
    llr = loglik[:, K:].amax(1) - loglik[:, :K].amax(1)

    # the genotype refresh: one GT step from the singlet posteriors, theta
    # kept
    S1, SS = counts.stats(post[:, :K].contiguous(), arith)
    d1, d2, ds = _digammas(mu, total)
    GT_new = _softmax(S1[..., None] * d1 + (SS - S1)[..., None] * d2
                      - SS[..., None] * ds + float(np.log(1.0 / G)), dim=-1)
    post = post.cpu().numpy()
    return (post[:, :K], post[:, K:], llr.cpu().numpy(),
            GT_new.cpu().numpy())


def warm(counts, n_donor, n_init, seed, arith, max_iter_init=20,
         delay_fit_theta=3, device=None):
    """upstream's warm restarts: (batched state, LB_list: each restart's
    ELBO with the binomial constant, the binomial constant)."""
    rs = np.random.RandomState(seed)
    binom = counts.binom_sum()
    st = _inits(rs, n_init, counts, n_donor, arith, device)
    st, warm_elbo, _ = fit(counts, st, arith, max_iter=max_iter_init,
                           delay_fit_theta=delay_fit_theta)
    return st, warm_elbo + binom, binom


def finish(counts, st, LB_list, binom, best, arith):
    """The refit of restart `best` to convergence and the doublet phase.
    Returns vireo_wrap's dict."""
    one = st.take(best)
    # the refit starts from the winner renormalised, as upstream's model
    # object holds it
    one.ID = one.ID / one.ID.sum(-1, keepdim=True)
    one.GT = one.GT / one.GT.sum(-1, keepdim=True)
    one, refit_elbo, refit_iters = fit(counts, one, arith, max_iter=200)
    n_done = int(refit_iters[0])
    LB_doublet = (float(refit_elbo[0]) + binom) if n_done >= 2 \
        else float(LB_list[best])
    ID, dbl, llr, GT = doublet(counts, one, arith,
                               min(0.5, counts.n_cell / 100000))
    return dict(LB_list=LB_list, best=best, refit_iters=n_done,
                LB_doublet=LB_doublet, ID_prob=ID, doublet_prob=dbl,
                doublet_LLR=llr, GT_prob=GT)


def vireo_wrap(counts, n_donor, n_init, seed, arith, max_iter_init=20,
               delay_fit_theta=3, device=None):
    """upstream `vireo_wrap` without a genotype prior: `n_init` warm
    restarts, the best (the first largest recorded ELBO) refit to
    convergence, then the doublet phase.

    Returns a dict: LB_list (the restarts' ELBOs with the binomial
    constant), best, refit_iters, LB_doublet, ID_prob, doublet_prob,
    doublet_LLR, GT_prob."""
    st, LB_list, binom = warm(counts, n_donor, n_init, seed, arith,
                              max_iter_init, delay_fit_theta, device)
    best = int(np.argmax(LB_list))
    return finish(counts, st, LB_list, binom, best, arith)


def sweep_n_donor(counts, n_donor_list, n_init, seed, arith,
                  max_iter_init=20, delay_fit_theta=3, device=None):
    """The ELBO sweep over donor counts: each K's restarts drawn in turn
    from one seeded stream and fitted as the warm restarts are. Returns
    {K: recorded ELBOs with the binomial constant, "best": K of the
    largest ELBO, the first K in the list on a tie}."""
    rs = np.random.RandomState(seed)
    binom = counts.binom_sum()
    out = {}
    for K in n_donor_list:
        st = _inits(rs, n_init, counts, int(K), arith, device)
        _, elbo, _ = fit(counts, st, arith, max_iter=max_iter_init,
                         delay_fit_theta=delay_fit_theta)
        out[int(K)] = elbo + binom
        del st
    out["best"] = int(max(n_donor_list, key=lambda K: out[int(K)].max()))
    return out
