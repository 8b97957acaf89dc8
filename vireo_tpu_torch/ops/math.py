"""Math shared by the port's models (counterpart of vireo_tpu/ops/math.py).

Softmax helpers, Beta-distribution KL in closed form and log-binomial
coefficients, on torch tensors of any float type. The sums that JAX
takes over a whole array take a `batch_ndim` here: the leading
`batch_ndim` axes are kept, which is how the batched warm restarts get
one value per restart (JAX gets that from `vmap`).
"""

import torch

__all__ = ["betaln", "normalize", "loglik_amplify", "softmax_from_loglik",
           "kl_categorical", "beta_entropy", "log_binom_coeff",
           "digamma_triplet"]


def _sum_trailing(x, batch_ndim):
    if batch_ndim == 0:
        return x.sum()
    return x.reshape(*x.shape[:batch_ndim], -1).sum(-1)


def betaln(a, b):
    """log Beta(a, b) as a composition of lgamma, as in the JAX package:
    the composition agrees with scipy's betaln to round-off, which the
    convergence predicate needs (vireo_tpu/ops/math.py:15-24)."""
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def normalize(X, axis=-1):
    """Scale slices along `axis` to sum to one."""
    return X / X.sum(dim=axis, keepdim=True)


def loglik_amplify(X, axis=-1):
    """Subtract the max along `axis` for a numerically stable exp."""
    return X - X.amax(dim=axis, keepdim=True)


def softmax_from_loglik(logLik, log_prior, axis=-1):
    """Posterior = normalize(exp(amplify(logLik + log_prior)))."""
    return normalize(torch.exp(loglik_amplify(logLik + log_prior,
                                              axis=axis)), axis=axis)


def kl_categorical(P, logP_prior, batch_ndim=0):
    """sum P * (log P - log prior); zero-probability entries add zero
    (the xlogy convention of vireo_tpu/ops/math.py:54-62)."""
    pos = P > 0
    safe_logP = torch.log(torch.where(pos, P, torch.ones_like(P)))
    terms = torch.where(pos, P * (safe_logP - logP_prior),
                        torch.zeros_like(P))
    return _sum_trailing(terms, batch_ndim)


def _beta_cross_entropy(p1, p2, q1, q2):
    """-E_p[log q] for Beta distributions, elementwise."""
    return (betaln(q1, q2)
            - (q1 - 1.0) * torch.special.digamma(p1)
            - (q2 - 1.0) * torch.special.digamma(p2)
            + (q1 + q2 - 2.0) * torch.special.digamma(p1 + p2))


def beta_entropy(s1, s2, s1_prior=None, s2_prior=None, batch_ndim=0):
    """Sum of Beta entropies, or KL(post || prior) when priors are given."""
    if s1_prior is None:
        return _sum_trailing(_beta_cross_entropy(s1, s2, s1, s2),
                             batch_ndim)
    terms = (_beta_cross_entropy(s1, s2, s1_prior, s2_prior)
             - _beta_cross_entropy(s1, s2, s1, s2))
    return _sum_trailing(terms, batch_ndim)


def log_binom_coeff(dp, ad, max_val=700.0):
    """log C(dp, ad) elementwise on float tensors, 0 where dp == 0,
    clipped at `max_val` (the reference's 700 clip)."""
    val = (torch.lgamma(dp + 1.0) - torch.lgamma(ad + 1.0)
           - torch.lgamma(dp - ad + 1.0))
    val = torch.clamp(val, max=max_val)
    return torch.where(dp > 0, val, torch.zeros_like(val))


def digamma_triplet(s1, s2):
    """(digamma(s1), digamma(s2), digamma(s1 + s2))."""
    dg = torch.special.digamma
    return dg(s1), dg(s2), dg(s1 + s2)
