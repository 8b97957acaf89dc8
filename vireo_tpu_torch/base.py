"""`vireo_tpu_torch.base` mirrors `vireo_tpu.base` (itself the
reference's `vireoSNP.base`): normalisation and log binomial
coefficients, and the matching helpers, under their reference names."""

import numpy as np
import torch
from scipy.special import gammaln

from .ops.math import normalize, loglik_amplify, beta_entropy
from .ops.matching import (match, optimal_match, greed_match,
                           donor_select, get_confusion)

__all__ = ["tensor_normalize", "logbincoeff", "normalize", "loglik_amplify",
           "beta_entropy", "match", "optimal_match", "greed_match",
           "donor_select", "get_confusion"]


def tensor_normalize(X, axis=1):
    """X scaled to sum to one along `axis` (a tensor, or numpy)."""
    if torch.is_tensor(X):
        return normalize(X, axis)
    X = np.asarray(X)
    return X / X.sum(axis=axis, keepdims=True)


def logbincoeff(n, k, is_sparse=False):
    """log [n! / (k! (n-k)!)] via gammaln (vireo_tpu/base.py:18-29); with
    `is_sparse`, scipy matrices and only the entries with 0 < k < n."""
    if is_sparse:
        RV_sparse = n.copy() * 0
        idx = (k > 0).multiply(k < n)
        n = np.array(n[idx]).reshape(-1)
        k = np.array(k[idx]).reshape(-1)
    RV = gammaln(n + 1) - gammaln(k + 1) - gammaln(n - k + 1)
    if is_sparse:
        RV_sparse[idx] += RV
        RV = RV_sparse
    return RV
