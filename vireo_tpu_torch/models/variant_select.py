"""Discriminatory-variant selection (counterpart of
vireo_tpu/models/variant_select.py).

- `variant_select`: greedy information-gain selection of a minimal SNP
  set whose genotype "barcode" tells every donor apart. Host numpy, with
  the reference's tie-break: a seeded np.random pick among the ties
  that pass a median filter on the variants' counts.
- `variant_ELBO_gain`: per-variant evidence gain of the multi-donor
  model over a single-donor one, on the counts classes (one
  `suff_stats`: K0 on the dense rung, K2 on the packed rung).
"""

import numpy as np
import torch

from ..utils.device import default_dtype

__all__ = ["barcode_entropy", "variant_select", "variant_ELBO_gain"]


def _sorted_group_sizes(codes):
    """Canonical (descending) group-size vector of an integer labeling:
    two labelings of one partition structure then have bitwise equal
    entropies, which the greedy loop's exact tie test needs."""
    sizes = np.unique(codes, return_counts=True)[1]
    sizes[::-1].sort()
    return sizes


def barcode_entropy(X, y=None):
    """Entropy (base 2) of the donor partition induced by barcode list
    `X`, optionally refined by the categories in `y`; returns
    (entropy, refined barcode strings). The barcode of donor k is
    str(X[k]) + str(y[k])."""
    if y is None:
        Z_str = [str(x) for x in X]
    else:
        if len(X) != len(y):
            print("Error: X and y have different length in "
                  "barcode_entropy.")
            return None, None
        Z_str = [str(a) + str(b) for a, b in zip(X, y)]
    sizes = _sorted_group_sizes(np.asarray(Z_str))
    p = sizes / len(Z_str)
    return float(-(p * np.log2(p)).sum()), Z_str


def _refinement_entropies(group, codes, n_codes):
    """Base-2 entropy of every candidate refinement at once.

    group: (K,) current donor-partition labels; codes: (n_var, K)
    per-variant category labels. Variant i refines the partition by the
    pair (group[k], codes[i, k]). Returns (n_var,) entropies and the
    pair keys.
    """
    n_var, K = codes.shape
    pair = group[None, :].astype(np.int64) * n_codes + codes  # (V, K)

    # run-length count the groups of each row after an in-row sort
    srt = np.sort(pair, axis=1)
    is_start = np.concatenate(
        [np.ones((n_var, 1), bool), srt[:, 1:] != srt[:, :-1]], axis=1)
    seg = np.cumsum(is_start, axis=1) - 1                     # (V, K)
    n_seg = int(seg.max()) + 1
    flat = np.arange(n_var, dtype=np.int64)[:, None] * n_seg + seg
    sizes = np.bincount(flat.ravel(),
                        minlength=n_var * n_seg).reshape(n_var, n_seg)

    # canonical order (descending) -> ties are bitwise-stable
    sizes = -np.sort(-sizes, axis=1)
    p = sizes / K
    plogp = np.where(sizes > 0, p * np.log2(np.where(p > 0, p, 1.0)), 0.0)
    return -plogp.sum(axis=1), pair


def variant_select(GT, var_count=None, rand_seed=0):
    """Greedy minimal-barcode variant selection.

    Each round scores every variant by the entropy of the donor
    partition it would refine, keeps the largest, and stops when no
    variant improves it. Ties are filtered to var_count >= their median,
    then broken by `np.random.randint` after `np.random.seed(rand_seed)`:
    the reference's draws, in its order, so GTbarcode's golden output
    is reproduced.

    Returns (entropy, barcode strings per donor, chosen variant list).
    """
    np.random.seed(rand_seed)
    GT = np.asarray(GT)
    n_var, K = GT.shape

    # factor the categorical values once; refinement only needs codes
    cats, flat_codes = np.unique(GT.astype(str), return_inverse=True)
    codes = flat_codes.reshape(n_var, K).astype(np.int64)
    n_codes = len(cats)

    group = np.zeros(K, np.int64)      # all donors in one class
    barcode = ["#"] * K                # reference's printable form
    entropy_now = 0.0
    chosen = []

    while True:
        ent_all, pair = _refinement_entropies(group, codes, n_codes)
        best = ent_all.max()
        if best == entropy_now:
            break
        idx = np.flatnonzero(ent_all == best)
        if var_count is not None:
            idx = idx[var_count[idx] >= np.median(var_count[idx])]
        print("Randomly select 1 more variants out %d" % len(idx))
        pick = int(idx[np.random.randint(len(idx))])

        chosen.append(pick)
        group = np.unique(pair[pick], return_inverse=True)[1]
        barcode = [b + str(g) for b, g in zip(barcode, GT[pick, :])]
        entropy_now = ent_all[pick]

    if entropy_now < np.log2(K):
        print("Warning: variant_select can't distinguish all samples.")

    return float(entropy_now), barcode, chosen


def variant_ELBO_gain(counts, ID_prob, pseudocount=0.5):
    """ELBO gain of the multi-donor model over a single-donor model per
    variant, an (n_var,) tensor on the counts' device.

    `ID_prob` (n_cell, K): a tensor is used in its own type, numpy in
    the device's working type (float32 on a card, float64 on the CPU),
    which then carries the digamma and logsumexp."""
    if not torch.is_tensor(ID_prob):
        ID_prob = torch.as_tensor(np.asarray(ID_prob)).to(
            default_dtype(counts.device))
    ID_prob = ID_prob.to(counts.device)
    dg = torch.special.digamma
    S1, SS = counts.suff_stats(ID_prob)
    s1 = S1 + pseudocount
    s2 = (SS - S1) + pseudocount
    ss = SS + 2 * pseudocount
    elbo2 = torch.logsumexp(s1 * dg(s1) + s2 * dg(s2) - ss * dg(ss), dim=1)

    ad_sum, dp_sum = (x.to(S1.dtype) for x in counts.row_sums())
    m1_s1 = ad_sum + pseudocount
    m1_s2 = (dp_sum - ad_sum) + pseudocount
    m1_ss = dp_sum + 2 * pseudocount
    elbo1 = m1_s1 * dg(m1_s1) + m1_s2 * dg(m1_s2) - m1_ss * dg(m1_ss)
    return elbo2 - elbo1
