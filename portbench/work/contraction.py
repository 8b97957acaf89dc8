"""The least work of one count contraction, from the inputs' nonzeros.

A call is `suff_stats(W)` (AD @ W and DP @ W, W: (n_cell, N)) or
`cell_loglik(Wa, Wd)` (AD.T @ Wa + DP.T @ Wd, Wa and Wd: (n_var, N)).
Whatever layout or kernel implements it, the call has to:

- read each nonzero of DP and the AD value beside it once, a byte each
  (AD is never above DP, so its nonzeros lie among DP's; no index bytes
  are counted, so no layout can need less);
- read the float32 weights once and write the float32 outputs once;
- multiply and add each nonzero of AD and of DP by N weights:
  2 * (nnz(AD) + nnz(DP)) * N operations.

The least time is the larger of the operations at the card's highest
dense rate (int8) and the bytes at its memory bandwidth.
"""

__all__ = ["work", "least_seconds"]


def work(kind, n, n_var, n_cell, nnz_ad, nnz_dp):
    """(operations, bytes) of one call of `kind` at width `n`."""
    ops = 2.0 * (nnz_ad + nnz_dp) * n
    counts = 2.0 * nnz_dp
    if kind == "suff_stats":
        weights, outputs = 4.0 * n_cell * n, 2 * 4.0 * n_var * n
    elif kind == "cell_loglik":
        weights, outputs = 2 * 4.0 * n_var * n, 4.0 * n_cell * n
    else:
        raise ValueError("no contraction %r" % kind)
    return ops, counts + weights + outputs


def least_seconds(kind, n, n_var, n_cell, nnz_ad, nnz_dp, peaks):
    """(least seconds, "operations" or "bytes": the bound that sets
    it)."""
    ops, nbytes = work(kind, n, n_var, n_cell, nnz_ad, nnz_dp)
    t_ops = ops / peaks["int8_ops_per_s"]
    t_bytes = nbytes / peaks["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
