"""Ambient-RNA fractions: the per-cell EM over a cell's donor mixture,
batched over chunks of cells (counterpart of
vireo_tpu/models/ambient.py).

Each cell's EM is the JAX package's `_cell_em` (ambient.py:22-90), run
for a chunk of cells at once. With psi_m = psi with its masked donors
zeroed, r1 = theta psi_m and r0 = (1 - theta) psi_m at each variant, one
step is

    psi_raw = psi_m * (theta^T (ad / r1) + (1 - theta)^T (bd / r0)),

which is `ad @ Z1 + bd @ Z0` of the JAX form without its (n_sel, K)
temporaries a cell. r0 is its own product, not 1 - r1, which would
cancel where theta is near 0.99. Only a cell's covered variants (AD or
DP nonzero) add to these sums and to its log-likelihood, so each chunk
holds its cells as rows of their covered variants (`_covered`: variant
indices, AD and BD, padded with zero counts to the chunk's widest cell),
and every step is a batched product over those rows (`torch.bmm`): the
work follows the reads, ~1% of a 27.5k-variant row in a real pool. A
padded entry adds nothing (0 / r1 with r1 > 0), and a cell without
reads gets NaN psi as in JAX (0 / 0). The Fisher information at the
final psi is one more product of the same kind.

A cell stops when its own test says so (`it` read after its increment:
`it >= max_iter`, or `it - 1 > min_iter` with a gain in [0, eps)), and
its results are the values of that iteration: the semantics of JAX's
vmap of a while_loop, where a finished cell's carry is frozen. Since
every cell of a chunk starts together, the iteration count is one
number for the chunk's running cells.

On a mesh (a ShardedCounts) the selected variants' (n_sel, C_shard)
blocks are all-gathered and every rank runs the EM over every cell, as
the multi-process branch of vireo_tpu/models/ambient.py:209-217 does;
the SNP gate reads the all-reduced statistics, and psi0 is rank 0's
draw, so every rank gets the same results.
"""

import timeit

import numpy as np
import torch

__all__ = ["fit_em_ambient_batch", "predit_ambient", "predict_ambient"]

# bytes of one chunk: the gathered (chunk, n_sel) count block and the
# chunk's (chunk, width, K) products, about six of them live at a time
_CHUNK_BYTES = 4 << 30
_LIVE_BLOCKS = 6
# iterations between the host's reads of how many cells still run
_SYNC_EVERY = 8


def _loglik(ad, bd, rate):
    """Per-cell binomial log-likelihood of rates (chunk, width), with the
    JAX package's clip and its zero for absent reads."""
    safe = torch.clamp(rate, 1e-300, 1.0 - 1e-15)
    zero = torch.zeros((), dtype=rate.dtype, device=rate.device)
    return (torch.where(ad > 0, ad * torch.log(safe), zero)
            + torch.where(bd > 0, bd * torch.log1p(-safe), zero)).sum(1)


def _covered(a_blk, d_blk, dtype):
    """A chunk's (B, n_sel) AD and DP block as rows of each cell's covered
    variants: (variant index (B, w), AD (B, w), BD (B, w)) in `dtype`, in
    variant order, padded with variant 0 and zero counts to the widest
    cell: w >= 1 where there are variants, so that a cell without reads
    meets its NaN psi in every sum, as in JAX; w = 0 without variants,
    where JAX's sums are empty."""
    B, n_sel = a_blk.shape
    dev = a_blk.device
    r, c = ((a_blk != 0) | (d_blk != 0)).nonzero(as_tuple=True)
    n = torch.bincount(r, minlength=B)
    w = max(int(n.max()) if B else 0, 1) if n_sel else 0
    pos = torch.arange(r.numel(), device=dev) - (torch.cumsum(n, 0) - n)[r]
    cols = torch.zeros((B, w), dtype=torch.long, device=dev)
    cols[r, pos] = c
    ad = torch.zeros((B, w), dtype=dtype, device=dev)
    dp = torch.zeros_like(ad)
    ad[r, pos] = a_blk[r, c].to(dtype)
    dp[r, pos] = d_blk[r, c].to(dtype)
    return cols, ad, dp - ad


def _em_chunk(cols, ad, bd, theta, psi, n_mask, max_iter, min_iter,
              epsilon_conv):
    """The EM of a chunk of cells: cols, ad, bd (B, w) from `_covered`;
    theta (n_sel, K); psi (B, K) the initial fractions. Returns (psi,
    var, llr, the iterations of the chunk's slowest cell).

    Each iteration records, on the device, the psi and `prev` of the
    cells whose test stops them then; a stopped cell stays in the
    working set (its later values are not read) until a quarter of the
    set has stopped, and the set is then compacted to the running cells.
    The host reads how many cells still run every `_SYNC_EVERY`
    iterations; the Fisher information and the LLR are taken at the end
    from the recorded psi and `prev`."""
    B, K = psi.shape
    dtype, dev = theta.dtype, psi.device
    comp = 1.0 - theta
    eps = torch.tensor(epsilon_conv, dtype=dtype).item()
    fin_psi = torch.empty_like(psi)
    fin_prev = torch.empty(B, dtype=dtype, device=dev)
    n_it = torch.zeros(B, dtype=torch.int64, device=dev)

    a, b, rows = ad, bd, torch.arange(B, device=dev)
    th, cm = theta[cols], comp[cols]                        # (B, w, K)
    live = torch.ones(B, dtype=torch.bool, device=dev)
    prev = torch.full((B,), -np.inf, dtype=dtype, device=dev)
    curr = prev.clone()
    it = 0
    while True:
        if n_mask > 0 and it >= min_iter - 3:
            rank = torch.argsort(torch.argsort(psi, dim=1, stable=True),
                                 dim=1, stable=True)
            psi_m = psi.masked_fill(rank < n_mask, 0.0)
        else:
            psi_m = psi
        pm = psi_m.unsqueeze(2)
        x = (a / torch.bmm(th, pm).squeeze(2)).unsqueeze(1)
        y = (b / torch.bmm(cm, pm).squeeze(2)).unsqueeze(1)
        psi_raw = psi_m * (torch.bmm(x, th) + torch.bmm(y, cm)).squeeze(1)
        psi = psi_raw / psi_raw.sum(1, keepdim=True)
        prev, curr = curr, _loglik(a, b, torch.bmm(
            th, psi.unsqueeze(2)).squeeze(2))
        it += 1

        if it >= max_iter:
            stop = live
        elif it - 1 > min_iter:
            delta = curr - prev
            stop = live & (delta >= 0) & (delta < eps)
        else:
            continue
        fin_psi[rows] = torch.where(stop[:, None], psi, fin_psi[rows])
        fin_prev[rows] = torch.where(stop, prev, fin_prev[rows])
        n_it[rows] = torch.where(stop, it, n_it[rows])
        live = live & ~stop
        if it >= max_iter:
            break
        if it % _SYNC_EVERY:
            continue
        n_live = int(live.sum())
        if n_live == 0:
            break
        if n_live <= 0.75 * rows.numel():
            keep = live.nonzero().squeeze(1)
            a, b, th, cm, psi, prev, curr, rows = (
                t.index_select(0, keep)
                for t in (a, b, th, cm, psi, prev, curr, rows))
            live = torch.ones(n_live, dtype=torch.bool, device=dev)
    del th, cm

    # Cramér–Rao variance at the final psi (ambient.py:74-80)
    th = theta[cols]
    tv = torch.bmm(th, fin_psi.unsqueeze(2)).squeeze(2)
    w = (ad / tv ** 2 + bd / (1.0 - tv) ** 2).unsqueeze(1)
    fisher = torch.bmm(w, th * th).squeeze(1)
    # LR against all mass on argmax psi; the reported log-likelihood is
    # the second-to-last iteration's (`prev`, ambient.py:82-88)
    best = torch.argmax(fin_psi, dim=1)
    null = th.gather(2, best[:, None, None].expand(-1, th.shape[1], 1))
    llr = fin_prev - _loglik(ad, bd, null.squeeze(2))
    return fin_psi, 1.0 / fisher, llr, int(n_it.max())


def fit_em_ambient_batch(AD_cells, DP_cells, theta_mat, psi0, n_mask=0,
                         max_iter=200, min_iter=20, epsilon_conv=1e-3,
                         cell_chunk=None):
    """Batched per-cell ambient EM on (n_cell, n_var) dense slices of any
    count type; psi0 (n_cell, K). Returns (Psi, Psi_var, LLR) tensors.
    `cell_chunk` bounds the cells run at once (None: all)."""
    C = AD_cells.shape[0]
    chunk = C if cell_chunk is None else max(int(cell_chunk), 1)
    outs = []
    for lo in range(0, C, chunk):
        cov = _covered(AD_cells[lo:lo + chunk], DP_cells[lo:lo + chunk],
                       theta_mat.dtype)
        outs.append(_em_chunk(*cov, theta_mat, psi0[lo:lo + chunk], n_mask,
                              max_iter, min_iter, epsilon_conv)[:3])
    return tuple(torch.cat(x) for x in zip(*outs))


def _cells_per_chunk(ad_vc, dp_vc, sel, K, itemsize):
    """Cells a chunk may hold under `_CHUNK_BYTES`: each costs its column
    of the gathered count block and `_LIVE_BLOCKS` (width, K) products,
    the width being the most variants any cell covers (counted here, a
    block of selected rows at a time)."""
    C, n_sel = ad_vc.shape[1], len(sel)
    width = torch.zeros(C, dtype=torch.int64, device=ad_vc.device)
    for r0 in range(0, n_sel, 2048):
        rs = sel[r0:r0 + 2048]
        width += ((ad_vc[rs] != 0) | (dp_vc[rs] != 0)).sum(0)
    w = max(int(width.max()) if C else 0, 1)
    per_cell = 4 * n_sel + _LIVE_BLOCKS * w * K * itemsize
    return max(64, _CHUNK_BYTES // per_cell)


def _ambient_em_cols(ad_vc, dp_vc, sel, theta_sel, psi0, n_mask=0,
                     max_iter=200, min_iter=20, epsilon_conv=1e-3,
                     cell_chunk=None):
    """The per-cell EM reading the (n_var, n_cell) count storage in
    place: each chunk gathers the selected variant rows of its cell
    columns and keeps their covered entries (`_covered`), so no
    (n_cell, n_sel) float copy of the counts exists. `cell_chunk` caps
    the cells of a chunk (default: as many as `_CHUNK_BYTES` holds). The
    per-cell results are the batch path's."""
    C = ad_vc.shape[1]
    sel = torch.as_tensor(sel, device=ad_vc.device)
    chunk = _cells_per_chunk(ad_vc, dp_vc, sel, theta_sel.shape[1],
                             theta_sel.element_size())
    if cell_chunk is not None:
        chunk = min(chunk, max(int(cell_chunk), 1))
    outs = []
    for lo in range(0, C, chunk):
        hi = min(lo + chunk, C)
        cov = _covered(ad_vc[sel, lo:hi].t(), dp_vc[sel, lo:hi].t(),
                       theta_sel.dtype)
        outs.append(_em_chunk(*cov, theta_sel, psi0[lo:hi], n_mask,
                              max_iter, min_iter, epsilon_conv)[:3])
    return tuple(torch.cat(x) for x in zip(*outs))


def predit_ambient(vobj, AD, DP, nproc=None, min_ELBO_gain=None, rng=None):
    """Per-cell ambient-RNA donor fractions of a fitted model
    (vireo_tpu/models/ambient.py:158-236). Returns numpy (Psi, Psi_var,
    Psi_LLRatio). `nproc` is accepted for API parity and ignored.

    The SNP gate keeps variants whose `variant_ELBO_gain` reaches
    `min_ELBO_gain` (default sqrt(n_cell) / 3). theta is row 0 of
    beta_mu folded with GT_prob, in ASE mode too, and psi0 is one
    Dirichlet(1) draw a cell from `rng` (numpy's global stream by
    default). The EM reads the counts a chunk of cells at a time: int8
    DenseCounts in place, every other layout through
    `var_subset(sel).densify()` of the selected variants."""
    from .variant_select import variant_ELBO_gain
    from ..ops.counts import DenseCounts
    start = timeit.default_timer()
    if rng is None:
        rng = np.random

    counts = vobj._as_counts(AD, DP)
    theta_mat = np.tensordot(vobj.GT_prob, vobj.beta_mu[0, :], axes=(2, 0))
    mesh = getattr(counts, "mesh", None)

    if min_ELBO_gain is None:
        min_ELBO_gain = np.sqrt(counts.n_cell) / 3.0
    if mesh is None:
        gain = variant_ELBO_gain(counts, vobj.ID_prob)
    else:
        from ..parallel.mesh import VAR_AXIS
        gain = counts.layout.gather(
            variant_ELBO_gain(counts, vobj.state.id_prob), VAR_AXIS, 0)
    snp_idx = gain.cpu().numpy() >= min_ELBO_gain
    if mesh is None or mesh.is_root:
        print("[vireo] %d out %d SNPs selected for ambient RNA detection: "
              "ELBO_gain > %.1f" % (snp_idx.sum(), len(snp_idx),
                                    min_ELBO_gain))

    sel = np.where(snp_idx)[0]
    K = theta_mat.shape[1]
    psi0 = rng.dirichlet([1.0] * K, size=counts.n_cell)

    if mesh is not None:
        psi0 = mesh.broadcast(torch.from_numpy(psi0)).numpy()
        dense, rows = counts.gather_rows(sel), np.arange(len(sel))
    elif isinstance(counts, DenseCounts):
        dense, rows = counts, sel
    else:
        dense, rows = counts.var_subset(sel).densify(), np.arange(len(sel))
    dev, dtype = counts.device, vobj.dtype
    Psi, Psi_var, Psi_llr = _ambient_em_cols(
        dense.ad, dense.dp, torch.as_tensor(rows, device=dev),
        torch.as_tensor(theta_mat[snp_idx, :], device=dev).to(dtype),
        torch.as_tensor(psi0, device=dev).to(dtype))
    Psi, Psi_var, Psi_llr = (x.cpu().numpy() for x in (Psi, Psi_var,
                                                        Psi_llr))

    stop = timeit.default_timer()
    if mesh is None or mesh.is_root:
        print('[vireo] Ambient RNA time: %.1f sec' % (stop - start))
    return Psi, Psi_var, Psi_llr


# the correctly spelled alias
predict_ambient = predit_ambient
