"""Fused E-step with the next sufficient statistics: the port of K1,
vireo_tpu/ops/pallas_em.py::fused_estep_stats.

One call computes, for int8 counts AD, DP (V, C), weights Wa, Wd
(V, K) and a (1, K) log prior:

    loglik  = AD.T @ Wa + DP.T @ Wd
    id_prob = softmax(loglik + log_prior)
    S1      = AD @ bf16(id_prob[:, :Ks]),  SS = DP @ bf16(id_prob[:, :Ks])
    lb_p    = sum(loglik * id_prob),  kl_id = KL(id_prob || prior)

with W = [Wa | Wd] rounded to bf16 and float32 sums, as the TPU kernel
rounds them. `fused_estep_stats` launches the CUDA kernels
(csrc/fused_estep.cu: the E-step and the statistics on the tensor
cores) for tensors on a card and runs the plain version
`fused_estep_stats_reference` for tensors on the CPU; on a card it
launches or raises, and never falls back. Either way it takes at most
`MAX_K` assignment columns. `LAUNCHES` counts the kernel's launches.
"""

import ctypes

import torch

from ._launch import launch, on_cpu

__all__ = ["fused_estep_stats", "fused_estep_stats_reference", "LAUNCHES",
           "MAX_K"]

# The most assignment columns K that fused_estep_stats takes, on the CPU
# as on a card (csrc/fused_estep.cu::kMaxK, returned by
# vireo_fused_estep_max_k). The kernel tiles K, so its registers and
# shared memory do not bound it; the (C, K) float32 id and loglik in
# device memory do (0.82 GB at 100000 cells). n_donor <= 44 gives a
# doublet space of K = n + C(n, 2) <= 990 columns; the doublet phase
# takes the unfused path above MAX_K.
MAX_K = 1024

# number of fused_estep_stats calls that launched the CUDA kernel
LAUNCHES = 0

_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        from ._build import load_library
        lib = load_library("fused_estep")
        ptr = ctypes.c_void_p
        lib.vireo_fused_estep_stats.argtypes = [ptr] * 10 + [
            ctypes.c_int] * 6 + [ptr]
        lib.vireo_fused_estep_stats.restype = ctypes.c_int
        for fn in (lib.vireo_fused_estep_cell_block,
                   lib.vireo_fused_estep_max_k):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        if lib.vireo_fused_estep_max_k() != MAX_K:
            raise RuntimeError("fused_estep.cu takes %d columns, MAX_K is %d"
                               % (lib.vireo_fused_estep_max_k(), MAX_K))
        lib.vireo_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vireo_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _prepare(Wa, Wd, id_log_prior, stats_cols):
    K = Wa.shape[1]
    Ks = K if stats_cols is None else int(stats_cols)
    if not 0 < Ks <= K:
        raise ValueError("stats_cols=%s outside 1..%d" % (stats_cols, K))
    W = torch.cat([Wa, Wd], dim=1).to(torch.bfloat16)
    prior = id_log_prior.to(torch.float32).reshape(1, K)
    return K, Ks, W, prior


def fused_estep_stats_reference(ad, dp, Wa, Wd, id_log_prior,
                                stats_cols=None):
    """Plain PyTorch version of the kernel, with the same bf16 rounding.

    Returns (S1 (V, Ks), SS (V, Ks), id_prob (C, K), loglik (C, K),
    lb_p, kl_id), all float32; the scalars are 0-d tensors.
    """
    from .counts import DenseCounts
    K, Ks, W, prior = _prepare(Wa, Wd, id_log_prior, stats_cols)
    W = W.to(torch.float32)
    counts = DenseCounts(ad, dp)
    loglik = counts.cell_loglik(W[:, :K].contiguous(),
                                W[:, K:].contiguous())
    logp = loglik + prior
    logp = logp - logp.amax(dim=-1, keepdim=True)
    e = torch.exp(logp)
    id_prob = e / e.sum(dim=-1, keepdim=True)
    idb = id_prob[:, :Ks].to(torch.bfloat16).to(torch.float32)
    S1, SS = counts.suff_stats(idb)
    lb_p = torch.sum(loglik * id_prob)
    pos = id_prob > 0
    safe_log = torch.log(torch.where(pos, id_prob, torch.ones_like(id_prob)))
    kl_id = torch.sum(torch.where(pos, id_prob * (safe_log - prior),
                                  torch.zeros_like(id_prob)))
    return S1, SS, id_prob, loglik, lb_p, kl_id


def fused_estep_stats(ad, dp, Wa, Wd, id_log_prior, stats_cols=None):
    """One fused pass over (ad, dp); JAX's 6-tuple in JAX's layouts.

    ad, dp: (V, C) int8, unpadded (the kernel masks ragged edges).
    Wa, Wd: (V, K) float weights. id_log_prior: (1, K) or (K,).
    stats_cols: only the first `stats_cols` assignment columns feed S1
    and SS (default all K); the doublet phase passes the singlet count.
    K may not exceed MAX_K (ValueError), on the CPU as on a card.
    """
    if Wa.shape[1] > MAX_K:
        raise ValueError("fused_estep_stats takes at most %d assignment "
                         "columns, got %d" % (MAX_K, Wa.shape[1]))
    if on_cpu("fused_estep_stats", ad):
        return fused_estep_stats_reference(ad, dp, Wa, Wd, id_log_prior,
                                           stats_cols)
    return _launch(ad, dp, Wa, Wd, id_log_prior, stats_cols)


def _launch(ad, dp, Wa, Wd, id_log_prior, stats_cols):
    global LAUNCHES
    K, Ks, W, prior = _prepare(Wa, Wd, id_log_prior, stats_cols)
    V, C = ad.shape
    if ad.dtype != torch.int8 or dp.dtype != torch.int8:
        raise TypeError("the CUDA kernel reads int8 counts, got %s/%s"
                        % (ad.dtype, dp.dtype))
    if dp.shape != ad.shape or Wa.shape != (V, K) or Wd.shape != (V, K):
        raise ValueError("shape mismatch: ad %s dp %s Wa %s Wd %s"
                         % (tuple(ad.shape), tuple(dp.shape),
                            tuple(Wa.shape), tuple(Wd.shape)))
    if V == 0 or C == 0:
        raise ValueError("empty counts (%d x %d)" % (V, C))
    device = ad.device
    for name, t in (("dp", dp), ("W", W), ("prior", prior)):
        if t.device != device:
            raise ValueError("%s is on %s, counts on %s"
                             % (name, t.device, device))
    lib = _library()
    ad = ad.contiguous()
    dp = dp.contiguous()
    prior = prior.contiguous()
    # the kernels' B operands, K-major: W^T for the E-step and
    # bf16(id[:, :Ks])^T (written by the E-step) for the statistics. The
    # kernels read them through tensor maps of their logical sizes; a
    # row is padded to a whole 16 bytes (TMA's stride unit), and nothing
    # past V or C in it is read.
    ldv, ldc = -(-V // 8) * 8, -(-C // 8) * 8
    wt = torch.empty((2, K, ldv), dtype=torch.bfloat16, device=device)
    wt[:, :, :V] = W.t().reshape(2, K, V)
    id_t = torch.empty((Ks, ldc), dtype=torch.bfloat16, device=device)
    cb = lib.vireo_fused_estep_cell_block()
    f32 = dict(dtype=torch.float32, device=device)
    S = torch.empty((V, 2 * Ks), **f32)
    id_prob = torch.empty((C, K), **f32)
    loglik = torch.empty((C, K), **f32)
    partials = torch.empty((-(-C // cb), 2), **f32)
    scal = torch.empty((2,), **f32)
    launch("fused_estep_stats", lib.vireo_fused_estep_stats,
           (ad.data_ptr(), dp.data_ptr(), wt.data_ptr(), prior.data_ptr(),
            S.data_ptr(), id_prob.data_ptr(), loglik.data_ptr(),
            id_t.data_ptr(), partials.data_ptr(), scal.data_ptr(), V, C, K,
            Ks, ldv, ldc), device, lib.vireo_cuda_error_string)
    LAUNCHES += 1
    return S[:, :Ks], S[:, Ks:], id_prob, loglik, scal[0], scal[1]
