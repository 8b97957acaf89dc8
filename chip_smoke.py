#!/usr/bin/env python3
"""Proof that the PyTorch port (vireo_tpu_torch) runs on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the repository

Phases, in order; any failure raises and the script exits non-zero:

1. environment: torch, CUDA and nvcc versions, the card's name and power
   limit; there is no CPU path;
2. build: the CUDA kernels, K1 (csrc/fused_estep.cu) and K2/K3
   (csrc/packed_counts.cu), from the sources in the checkout, one nvcc
   for each, started together;
3. K1 against its plain PyTorch version on the card, at the slice's
   shapes (two edge shapes, one with K above 256 and an unaligned C;
   the fit; the 16- and 24-donor doublet phases), with the tolerances
   below, both times, its bound (no single PyTorch call computes the
   fused E-step and statistics, so it has no library time), and the
   times of K1's two kernels (the E-step and the statistics) from
   torch.profiler;
4. K2 and K3 against their plain versions on the card at the shapes the
   packed rung gives them (edge, warm, refit, doublet and a capacity
   pool that only the packed rung holds on this card): exactly on
   integer weights, exactly on weights that need all three of their
   bf16 terms, with controls that show a kernel dropping a term would
   fail, and within a stated bound on float weights; their float error
   against float64 sums beside the plain version's and those of one and
   two terms (three terms at least K2_TERMS_GAIN and K3_TERMS_GAIN times
   as close as one); both times, each kernel's bound and achieved
   TFLOP/s, and as the library call one cuBLAS float32 torch.matmul on
   the counts unpacked ahead of the timing, where they fit the card;
5. the full-size main path on the dense rung: a seeded synthetic pool
   of 30000 variants x 100000 cells x 16 donors with 8% doublets
   through `vireo_wrap(n_init=20, random_seed=0)`, with K1's launch
   count over that run, phase times, peak memory and accuracy against
   the simulation's truth;
6. the same pool and call on the packed rung, chosen by the ladder under
   VIREO_DENSE_BUDGET_GB=4: K2's and K3's launch counts (and no K1),
   phase times, peak memory, accuracy, and agreement with the dense
   run's calls; then both runs again under torch.profiler: each rung's
   device time by kernel and the device's idle share;
7. small pools on the card against the CPU: the dense rung, then the
   int8-hybrid, packed-hybrid and COO rungs of a heavy-tailed pool
   (each rung's contractions also run twice and must give the same
   sums bit for bit), then a 23-donor pool on the dense rung, whose
   doublet space (K = 276 columns) goes through K1;
8. the CLI on a small synthetic cellSNP folder.

The line before the last is the kernel table as JSON; the last line is
`{"ok": true, "device": {...}}`.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# --- K1 tolerances (kernel vs plain version on the same inputs) --------
# loglik: both sum the same exact products (int8 count x bf16 weight) in
#   float32, in different orders; the error scales with the magnitudes
#   summed, so |err| <= 1e-4 |ref| + 1e-5 max|ref|.
LOGLIK_RTOL, LOGLIK_ATOL_REL = 1e-4, 1e-5
# id: the softmax passes a loglik difference d on as at most d/2; the
#   loglik differences are ~1e-4 (one float32 ulp at |loglik| ~ 1000).
ID_ATOL = 1e-4
# id against the softmax of the kernel's own loglik (the epilogue alone).
ID_SELF_ATOL = 1e-6
# S against the plain statistics of the kernel's own bf16(id): sum order
#   only, as for loglik.
S_RTOL, S_ATOL_REL = 1e-4, 1e-5
# S end to end: an id within ~1e-4 of a bf16 rounding boundary may round
#   the other way (a 2^-8 relative step of one term), so normwise 1e-3.
S_E2E_REL = 1e-3
# lb_p, kl_id: float32 sums of C x K terms in different orders.
SCALAR_RTOL = 1e-4

# label: V, C, K, Ks, timed. edge: K + C(K,2) for 20 donors; edge_wide:
# 23 donors (K = 276, above one 256-column tile) over an odd C whose
# rows are not 16-byte aligned; fit: the EM fit's N = 16; doublet and
# doublet24: the doublet phases of 16 and 24 donors
K1_SHAPES = (
    ("edge", dict(V=1000, C=700, K=210, Ks=20), False),
    ("edge_wide", dict(V=1000, C=701, K=276, Ks=23), False),
    ("fit", dict(V=30000, C=8192, K=16, Ks=16), True),
    ("doublet", dict(V=30000, C=100000, K=136, Ks=16), True),
    ("doublet24", dict(V=30000, C=100000, K=300, Ks=24), True),
)
# K1's kernels, by the names torch.profiler reports
K1_KERNELS = ("estep_kernel", "rows_kernel", "sum_partials")
# the full-size main path (benchmarks/e2e_100k.py's pool)
MAIN = dict(n_var=30000, n_cell=100000, n_donor=16, n_init=20)

# --- K2/K3 tolerances (kernel vs plain version on the same inputs) ------
# exact: integer weights in [-2, 2] make every product and partial sum an
#   integer of magnitude at most 30 x (terms of one output) <= 9e6 < 2^24,
#   exact in float32 in any order: the kernel must equal the plain version.
# float: weights in the fit's ranges; the two versions sum the same
#   float32 products in different orders, which Higham's bound limits to
#   |err| <= (gamma_n + gamma_m) sum|terms| elementwise,
#   gamma_n = n u / (1 - n u), u = 2^-24, n and m the terms of one output
#   on each side: the plain versions sum n_cell (K2) and 2 n_var (K3)
#   terms, the kernels three times as many (each weight is split into
#   three bf16 terms, hi + mid + lo, each product exact in float32);
#   sum|terms| is the plain version on |W| (the counts are >= 0).
F32_UNIT = 2.0 ** -24
# The exact check of the kernels' three bf16 terms: in each column of W
# (K2; for K3 of [Wa; Wd], the 2 n_var rows together), SPLIT_NNZ random
# rows hold odd integers of magnitude in [2^17, 2^18) with random signs,
# the other rows 0. Such an integer has 18 significant bits: hi holds 8
# of them, mid the next 8 and lo (nonzero for about half of them) the
# rest, so a kernel that drops lo, or mid and lo, gives other sums. Each
# product nibble x W is exact in float32 (22 bits) and each partial sum
# is an integer below SPLIT_NNZ x 15 x 2^18 < 2^24, exact in any order:
# the kernel must equal the plain version. The integer weights in
# [-2, 2] above are exact in bf16 (mid = lo = 0), so they cannot show a
# lost term.
SPLIT_NNZ = 4
# K2 and K3 on float weights against float64 sums must be at least this
# many times as close as the same kernel on the weights rounded to one
# bf16 term. The three terms only pay if the sums keep what they carry:
# the tensor cores truncate into their accumulators at every k16 step,
# and before K2 added each k-block's sums into float32 on the CUDA
# cores, three terms erred by 153 at N = 320 and one term by 119 (H100,
# PERF.md); with it 1.2 against 13.3, and at the capacity shape 5.7
# against 17.8. K3 sums its k-blocks the same way.
K2_TERMS_GAIN = 2.0
K3_TERMS_GAIN = 2.0
# --- bounds: the least time the card could take for a kernel's work,
# the larger of its operations over the tensor cores' dense bf16 peak
# (at the kernel's precision: K1 one bf16 term of its weights, K2 and K3
# three) and the bytes it must move (each input read once, each output
# written once) over the memory's rate; NVIDIA's data sheet, H100 SXM,
# at a 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# the library call beside K2/K3 takes the counts unpacked to one float32
# (2 n_var, n_cell) matrix; it is timed only where that matrix takes at
# most this share of the card's free memory
LIBRARY_MEM_SHARE = 0.6
# label, V, C, N, kernels checked. warm/refit: the EM fit's N = 20 x 16
# and 16; doublet: K + C(K,2) = 136; capacity: 3e10 count cells, which
# dense int8 cannot hold on this card and the packed rung can.
K23_SHAPES = (
    ("edge", 1001, 1999, 21, ("suff_stats", "cell_loglik")),
    ("warm", 30000, 100000, 320, ("suff_stats", "cell_loglik")),
    ("refit", 30000, 100000, 16, ("suff_stats", "cell_loglik")),
    ("doublet", 30000, 100000, 136, ("suff_stats", "cell_loglik")),
    ("capacity", 100000, 300000, 16, ("suff_stats", "cell_loglik")),
)
# the packed main path's budget: int8 (6.0e9 B) does not fit, packed
# (3.0e9 B) does; what a card with about 7 GiB free gives (55% of it)
PACKED_BUDGET_GB = "4"
# the small heavy-tailed pool of the other rungs
SMALL_RUNGS = dict(n_var=3000, n_cell=8000, n_donor=4)
# its ELBO against the CPU's: a fit stops once an iteration gains < 0.01,
# at a point that float32 round-off moves; measured on an H100 2.4e-6
# and 1.7e-5 for COO, 3e-7 for the hybrids, and once 3.8e-4 for COO
# while it summed with atomic index_add_, whose order changes from run
# to run (it now sums in a fixed order, which this phase checks)
RUNG_ELBO_RTOL = 1e-4
# the many-donor pool: 23 donors give K + C(K,2) = 276 doublet columns
MANY_DONORS = dict(n_var=3000, n_cell=4000, n_donor=23)


def log(*args):
    print(*args, flush=True)


def phase_environment(torch):
    log("[env] python %s" % sys.version.split()[0])
    log("[env] torch %s, CUDA %s" % (torch.__version__, torch.version.cuda))
    from vireo_tpu_torch.ops._build import find_nvcc
    nvcc = find_nvcc()
    out = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log("[env] nvcc %s: %s" % (nvcc, out[-1]))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log("[env] device 0: %s, device count %d"
        % (torch.cuda.get_device_name(0), torch.cuda.device_count()))


def phase_build():
    """Both kernel libraries, their nvcc runs started together."""
    from concurrent.futures import ThreadPoolExecutor
    from vireo_tpu_torch.ops import fused_em, packed
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(fused_em._library), pool.submit(packed._library)]:
            f.result()
    log("[build] K1 and K2/K3 built and loaded in %.2f s"
        % (time.perf_counter() - t0))


def _k1_inputs(torch, V, C, K, seed, device):
    """Synthetic int8 counts at the pool's density and depth, and
    weights in the range of digamma-folded log rates."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    dp = torch.zeros((V, C), dtype=torch.int8, device=device)
    ad = torch.zeros_like(dp)
    for r0 in range(0, V, 2000):       # bound the float temporaries
        r1 = min(r0 + 2000, V)
        cov = torch.rand((r1 - r0, C), generator=g, device=device) < 0.01
        d = (1 + torch.poisson(torch.full((r1 - r0, C), 0.6, device=device),
                               generator=g)) * cov
        a = torch.binomial(d, torch.full_like(d, 0.4), generator=g)
        dp[r0:r1] = d.clamp(max=127).to(torch.int8)
        ad[r0:r1] = a.clamp(max=127).to(torch.int8)
    Wa = torch.rand((V, K), generator=g, device=device) * 5 - 1
    Wd = -torch.rand((V, K), generator=g, device=device) * 4 - 0.01
    prior = torch.log_softmax(torch.randn(K, generator=g, device=device),
                              0).reshape(1, K)
    return ad, dp, Wa, Wd, prior


def _time_ms(torch, fn, reps=3):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return times


def _check(name, got, ref, rtol, atol):
    err = (got - ref).abs()
    bound = atol + rtol * ref.abs()
    bad = int((err > bound).sum())
    log("[k1]   %-26s max_abs_err %.3e  max|ref| %.3e  rtol %.0e atol "
        "%.2e  %s" % (name, float(err.max()), float(ref.abs().max()), rtol,
                      atol, "ok" if bad == 0 else "%d OVER" % bad))
    if bad:
        raise AssertionError("K1 %s disagrees with its plain version"
                             % name)
    return float(err.max())


def _timed_pair(torch, run_kernel, run_plain):
    """Median ms of kernel and plain version by CUDA events, in turns:
    plain, kernel, kernel, plain (three runs each)."""
    run_kernel()
    run_plain()
    torch.cuda.synchronize()
    p_ms = _time_ms(torch, run_plain)
    k_ms = _time_ms(torch, run_kernel) + _time_ms(torch, run_kernel)
    p_ms += _time_ms(torch, run_plain)
    return float(np.median(k_ms)), float(np.median(p_ms)), len(k_ms)


def _kernel_ms(torch, fn, names, reps=3):
    """Mean device ms per call of fn of each kernel whose name holds one
    of `names`, from torch.profiler; None where it reports no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = dict.fromkeys(names)
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total",
                     getattr(evt, "cuda_time_total", 0.0))
        for n in names:
            if n in evt.key and us > 0:
                ms[n] = (ms[n] or 0.0) + us / 1000.0 / reps
    return ms


def phase_k1(torch):
    from vireo_tpu_torch.ops import fused_em
    from vireo_tpu_torch.ops.counts import DenseCounts
    dev = torch.device("cuda")
    results = {}
    for label, shape, timed in K1_SHAPES:
        V, C, K, Ks = shape["V"], shape["C"], shape["K"], shape["Ks"]
        args = _k1_inputs(torch, V, C, K, seed=V + C + K, device=dev)
        kern = fused_em.fused_estep_stats(*args, stats_cols=Ks)
        plain = fused_em.fused_estep_stats_reference(*args, stats_cols=Ks)
        torch.cuda.synchronize()
        S1, SS, idp, ll, lb, kl = kern
        pS1, pSS, pid, pll, plb, pkl = plain
        log("[k1] %s shape V=%d C=%d K=%d Ks=%d" % (label, V, C, K, Ks))
        errs = []
        errs.append(_check("loglik", ll, pll, LOGLIK_RTOL,
                           LOGLIK_ATOL_REL * float(pll.abs().max())))
        errs.append(_check("id_prob", idp, pid, 0.0, ID_ATOL))
        self_id = torch.softmax(ll + args[4].float(), dim=-1)
        _check("id_prob (own loglik)", idp, self_id, 0.0, ID_SELF_ATOL)
        idb = idp[:, :Ks].to(torch.bfloat16).float()
        own = DenseCounts(args[0], args[1]).suff_stats(idb)
        for nm, got, ref in (("S1 (own id)", S1, own[0]),
                             ("SS (own id)", SS, own[1])):
            _check(nm, got, ref, S_RTOL,
                   S_ATOL_REL * float(ref.abs().max()))
        for nm, got, ref in (("S1", S1, pS1), ("SS", SS, pSS)):
            errs.append(_check(nm, got, ref, 0.0,
                               S_E2E_REL * float(ref.abs().max())))
        for nm, got, ref in (("lb_p", lb, plb), ("kl_id", kl, pkl)):
            _check(nm, got, ref, SCALAR_RTOL, 0.0)
        del kern, plain, own, self_id, idb
        if not timed:
            continue

        ms, plain_ms, n = _timed_pair(
            torch, lambda: fused_em.fused_estep_stats(*args, stats_cols=Ks),
            lambda: fused_em.fused_estep_stats_reference(*args,
                                                         stats_cols=Ks))
        res = dict(ms=ms, plain_ms=plain_ms, max_abs_err=max(errs),
                   library_ms=None)
        log("[k1]   median ms: kernel %.3f  plain %.3f  (CUDA events, %d "
            "runs each)" % (ms, plain_ms, n))
        # E-step 2 x 2 V C K and statistics 2 x 2 V C Ks flops (bf16
        # weights and id); the int8 counts and float32 weights in, S, id
        # and loglik out
        res["bound_ms"], res["bound_by"] = _bound(
            4.0 * V * C * (K + Ks),
            2.0 * V * C + 8.0 * V * K + 4.0 * K + 8.0 * V * Ks
            + 8.0 * C * K + 8.0)
        log("[k1]   bound %.3f ms (%s): the kernel at %.1f%% of it; no "
            "library call: no single PyTorch call computes the fused "
            "E-step and statistics" % (res["bound_ms"], res["bound_by"],
                                       100.0 * res["bound_ms"] / ms))
        split = _kernel_ms(
            torch, lambda: fused_em.fused_estep_stats(*args, stats_cols=Ks),
            K1_KERNELS)
        log("[k1]   device ms a call (torch.profiler, 3 calls): %s"
            % ", ".join("%s %s" % (k, "not measured" if v is None
                                   else "%.3f" % v)
                        for k, v in split.items()))
        res["kernel_ms"] = split
        results[label] = res
        del args
        torch.cuda.empty_cache()
    return results


def _singlet_accuracy(d, ID_prob, doublet_prob):
    """As benchmarks/e2e_100k.py: optimal label matching over true
    singlets, accuracy over confident calls, doublet recall and FPR."""
    from scipy.optimize import linear_sum_assignment
    K = ID_prob.shape[1]
    pred = np.argmax(ID_prob, axis=1)
    prob_max = ID_prob.max(axis=1)
    called_doublet = doublet_prob.max(axis=1) >= 0.9
    is_doublet = d["donor2"] >= 0
    singlets = ~is_doublet
    hits = np.zeros((K, K))
    for t in range(K):
        m = singlets & (d["donor"] == t)
        hits[t] = np.bincount(pred[m], minlength=K)
    ti, pi = linear_sum_assignment(-hits)
    remap = np.empty(K, np.int64)
    remap[pi] = ti
    pred_t = remap[pred]
    conf = singlets & (prob_max >= 0.9) & ~called_doublet
    return dict(
        singlet_accuracy=float(np.mean(pred_t[conf] == d["donor"][conf])),
        singlet_assigned_frac=float(np.mean(conf[singlets])),
        doublet_recall=float(np.mean(called_doublet[is_doublet])),
        doublet_fpr=float(np.mean(called_doublet[singlets])))


def _k23_inputs(torch, V, C, seed, device):
    """Uniform random packed bytes, every nibble value equally likely, in
    row blocks on the card (the padding nibble of an odd C included:
    the kernels must mask it, the plain versions drop it)."""
    from vireo_tpu_torch.ops.packed import PackedCounts
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    Cb = (C + 1) // 2
    mats = []
    for _ in range(2):
        p = torch.empty((V, Cb), dtype=torch.uint8, device=device)
        for r0 in range(0, V, 8192):
            r1 = min(r0 + 8192, V)
            p[r0:r1] = torch.randint(0, 256, (r1 - r0, Cb), generator=g,
                                     dtype=torch.uint8, device=device)
        mats.append(p)
    return PackedCounts(mats[0], mats[1], (V, C))


def _k23_weights(torch, name, V, C, N, g, device, exact):
    """(W,) for K2, (Wa, Wd) for K3: integers in [-2, 2] when `exact`,
    else probabilities (K2) and digamma-fold ranges (K3)."""
    def draw(rows, lo, hi):
        if exact:
            return torch.randint(-2, 3, (rows, N), generator=g,
                                 device=device).float()
        return lo + (hi - lo) * torch.rand((rows, N), generator=g,
                                           device=device)
    if name == "suff_stats":
        return (draw(C, 0.0, 1.0),)
    return draw(V, -1.0, 4.0), draw(V, -4.01, -0.01)


def _split_weights(torch, C, N, g, device):
    """K2's weights for the exact check of its three terms (SPLIT_NNZ)."""
    shape = (SPLIT_NNZ, N)
    m = 2 * torch.randint(2 ** 16, 2 ** 17, shape, generator=g,
                          device=device) + 1
    sign = 2 * torch.randint(0, 2, shape, generator=g, device=device) - 1
    cells = torch.randint(0, C, shape, generator=g, device=device)
    cols = torch.arange(N, device=device).expand(shape)
    W = torch.zeros((C, N), dtype=torch.float32, device=device)
    W[cells, cols] = (m * sign).float()
    return W


def _fewer_terms(torch, W):
    """W rounded to its first one and first two bf16 terms (as float32,
    which holds them exactly): what a K2 with one or two terms sums."""
    from vireo_tpu_torch.ops.packed import split_bf16x3
    hi, mid, _ = split_bf16x3(W)
    return {1: hi.float(), 2: hi.float() + mid.float()}


def _split_weights_of(torch, name, V, C, N, g, device):
    """The exact three-term check's weights: (W,) for K2, (Wa, Wd) for K3
    with SPLIT_NNZ nonzeros a column across the two together."""
    if name == "suff_stats":
        return (_split_weights(torch, C, N, g, device),)
    W = _split_weights(torch, 2 * V, N, g, device)
    return W[:V].contiguous(), W[V:].contiguous()


def _cut_terms(torch, w, terms):
    """Each weight matrix of `w` cut to its first `terms` bf16 terms."""
    return tuple(_fewer_terms(torch, x)[terms] for x in w)


def _split_check(torch, name, kern, plain, pc, N, g, dev):
    """The kernel exactly equal to its plain version on weights that need
    all three terms; the plain version on the same weights cut to one or
    two terms must differ, or the check could not see a lost term."""
    w = _split_weights_of(torch, name, pc.n_var, pc.n_cell, N, g, dev)
    got, ref = kern(pc, *w), plain(pc, *w)
    for gt, rf in zip(got, ref):
        if not torch.equal(gt, rf):
            raise AssertionError("%s on three-term integer weights differs "
                                 "from its plain version by %.3e"
                                 % (name, float((gt - rf).abs().max())))
    differ = {}
    for terms in (1, 2):
        ctrl = plain(pc, *_cut_terms(torch, w, terms))
        differ[terms] = sum(int((a != b).sum()) for a, b in zip(ctrl, ref))
        if differ[terms] == 0:
            raise AssertionError("the %d-term control equals the three-term "
                                 "sums: the check cannot see a lost term"
                                 % terms)
    log("[k23]   three-term integer weights: equal to the plain version; "
        "controls: with %d and %d of %d outputs the one- and two-term sums "
        "differ" % (differ[1], differ[2], sum(x.numel() for x in ref)))


def _term_errors(torch, name, kern, plain, pc, w, got):
    """Max |error| of the outputs against float64 sums, for the plain
    version (float32 on the CUDA cores), the kernel (three terms) and the
    kernel on the weights cut to one and two terms."""
    label, gain = (("K2", K2_TERMS_GAIN) if name == "suff_stats"
                   else ("K3", K3_TERMS_GAIN))
    exact = plain(pc, *(x.double() for x in w))

    def err(out):
        return max(float((a.double() - b).abs().max())
                   for a, b in zip(out, exact))
    errs = {"plain": err(plain(pc, *w)), "3 terms": err(got)}
    for terms in (1, 2):
        errs["%d term%s" % (terms, "s" if terms > 1 else "")] = err(
            kern(pc, *_cut_terms(torch, w, terms)))
    log("[k23]   %s float max_abs_err against float64 sums (max|out| "
        "%.3e): %s" % (label, max(float(x.abs().max()) for x in exact),
                       ", ".join("%s %.3e" % kv for kv in errs.items())))
    if errs["3 terms"] * gain > errs["1 term"]:
        raise AssertionError("%s's three terms are not %g times as close to "
                             "the float64 sums as one term" % (label, gain))
    return errs


def _bound(flops, nbytes):
    """(ms, what bounds it): the larger of flops at the bf16 peak and
    bytes at the memory's rate."""
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes"))


def _k23_bound(name, V, C, N):
    """K2's or K3's bound: three bf16 terms of the weights, 2 x 2 V C N
    flops each; the packed counts, the float32 weights and the float32
    outputs once."""
    flops = 3 * 2.0 * 2 * V * C * N
    counts = 2.0 * V * ((C + 1) // 2)
    if name == "suff_stats":    # W (C, N) in, S1 and SS (V, N) out
        return _bound(flops, counts + 4.0 * C * N + 8.0 * V * N)
    return _bound(flops, counts + 8.0 * V * N + 4.0 * C * N)


def _unpacked_f32(torch, pc):
    """[AD; DP] as one (2 n_var, n_cell) float32 matrix, the operand of
    the library calls timed beside K2 and K3, or None (with the reason
    logged) where it does not fit the card."""
    V, C = pc.shape
    need = 8.0 * V * C
    free, _ = torch.cuda.mem_get_info()
    if need > LIBRARY_MEM_SHARE * free:
        log("[k23]   library calls not timed: the unpacked float32 counts "
            "take %.1f GB, more than %.0f%% of the card's %.1f GB free"
            % (need / 1e9, 100 * LIBRARY_MEM_SHARE, free / 1e9))
        return None
    X = torch.empty((2 * V, C), dtype=torch.float32, device=pc.device)
    for m, p in enumerate((pc.ad_p, pc.dp_p)):
        for r0 in range(0, V, 2048):
            r1 = min(r0 + 2048, V)
            rows = X[m * V + r0:m * V + r1]
            rows[:, 0::2] = (p[r0:r1] & 0xF).float()
            rows[:, 1::2] = (p[r0:r1] >> 4).float()[:, :C // 2]
    return X


def _library_call(torch, name, X, w):
    """One cuBLAS float32 GEMM computing K2's or K3's function on the
    unpacked counts: [S1; SS] = X W, and out = X^T [Wa; Wd]."""
    if name == "suff_stats":
        W = w[0]
        return lambda: torch.matmul(X, W)
    Wcat = torch.cat(w)
    return lambda: torch.matmul(X.t(), Wcat)


def phase_k23(torch):
    """K2 and K3 against their plain versions at K23_SHAPES."""
    from vireo_tpu_torch.ops import counts, packed
    dev = torch.device("cuda")
    kern = {"suff_stats": lambda pc, *w: pc.suff_stats(*w),
            "cell_loglik": lambda pc, *w: (pc.cell_loglik(*w),)}
    plain = {"suff_stats": lambda pc, *w: packed.suff_stats_reference(
                 pc.ad_p, pc.dp_p, pc.n_cell, *w),
             "cell_loglik": lambda pc, *w: (packed.cell_loglik_reference(
                 pc.ad_p, pc.dp_p, pc.n_cell, *w),)}
    results = {}
    pc = X = None
    for label, V, C, N, names in K23_SHAPES:
        if pc is None or pc.shape != (V, C):
            pc = X = None
            torch.cuda.empty_cache()
            if label == "capacity":
                budget = counts.device_dense_budget(dev)
                rung = counts.ladder_rung((V, C), float(packed.PACK_MAX),
                                          budget)
                log("[k23] capacity pool %d x %d (%.1e count cells): dense "
                    "int8 needs %.1f GiB, packed %.1f GiB; the budget on "
                    "this card is %.1f GiB; the ladder's rung: %s"
                    % (V, C, float(V) * C, 2.0 * V * C / 2**30,
                       float(V) * C / 2**30, budget / 2**30, rung))
                if rung != "packed":
                    raise AssertionError("the capacity pool is not on the "
                                         "packed rung")
            t0 = time.perf_counter()
            pc = _k23_inputs(torch, V, C, seed=V + C, device=dev)
            torch.cuda.synchronize()
            log("[k23] %d x %d packed counts drawn on the card in %.2f s"
                % (V, C, time.perf_counter() - t0))
            if label != "edge":
                X = _unpacked_f32(torch, pc)
        g = torch.Generator(device=dev)
        g.manual_seed(V + C + N)
        for name in names:
            log("[k23] %s %s V=%d C=%d N=%d" % (label, name, V, C, N))
            w = _k23_weights(torch, name, V, C, N, g, dev, exact=True)
            ref = plain[name](pc, *w)
            for gt, rf in zip(kern[name](pc, *w), ref):
                if not torch.equal(gt, rf):
                    raise AssertionError(
                        "%s on integer weights differs from its plain "
                        "version by %.3e"
                        % (name, float((gt - rf).abs().max())))
            log("[k23]   integer weights: equal to the plain version")
            _split_check(torch, name, kern[name], plain[name], pc, N, g, dev)
            w = _k23_weights(torch, name, V, C, N, g, dev, exact=False)
            got = kern[name](pc, *w)
            ref = plain[name](pc, *w)
            mag = plain[name](pc, *(x.abs() for x in w))
            sides = (3 * C, C) if name == "suff_stats" else (6 * V, 2 * V)
            gamma = sum(n * F32_UNIT / (1 - n * F32_UNIT) for n in sides)
            errs = [_bound_check("%s[%d] float" % (name, i), gt, rf,
                                 gamma * m)
                    for i, (gt, rf, m) in enumerate(zip(got, ref, mag))]
            res = dict(max_abs_err=max(errs))
            res["err_vs_f64"] = _term_errors(torch, name, kern[name],
                                             plain[name], pc, w, got)
            del got, ref, mag
            if label != "edge":
                res.update(_k23_times(torch, name, kern[name],
                                      plain[name], pc, w, X, V, C, N))
            results[(label, name)] = res
            del w
            torch.cuda.empty_cache()
    del pc, X
    torch.cuda.empty_cache()
    return results


def _k23_times(torch, name, kern, plain, pc, w, X, V, C, N):
    """Kernel and plain version in turns; the bound, and the library
    call where it fits."""
    res = {}
    res["ms"], res["plain_ms"], nrun = _timed_pair(
        torch, lambda: kern(pc, *w), lambda: plain(pc, *w))
    log("[k23]   median ms: kernel %.3f  plain %.3f  (CUDA events, %d runs "
        "each)" % (res["ms"], res["plain_ms"], nrun))
    # the product's flops (2 matrices x 2 V C N), and the tensor cores'
    # (three bf16 terms of the weights)
    flop = 4.0 * V * C * N
    log("[k23]   %s achieved %.1f TFLOP/s of the product, %.1f TFLOP/s on "
        "the tensor cores" % ("K2" if name == "suff_stats" else "K3",
                              flop / res["ms"] / 1e9,
                              3 * flop / res["ms"] / 1e9))
    res["bound_ms"], res["bound_by"] = _k23_bound(name, V, C, N)
    res["library_ms"] = None
    if X is not None:
        call = _library_call(torch, name, X, w)
        lib_err = max(float((a - b).abs().max()) for a, b in zip(
            torch.split(call(), V) if name == "suff_stats" else (call(),),
            plain(pc, *w)))
        res["library_ms"] = float(np.median(_time_ms(torch, call, reps=6)))
        log("[k23]   library call (cuBLAS float32, one torch.matmul on the "
            "unpacked counts) %.3f ms, max |diff| from the plain version "
            "%.3e" % (res["library_ms"], lib_err))
    log("[k23]   bound %.3f ms (%s): the kernel at %.1f%% of it"
        % (res["bound_ms"], res["bound_by"],
           100.0 * res["bound_ms"] / res["ms"]))
    return res


def _bound_check(name, got, ref, bound):
    err = (got - ref).abs()
    bad = int((err > bound).sum())
    rel = float((err / ref.abs().clamp(min=1e-30)).max())
    ratio = float((err / bound.clamp(min=1e-30)).max())
    log("[k23]   %-22s max_abs_err %.3e  max|ref| %.3e  max rel err %.3e  "
        "max bound %.3e  max err/bound %.3f  %s"
        % (name, float(err.max()), float(ref.abs().max()), rel,
           float(bound.max()), ratio, "ok" if bad == 0 else "%d OVER" % bad))
    if bad:
        raise AssertionError("%s disagrees with its plain version" % name)
    return float(err.max())


def _main_pool():
    from vireo_tpu_torch.sim.synth import synth_pool_counts
    V, C, K = MAIN["n_var"], MAIN["n_cell"], MAIN["n_donor"]
    t0 = time.perf_counter()
    d = synth_pool_counts(V, C, K, doublet_rate=0.08, density=0.01, seed=0)
    log("[main] pool %d x %d x %d, %d nonzeros (largest count %d), "
        "generated on the host in %.2f s" % (V, C, K, d["DP"].nnz,
                                             int(d["DP"].max()),
                                             time.perf_counter() - t0))
    return d


def _run_main(torch, d, tag):
    """vireo_wrap on the main pool as a user calls it, with every kernel
    launch count set to 0 just before and read just after."""
    from vireo_tpu_torch.ops import fused_em, packed
    from vireo_tpu_torch.engine.wrap import vireo_wrap
    V, C, K = MAIN["n_var"], MAIN["n_cell"], MAIN["n_donor"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    phases = {}
    fused_em.LAUNCHES = 0
    for key in packed.LAUNCHES:
        packed.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    res = vireo_wrap(d["AD"], d["DP"], n_donor=K, n_init=MAIN["n_init"],
                     random_seed=0, check_doublet=True, verbose=False,
                     timing=phases)
    wall = time.perf_counter() - t0
    launches = dict(K1=fused_em.LAUNCHES, K2=packed.LAUNCHES["suff_stats"],
                    K3=packed.LAUNCHES["cell_loglik"])
    peak = torch.cuda.max_memory_allocated()
    for name, sec in phases.items():
        log("[%s] phase %-15s %.3f s" % (tag, name, sec))
    log("[%s] vireo_wrap wall %.3f s, peak device memory %.3f GiB, "
        "launches %s" % (tag, wall, peak / 2**30, json.dumps(launches)))

    ID_prob, dbl = res["ID_prob"], res["doublet_prob"]
    assert ID_prob.shape == (C, K) and dbl.shape == (C, K * (K - 1) // 2)
    assert res["GT_prob"].shape == (V, K, 3)
    for key in ("ID_prob", "doublet_prob", "doublet_LLR", "GT_prob",
                "LB_list"):
        assert np.all(np.isfinite(res[key])), key
    np.testing.assert_allclose(ID_prob.sum(1) + dbl.sum(1), 1.0, atol=1e-4)
    acc = _singlet_accuracy(d, ID_prob, dbl)
    log("[%s] %s" % (tag, json.dumps(acc)))
    log("[%s] LB_list max %.6e, LB_doublet %.6e"
        % (tag, float(np.max(res["LB_list"])), float(res["LB_doublet"])))
    if acc["singlet_accuracy"] < 0.99:
        raise AssertionError("singlet accuracy %.5f < 0.99"
                             % acc["singlet_accuracy"])
    return res, launches


def phase_main_path(torch, d):
    """The dense rung: K1 in the doublet phase."""
    res, launches = _run_main(torch, d, "main")
    if launches["K1"] < 1:
        raise AssertionError("the main path did not launch K1")
    return res, launches


@contextlib.contextmanager
def _dense_budget(gb):
    """VIREO_DENSE_BUDGET_GB=gb (unset when None) for the block only."""
    saved = os.environ.pop("VIREO_DENSE_BUDGET_GB", None)
    if gb is not None:
        os.environ["VIREO_DENSE_BUDGET_GB"] = gb
    try:
        yield
    finally:
        os.environ.pop("VIREO_DENSE_BUDGET_GB", None)
        if saved is not None:
            os.environ["VIREO_DENSE_BUDGET_GB"] = saved


def phase_packed_main_path(torch, d, dense_res):
    """The same pool and call on the packed rung, which the ladder picks
    under VIREO_DENSE_BUDGET_GB=PACKED_BUDGET_GB (set for this call
    only): K2 and K3 in every iteration and the doublet phase, no K1."""
    from vireo_tpu_torch.ops import counts
    V, C = MAIN["n_var"], MAIN["n_cell"]
    with _dense_budget(PACKED_BUDGET_GB):
        budget = counts.device_dense_budget()
        rung = counts.ladder_rung((V, C), float(d["DP"].max()), budget)
        log("[packed] VIREO_DENSE_BUDGET_GB=%s: budget %.1f GiB, int8 needs "
            "%.1f GiB, packed %.1f GiB; the ladder's rung: %s"
            % (PACKED_BUDGET_GB, budget / 2**30, 2.0 * V * C / 2**30,
               float(V) * C / 2**30, rung))
        if rung != "packed":
            raise AssertionError("the main pool is not on the packed rung")
        res, launches = _run_main(torch, d, "packed")
    if launches["K2"] < 1 or launches["K3"] < 1 or launches["K1"] != 0:
        raise AssertionError("the packed path launched %s; it must launch "
                             "K2 and K3 and not K1" % json.dumps(launches))
    agree = _matched_agreement(res["ID_prob"], dense_res["ID_prob"])
    log("[packed] argmax agreement with the dense run %.5f after label "
        "matching; LB_doublet %.6e vs dense %.6e"
        % (agree, res["LB_doublet"], dense_res["LB_doublet"]))
    if agree < 0.999:
        raise AssertionError("packed and dense calls disagree")
    return launches


def phase_profile(torch, d):
    """The main path once more on each rung under torch.profiler: the
    phase times, the device time by kernel (the self time of each
    kernel, copy and memset; the aten:: ops, which report their kernels'
    time again, are left out), and the idle share, one minus the device
    time over the profiled wall."""
    from torch.profiler import ProfilerActivity, profile
    from vireo_tpu_torch.engine.wrap import vireo_wrap
    for rung, gb in (("dense", None), ("packed", PACKED_BUDGET_GB)):
        phases = {}
        with _dense_budget(gb), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            vireo_wrap(d["AD"], d["DP"], n_donor=MAIN["n_donor"],
                       n_init=MAIN["n_init"], random_seed=0,
                       check_doublet=True, verbose=False, timing=phases)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = []
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
            if us > 0 and not evt.key.startswith(("aten::", "Command Buffer",
                                                  "cuda")):
                rows.append((us / 1e6, evt.count, evt.key[:90]))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        log("[profile] %s: phases %s, wall %.3f s with the profiler on"
            % (rung, json.dumps({k: round(v, 3) for k, v in phases.items()}),
               wall))
        log("[profile] %s: device time %.3f s, idle %.1f%% of the wall"
            % (rung, busy, 100.0 * (1.0 - busy / wall)))
        for sec, count, key in rows[:14]:
            log("[profile] %s:   %8.3f s %5.1f%%  x%-5d %s"
                % (rung, sec, 100.0 * sec / busy, count, key))


def _matched_agreement(a, b):
    """Share of rows whose argmax agrees once b's donor labels are
    matched to a's (restarts that reach one optimum may order the
    donors differently)."""
    from scipy.optimize import linear_sum_assignment
    K = a.shape[1]
    pa, pb = np.argmax(a, 1), np.argmax(b, 1)
    hits = np.zeros((K, K))
    np.add.at(hits, (pa, pb), 1)
    ra, rb = linear_sum_assignment(-hits)
    return hits[ra, rb].sum() / len(pa)


def phase_small_cross_check(torch):
    """The same seeded small pool on the card (float32, K1 kernel) and on
    the CPU (float64, K1's plain version): the same optimum and the same
    calls up to the donors' labels."""
    from vireo_tpu_torch.sim.synth import synth_pool_counts
    from vireo_tpu_torch.engine.wrap import vireo_wrap
    d = synth_pool_counts(600, 1500, 4, doublet_rate=0.08, density=0.1,
                          seed=1)
    gpu = vireo_wrap(d["AD"], d["DP"], n_donor=4, n_init=5, random_seed=2,
                     verbose=False, device="cuda")
    cpu = vireo_wrap(d["AD"], d["DP"], n_donor=4, n_init=5, random_seed=2,
                     verbose=False, device="cpu")
    agree = _matched_agreement(gpu["ID_prob"], cpu["ID_prob"])
    dbl_diff = float(np.max(np.abs(gpu["doublet_prob"].max(1)
                                   - cpu["doublet_prob"].max(1))))
    log("[small] card float32 vs CPU float64: argmax agreement %.5f after "
        "label matching, max |top doublet prob diff| %.3e, LB_doublet "
        "%.6e vs %.6e" % (agree, dbl_diff, gpu["LB_doublet"],
                          cpu["LB_doublet"]))
    if agree < 0.99:
        raise AssertionError("card and CPU calls disagree")
    # float32 vs float64 fits of one optimum: the ELBO to 1e-5
    np.testing.assert_allclose(gpu["LB_doublet"], cpu["LB_doublet"],
                               rtol=1e-5)


def phase_small_rungs(torch):
    """A seeded small pool with ~3% of its sites given an extra depth of
    150-400 reads (above both the int8 cap 127 and the nibble cap 15),
    their alleles drawn from the pool's own genotypes, on the
    int8-hybrid, packed-hybrid and COO rungs of the card (picked by the
    ladder under budgets in units of n_var x n_cell bytes, and handed to
    vireo_wrap prebuilt), against the dense rung on the CPU (float64):
    the same calls up to the donors' labels, and the ELBO to
    RUNG_ELBO_RTOL; and each rung's contractions, run twice, give the
    same sums bit for bit."""
    from vireo_tpu_torch.ops import counts
    from vireo_tpu_torch.sim.synth import synth_pool_counts
    from vireo_tpu_torch.engine.wrap import vireo_wrap
    import scipy.sparse as sp
    V, C, K = (SMALL_RUNGS[k] for k in ("n_var", "n_cell", "n_donor"))
    d = synth_pool_counts(V, C, K, doublet_rate=0.08, density=0.05, seed=5)
    rng = np.random.RandomState(5)
    DP = d["DP"].tocoo()
    hot = rng.rand(DP.nnz) < 0.03
    r, c = DP.row[hot], DP.col[hot]
    extra = rng.randint(150, 400, len(r))
    theta = np.array([0.01, 0.5, 0.99])
    p1 = theta[d["GT"][r, d["donor"][c]]]
    second = np.where(d["donor2"][c] >= 0, d["donor2"][c], d["donor"][c])
    p = 0.5 * (p1 + theta[d["GT"][r, second]])
    AD = sp.csc_matrix(d["AD"] + sp.csc_matrix(
        (rng.binomial(extra, p).astype(np.float64), (r, c)), shape=(V, C)))
    DP = sp.csc_matrix(d["DP"] + sp.csc_matrix(
        (extra.astype(np.float64), (r, c)), shape=(V, C)))
    vmax = float(DP.max())
    cpu = vireo_wrap(AD, DP, n_donor=K, n_init=5, random_seed=2,
                     verbose=False, device="cpu")
    for rung, units in (("int8-hybrid", 2), ("packed-hybrid", 1),
                        ("coo", 0)):
        budget = max(units * V * C, 1)
        if counts.ladder_rung((V, C), vmax, budget) != rung:
            raise AssertionError("budget %d does not give the %s rung"
                                 % (budget, rung))
        t0 = time.perf_counter()
        c = counts.counts_from_scipy(AD, DP, device=torch.device("cuda"),
                                     dense_budget=budget)
        _check_repeatable(torch, rung, c)
        gpu = vireo_wrap(c, n_donor=K, n_init=5, random_seed=2,
                         verbose=False)
        # doublet cells split their small singlet mass between two
        # donors almost evenly, so their singlet argmax is a near tie
        # that float32 and float64 may break apart: the calls compared
        # are the confident singlets (max ID_prob >= 0.9 on the CPU) and
        # the doublet calls (max doublet_prob >= 0.9)
        conf = cpu["ID_prob"].max(1) >= 0.9
        agree = _matched_agreement(gpu["ID_prob"][conf], cpu["ID_prob"][conf])
        dbl = np.mean((gpu["doublet_prob"].max(1) >= 0.9)
                      == (cpu["doublet_prob"].max(1) >= 0.9))
        log("[rungs] %s (%s%s) on the card vs dense on the CPU: argmax "
            "agreement %.5f over %d confident singlets after label "
            "matching (%.5f over all cells), doublet calls %.5f, "
            "LB_doublet %.6e vs %.6e, %.2f s"
            % (rung, type(c).__name__,
               "/" + type(c.base).__name__ if hasattr(c, "base") else "",
               agree, int(conf.sum()),
               _matched_agreement(gpu["ID_prob"], cpu["ID_prob"]), dbl,
               gpu["LB_doublet"], cpu["LB_doublet"],
               time.perf_counter() - t0))
        if agree < 0.99 or dbl < 0.99:
            raise AssertionError("%s calls disagree with the dense rung's"
                                 % rung)
        np.testing.assert_allclose(gpu["LB_doublet"], cpu["LB_doublet"],
                                   rtol=RUNG_ELBO_RTOL)


def _check_repeatable(torch, rung, c):
    """The rung's two contractions twice on the same weights: the same
    sums bit for bit (no atomics)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    W = torch.rand((c.n_cell, 8), generator=g, device="cuda")
    Wa = torch.rand((c.n_var, 8), generator=g, device="cuda")
    twice = [(*c.suff_stats(W), c.cell_loglik(Wa, -Wa)) for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*twice)):
        raise AssertionError("the %s rung's sums change from run to run"
                             % rung)


def phase_many_donors(torch):
    """A seeded 23-donor pool on the dense rung of the card: its doublet
    space has 23 + C(23,2) = 276 columns, more than one 256-column tile
    of K1 (and more than the first design's limit, at which such a pool
    raised). K1 must launch, and the confident singlet calls and the
    doublet calls must agree with the same call on the CPU (float64,
    K1's plain version) up to the donors' labels."""
    from vireo_tpu_torch.ops import fused_em
    from vireo_tpu_torch.sim.synth import synth_pool_counts
    from vireo_tpu_torch.engine.wrap import vireo_wrap
    V, C, K = (MANY_DONORS[k] for k in ("n_var", "n_cell", "n_donor"))
    d = synth_pool_counts(V, C, K, doublet_rate=0.08, density=0.2, seed=7)
    t0 = time.perf_counter()
    fused_em.LAUNCHES = 0
    gpu = vireo_wrap(d["AD"], d["DP"], n_donor=K, n_init=5, random_seed=2,
                     verbose=False, device="cuda")
    launches = fused_em.LAUNCHES
    wall = time.perf_counter() - t0
    cpu = vireo_wrap(d["AD"], d["DP"], n_donor=K, n_init=5, random_seed=2,
                     verbose=False, device="cpu")
    conf = cpu["ID_prob"].max(1) >= 0.9
    agree = _matched_agreement(gpu["ID_prob"][conf], cpu["ID_prob"][conf])
    dbl = float(np.mean((gpu["doublet_prob"].max(1) >= 0.9)
                        == (cpu["doublet_prob"].max(1) >= 0.9)))
    log("[donors] %d donors (%d doublet columns) on the card: %.2f s, K1 "
        "launches %d; vs the CPU: argmax agreement %.5f over %d confident "
        "singlets after label matching, doublet calls %.5f; %s"
        % (K, K + K * (K - 1) // 2, wall, launches, agree, int(conf.sum()),
           dbl, json.dumps(_singlet_accuracy(d, gpu["ID_prob"],
                                             gpu["doublet_prob"]))))
    if launches < 1:
        raise AssertionError("the 23-donor pool did not launch K1")
    if agree < 0.99 or dbl < 0.99:
        raise AssertionError("the 23-donor calls disagree with the CPU's")


def phase_cli():
    import gzip
    import scipy.io as sio
    from vireo_tpu_torch.sim.synth import synth_pool_counts
    from vireo_tpu_torch.cli import vireo_cli
    V, C = 2000, 5000
    d = synth_pool_counts(V, C, 4, doublet_rate=0.05, density=0.05, seed=3)
    with tempfile.TemporaryDirectory() as tmp:
        cell = os.path.join(tmp, "cellsnp")
        os.makedirs(cell)
        sio.mmwrite(os.path.join(cell, "cellSNP.tag.AD.mtx"),
                    d["AD"].astype(int))
        sio.mmwrite(os.path.join(cell, "cellSNP.tag.DP.mtx"),
                    d["DP"].astype(int))
        with gzip.open(os.path.join(cell, "cellSNP.base.vcf.gz"), "wt") as f:
            f.write("##fileformat=VCFv4.2\n")
            f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
            for v in range(V):
                f.write("1\t%d\t.\tA\tG\t.\tPASS\t.\n" % (100 + v))
        with open(os.path.join(cell, "cellSNP.samples.tsv"), "w") as f:
            f.write("".join("c%05d\n" % c for c in range(C)))
        out = os.path.join(tmp, "out")
        t0 = time.perf_counter()
        vireo_cli.main(["-c", cell, "-N", "4", "-o", out, "--randSeed", "1",
                        "--nInit", "5", "--noPlot"])
        with open(os.path.join(out, "donor_ids.tsv")) as f:
            rows = f.read().splitlines()
        log("[cli] donor_ids.tsv: %d rows for %d cells in %.2f s"
            % (len(rows) - 1, C, time.perf_counter() - t0))
        if len(rows) - 1 != C:
            raise AssertionError("donor_ids.tsv has %d rows, expected %d"
                                 % (len(rows) - 1, C))


def main():
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs only on a CUDA card\n")
        return 1
    sys.path.insert(0, REPO)
    from vireo_tpu_torch.utils.device import pin_matmul_precision
    pin_matmul_precision()

    phase_environment(torch)
    phase_build()
    k1 = phase_k1(torch)
    k23 = phase_k23(torch)
    d = _main_pool()
    dense_res, dense_launches = phase_main_path(torch, d)
    packed_launches = phase_packed_main_path(torch, d, dense_res)
    phase_profile(torch, d)
    del d, dense_res
    phase_small_cross_check(torch)
    phase_small_rungs(torch)
    phase_many_donors(torch)
    phase_cli()

    # each kernel at its main-path shape: K1 at the doublet phase's, K2
    # and K3 at the warm restarts' (N = 20 x 16)
    table = [
        ("fused_estep_stats", "vireo_tpu_torch/csrc/fused_estep.cu",
         "vireo_tpu/ops/pallas_em.py:145", dense_launches["K1"],
         k1["doublet"]),
        ("packed_suff_stats", "vireo_tpu_torch/csrc/packed_counts.cu",
         "vireo_tpu/ops/packed.py:161", packed_launches["K2"],
         k23[("warm", "suff_stats")]),
        ("packed_cell_loglik", "vireo_tpu_torch/csrc/packed_counts.cu",
         "vireo_tpu/ops/packed.py:195", packed_launches["K3"],
         k23[("warm", "cell_loglik")]),
    ]
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": res["max_abs_err"], "ms": res["ms"],
        "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
        "bound_by": res["bound_by"], "library_ms": res["library_ms"]}
        for name, source, replaces, launches, res in table]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
