#!/usr/bin/env python3
"""Proof that the PyTorch port (vireo_tpu_torch) runs on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the repository

Phases, in order; any failure raises and the script exits non-zero:

1. environment: torch, CUDA and nvcc versions, the card's name and power
   limit; there is no CPU path;
2. build: the CUDA kernel (K1) from the sources in the checkout;
3. K1 against its plain PyTorch version on the card, at the slice's two
   shapes, with the tolerances below, and both times;
4. the full-size main path: a seeded synthetic pool of 30000 variants x
   100000 cells x 16 donors with 8% doublets through
   `vireo_wrap(n_init=20, random_seed=0)`, with the kernel's launch
   count over that run, phase times, peak memory and accuracy against
   the simulation's truth; then a small pool run on the card and on the
   CPU, whose calls must agree;
5. the CLI on a small synthetic cellSNP folder.

The line before the last is the kernel table as JSON; the last line is
`{"ok": true, "device": {...}}`.
"""

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

FIT_SHAPE = dict(V=30000, C=8192, K=16, Ks=16)
DOUBLET_SHAPE = dict(V=30000, C=100000, K=136, Ks=16)
# K + C(K,2) for K = 20 donors with Ks = 20: more than 48 KB of shared
# memory in the E-step kernel and two stats columns per thread (checked,
# not timed)
EDGE_SHAPE = dict(V=1000, C=700, K=210, Ks=20)
# the full-size main path (benchmarks/e2e_100k.py's pool)
MAIN = dict(n_var=30000, n_cell=100000, n_donor=16, n_init=20)


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
    from vireo_tpu_torch.ops import fused_em
    t0 = time.perf_counter()
    fused_em._library()
    log("[build] K1 built and loaded in %.2f s" % (time.perf_counter() - t0))


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


def phase_k1(torch):
    from vireo_tpu_torch.ops import fused_em
    from vireo_tpu_torch.ops.counts import DenseCounts
    dev = torch.device("cuda")
    results = {}
    for label, shape in (("edge", EDGE_SHAPE), ("fit", FIT_SHAPE),
                         ("doublet", DOUBLET_SHAPE)):
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
        if label == "edge":
            continue

        def run_kernel():
            fused_em.fused_estep_stats(*args, stats_cols=Ks)

        def run_plain():
            fused_em.fused_estep_stats_reference(*args, stats_cols=Ks)

        run_kernel()
        run_plain()
        torch.cuda.synchronize()
        # in turns: plain, kernel, kernel, plain
        p_ms = _time_ms(torch, run_plain)
        k_ms = _time_ms(torch, run_kernel) + _time_ms(torch, run_kernel)
        p_ms += _time_ms(torch, run_plain)
        res = dict(ms=float(np.median(k_ms)), plain_ms=float(np.median(p_ms)),
                   max_abs_err=max(errs))
        log("[k1]   median ms: kernel %.3f  plain %.3f  (CUDA events, %d "
            "runs each)" % (res["ms"], res["plain_ms"], len(k_ms)))
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


def phase_main_path(torch):
    from vireo_tpu_torch.ops import fused_em
    from vireo_tpu_torch.sim.synth import synth_pool_counts
    from vireo_tpu_torch.engine.wrap import vireo_wrap

    V, C, K = MAIN["n_var"], MAIN["n_cell"], MAIN["n_donor"]
    t0 = time.perf_counter()
    d = synth_pool_counts(V, C, K, doublet_rate=0.08, density=0.01, seed=0)
    log("[main] pool %d x %d x %d, %d nonzeros, generated on the host in "
        "%.2f s" % (V, C, K, d["DP"].nnz, time.perf_counter() - t0))

    torch.cuda.reset_peak_memory_stats()
    phases = {}
    fused_em.LAUNCHES = 0
    t0 = time.perf_counter()
    res = vireo_wrap(d["AD"], d["DP"], n_donor=K, n_init=MAIN["n_init"],
                     random_seed=0, check_doublet=True, verbose=False,
                     timing=phases)
    wall = time.perf_counter() - t0
    launches = fused_em.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    for name, sec in phases.items():
        log("[main] phase %-15s %.3f s" % (name, sec))
    log("[main] vireo_wrap wall %.3f s, peak device memory %.3f GiB, K1 "
        "launches %d" % (wall, peak / 2**30, launches))
    if launches < 1:
        raise AssertionError("the main path did not launch K1")

    ID_prob, dbl = res["ID_prob"], res["doublet_prob"]
    assert ID_prob.shape == (C, K) and dbl.shape == (C, K * (K - 1) // 2)
    assert res["GT_prob"].shape == (V, K, 3)
    for key in ("ID_prob", "doublet_prob", "doublet_LLR", "GT_prob",
                "LB_list"):
        assert np.all(np.isfinite(res[key])), key
    np.testing.assert_allclose(ID_prob.sum(1) + dbl.sum(1), 1.0, atol=1e-4)
    acc = _singlet_accuracy(d, ID_prob, dbl)
    log("[main] " + json.dumps(acc))
    log("[main] LB_list max %.6e, LB_doublet %.6e"
        % (float(np.max(res["LB_list"])), float(res["LB_doublet"])))
    if acc["singlet_accuracy"] < 0.99:
        raise AssertionError("singlet accuracy %.5f < 0.99"
                             % acc["singlet_accuracy"])
    return launches


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
    launches = phase_main_path(torch)
    phase_small_cross_check(torch)
    phase_cli()

    main_shape = k1["doublet"]
    print(json.dumps({"kernels": [{
        "name": "fused_estep_stats",
        "route": "cuda",
        "source": "vireo_tpu_torch/csrc/fused_estep.cu",
        "replaces": "vireo_tpu/ops/pallas_em.py:145",
        "launches": launches,
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
