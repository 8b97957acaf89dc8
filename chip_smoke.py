#!/usr/bin/env python3
"""Proof that the PyTorch port (vireo_tpu_torch) runs on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the repository

Phases, in order; any failure raises and the script exits non-zero:

1. environment: torch, CUDA and nvcc versions, the card's name and power
   limit; there is no CPU path;
2. build: the CUDA kernels, K1 (csrc/fused_estep.cu), K2/K3
   (csrc/packed_counts.cu) and the probes' A/B (csrc/probe_nibbles.cu)
   and C/D (csrc/probe_coo.cu), from the sources in the checkout, one
   nvcc for each, started together;
3. K1 against its plain PyTorch version on the card, at the slice's
   shapes (two edge shapes, one with K above 256 and an unaligned C;
   the fit over 8192 cells and the fused fit's iteration on the main
   pool; the 16- and 24-donor doublet phases), with the tolerances
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
4b. `[probes]`: the kernels of the probes of benchmarks/
   (vireo_tpu_torch/probes/) against their plain versions: A
   (nibble_unpack) in its three variants bit for bit at the probe's
   256 x 512 bytes and the main pool's packed AD (30000 x 50000 bytes);
   B (packed_mm) in its three codecs at 30000 x 100000 @ 100000 x 16,
   exactly on integer weights and on sparse weights that use every bit
   of a bf16 significand, and on random bf16 weights within a
   probabilistic sum bound against float64 sums, and equal to itself on
   a second launch; C (coo_gather) in both layouts at 4,194,304
   nonzeros over 100000 cells (W through L2) and 3500 (W in shared
   memory), against float64 sums within the bound of its summation
   tree's depth (read from the library), and equal to itself on a
   second launch; D (coo_scatter) within Higham's bound a bin; each
   timed against its plain version in turns, beside its library call
   (B: the bf16 dense product of the unpacked counts, and the int8
   counts converted in the call; C: index_select and a product; D:
   index_add_; A: none) and its bound; B's plan (blocks an SM from the
   occupancy API, grid, units, waves, ring stages, bytes in flight an
   SM) and its control (the ring without the MMAs) timed once; C's
   blocks and threads an SM, waves and loads in flight; A's, B's and
   C's registers and instruction counts (cuobjdump, via
   ops/sass.py); then the four probes' entry points at their JAX
   defaults (and coo_pallas_probe again at PB_CELLS=3500, W in shared
   memory), each with the launch counts set to 0 just before it and
   read just after: each launches exactly the kernels and counts its
   code calls for, and these are the probes' launches in the kernels
   line. The probes lie on no path of vireo_wrap: their launches in
   phases 7 and 8 must be 0;
5. `[mt]`: the main call's seeded inits (20 restarts, 60.8M doubles of
   numpy's stream) drawn on the host and regenerated on the card
   (ops/mt19937.py): equal bit for bit, numpy's position equal after,
   both timed, the card's peak memory;
6. `[synth]`: synth_pool_dense_device at the main pool's size on the
   card: time, peak memory, and density, mean depth, doublet share and
   allele fractions against the numpy pool within the stated tolerances;
7. the full-size main path on the dense rung: a seeded synthetic pool
   of 30000 variants x 100000 cells x 16 donors with 8% doublets
   through `vireo_wrap(n_init=20, random_seed=0)` (its seeded inits
   regenerated on the card, as in phase 5), with K1's launch
   count over that run, phase times, peak memory and accuracy against
   the simulation's truth;
8. the same pool and call on the packed rung, chosen by the ladder under
   VIREO_DENSE_BUDGET_GB=4: K2's and K3's launch counts (and no K1),
   phase times, peak memory, accuracy, and agreement with the dense
   run's calls; then both runs again under torch.profiler: each rung's
   device time by kernel and the device's idle share;
9. the fused EM fit on the main pool's dense int8 counts (K1 in every
   iteration; its launches must equal the fit's iterations) against the
   unfused float32 fit from the same seeded init: iterations, time per
   iteration, ELBOs, accuracy and the agreement of their calls;
10. the donor-genotype modes on the main pool through vireo_wrap on the
   dense rung (K1 in the doublet phase): every donor known (with the
   ambient-RNA phase), a superset (12 of 16 known, 20 restarts), a
   subset (the 16 among 4 decoys); then every donor known, with the
   ambient phase, on the packed rung (K2, K3; its SNP gate goes through
   K2): launch counts, phase times, peak memory and singlet accuracy >=
   0.99 (without label matching where every donor is known); the
   ambient phase's selected SNPs, seconds and slowest chunk, and its
   gates: argmax psi is the simulated donor for >= AMBIENT_ACC of the
   true singlets on each rung, the two rungs agree on >= AMBIENT_AGREE
   of cells, and on AMBIENT_CPU_CELLS cells the card's float32 EM
   agrees with the CPU's float64 EM from the same psi0 and theta on >=
   AMBIENT_AGREE;
11. the binomial mixture model at full width on the packed counts
   (BinomMixtureVB(n_donor=16), 10 restarts, the JAX defaults): K2's and
   K3's launches equal the warm restarts' longest run plus the refit's
   iterations; time, ms an iteration, peak memory, singlet accuracy
   after label matching (reported);
12. the CLI at full width from disk (`[cli_full]`): the main pool
   written as a cellSNP folder (timed apart), then `vireo -c DIR -N 16
   --randSeed 0 --noPlot` at the default --nInit 50 (152M init doubles
   through the device stream; K1 in the doublet phase): the native reader
   built and loaded, the matrices it read equal the pool, singlet
   accuracy >= 0.99 from donor_ids.tsv after label matching; each phase,
   the disk-to-answer wall time and the peak memory;
13. small pools on the card against the CPU: the dense rung, the
   extra-donor and superset branches, then the int8-hybrid,
   packed-hybrid and COO rungs of a heavy-tailed pool, with the ambient
   phase (each rung's contractions also run twice and must give the
   same sums bit for bit), then a 23-donor pool on the dense rung,
   whose doublet space (K = 276 columns) goes through K1; the BMM on
   the dense and packed rungs, a seeded sweep_n_donor over K = 2..6 and
   a sweep_n_clone, and VireoBulk with LikRatio_test;
14. checkpoints on the card: resumes after either phase give the
   uninterrupted run's results bit for bit;
15. the CLI on a small synthetic cellSNP folder: genotype-free (with its
   learnt donors' VCF; then the native .tsv.gz writer against the Python
   writer's bytes on this machine), with a donor VCF (-d, -t GT), then
   with --callAmbientRNAs under VIREO_TIMING=1 (prop_ambient.tsv and the
   per-phase summary); GTbarcode on the in-tree golden, byte for byte;
16. `[mesh_nccl]`: this process joins an NCCL world of one rank and runs
   phase 7's call on a cells mesh (parallel/mesh.py): its ID_prob,
   LB_list, doublet outputs and every fit's iterations equal phase 7's
   bit for bit (an all-reduce over one rank is exact); K1's launches,
   the phases and the peak memory;
17. `[mesh_cli]`: `python -m torch.distributed.run --standalone
   --nproc-per-node 2 -m vireo_tpu_torch.cli.vireo_cli -c <phase 12's
   folder> -N 16 --randSeed 0 --noPlot --nInit 20 --mesh 1x2 --timing`:
   the two ranks share the card over gloo, on the dense rung, K1 on each
   rank in the doublet phase (each rank's launches and peak memory from
   its own log line); singlet accuracy >= MESH_ACC from donor_ids.tsv
   and >= MESH_AGREE of the singlets called as in phase 7, after label
   matching; the wall time and rank 0's phases;
18. `[mesh_packed]`: two ranks spawned here share the card, each reads
   its half of the folder (`load_cellSNP_sharded`), packs it
   (MeshPackedCounts) and runs phase 8's call on a 1 x 2 mesh: K2's and
   K3's launches on each rank equal phase 8's, singlet accuracy >=
   MESH_ACC and >= MESH_AGREE of the singlets called as in phase 8; then
   K2 and K3 on rank 0's block against their plain versions with phase
   4's tolerances;
19. `[mesh_small]`: `parallel.dryrun.dryrun_multichip` on the card with
   four ranks, on a 1 x 4 and a 2 x 2 mesh: every rung against one rank.

Before the kernel table it prints the whole command's seconds. The line
before the last is the kernel table as JSON; the last line is
`{"ok": true, "device": {...}}`.
"""

import contextlib
import io
import json
import re
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
# rows are not 16-byte aligned; fit: the EM fit's N = 16 over 8192
# cells; fit_full: one iteration of the fused fit on the main pool;
# doublet and doublet24: the doublet phases of 16 and 24 donors
K1_SHAPES = (
    ("edge", dict(V=1000, C=700, K=210, Ks=20), False),
    ("edge_wide", dict(V=1000, C=701, K=276, Ks=23), False),
    ("fit", dict(V=30000, C=8192, K=16, Ks=16), True),
    ("fit_full", dict(V=30000, C=100000, K=16, Ks=16), True),
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
# --- the probes of benchmarks/ (vireo_tpu_torch/probes/): kernels A-D ---
# A (nibble_unpack) bit for bit at the probe's (256, 512) bytes and at
# the main pool's packed AD, 30000 x 50000 bytes, timed there; B
# (packed_mm) at int4_micro's 30000 x 100000 @ 100000 x 16; C
# (coo_gather) at 4,194,304 nonzeros over C = 100000 cells (W read
# through L2) and C = 3500 (W staged in shared memory), in both layouts;
# D (coo_scatter) at 4,194,304 nonzeros.
PROBE_UNPACK = ((256, 512), (30000, 50000))
PROBE_MM = (30000, 100000, 16)
PROBE_NNZ = 4_194_304
PROBE_CELLS = (100_000, 3_500)
# calls of a probe's kernel timed back to back, beside the median of
# single calls (which also holds the host's work for the call)
PROBE_STREAM = 20
# C: each of its sums is a tree (csrc/probe_coo.cu): a thread's FMAs over
#   the nonzeros it takes (at most `per_thread`, four lanes sharing each
#   nonzero's row, one column set a lane), a shuffle tree over the 8
#   quads of lanes of a warp (`shuffle_levels`, 3), the `warps` of a
#   block in order, then the blocks in order (`blocks`), the four counts
#   read from the library for each launch (coo_pallas_probe.gather_shape).
#   A term passes through at most d = per_thread + shuffle_levels +
#   warps + blocks roundings (each FMA rounds once; the first add of each
#   chain is onto an exact 0), so against float64 sums C errs by at most
#   gamma_d sum|terms| (Higham's bound for a summation tree of height
#   d, Accuracy and Stability of Numerical Algorithms, 2002, §4.2), and
#   against the plain float32 version (whose order is torch's) by at most
#   (gamma_d + gamma_nnz) sum|terms|.
# B: every product (a nibble, or a byte, times a bf16 weight) is exact in
#   float32, so only the order of the adds differs from the plain version.
#   Exactly equal to it on integer weights (-2..2), and on sparse weights
#   +-m 2^-7 (m odd, 129..255: all eight bits of a bf16 significand; one
#   row in PROBE_MM_SPARSE nonzero) whose sums stay below 2^24 units of
#   2^-7, checked on the data, so that every order of adds is exact. On
#   random normal weights against float64 sums within Higham and Mary's
#   probabilistic bound (SIAM J. Sci. Comput. 41(5), 2019), lambda
#   sqrt(n) u sum|terms|, n the k values of an output (C cells; C / 2
#   bytes for raw_byte): with lambda = 8 an output exceeds it with
#   probability below 2n exp(-lambda^2 / 2) = 3e-9 when the rounding
#   errors are independent and of mean zero. The tensor cores truncate
#   within each 64-deep k-block, which biases those errors; summed over
#   the k-blocks (which the CUDA cores add with rounding) that bias stays
#   below 1/40 of the bound at these counts.
PROBE_MM_SPARSE = 128
PROBE_MM_LAMBDA = 8.0
# D: a bin's n nonzeros are added by atomics in some order within a
#   block, then the blocks' tiles in order, so (gamma_(n + blocks) +
#   gamma_n) sum|v| over the bin against the plain version.
# float32 outside the tensor cores (C's and D's adds), NVIDIA's data
# sheet, H100 SXM
PEAK_F32_FLOPS = 67e12
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
# the fused fit (K1 in every iteration, bf16 weights and assignments)
# against the unfused float32 fit_vb from one seeded init on the main
# pool. A random init does not do: over ~1000 cells a variant the
# donors' weights differ by less than bf16 resolves, every assignment
# comes out exactly uniform and the fit stays there, in the JAX
# package's fused fit as in the port's
# (tests/test_torch_fused.py::test_an_uninformative_init_loses_every_donor_as_in_jax).
# So the init is seeded halfway (FUSED_MIX) between the main run's
# answer and a random draw: the refit of a found optimum, the fused
# fit's use. The fused fit's own ELBO reads low: its weights cluster at
# a few values (one per genotype category), so their bf16 rounding errs
# the same way at most entries, which the loglik sum does not average
# out. So the gate is on the two final states, each scored by one more
# unfused float32 iteration: their ELBOs to FUSED_ELBO_RTOL (where each
# fit's 0.01 stop test falls moves them by far less), and the calls of
# the true singlets after label matching (a doublet's singlet call is a
# near tie between its two donors, which either fit may break).
FUSED_SEED = 0
FUSED_MIX = 0.5
FUSED_ELBO_RTOL = 1e-4
FUSED_AGREE = 0.999
# the donor-genotype modes on the main pool: the simulation's genotypes
# as one-hot probabilities smoothed by GT_EPS; the superset knows the
# first SUPERSET_KNOWN donors; the subset adds SUBSET_DECOYS donors drawn
# from the pool's own allele frequencies
GT_EPS = 0.01
SUPERSET_KNOWN = 12
SUBSET_DECOYS = 4
# a small pool's donor branches on the card (float32) against the CPU
# (float64): the ELBO to BRANCH_ELBO_RTOL (float32 round-off moves the
# point where a fit's 0.01 stop test falls)
SMALL_BRANCHES = dict(n_var=600, n_cell=1500, n_donor=4)
BRANCH_ELBO_RTOL = 1e-4
# the ambient phase at full width: argmax psi of the true singlets is
# their simulated donor (every donor known: donor k of the prior is donor
# k of psi); the dense and packed runs, and the card's float32 EM and the
# CPU's float64 EM on AMBIENT_CPU_CELLS cells from the same psi0 and
# theta, agree on argmax psi
AMBIENT_ACC = 0.99
AMBIENT_AGREE = 0.999
AMBIENT_CPU_CELLS = 2048
# the small pools' ambient psi on the card and the CPU: argmax agreement
# over the CPU's confident cells (max psi >= 0.9; a doublet's psi is a
# near tie between its two donors)
SMALL_AMBIENT_AGREE = 0.99
# the binomial mixture model at full width: the JAX package's defaults
BMM_FIT = dict(n_init=10, max_iter_pre=100, max_iter=200, random_seed=0)
# the small pool's K sweep and bulk sample
SWEEP_KS = (2, 3, 4, 5, 6)
BULK_PSI_ATOL = 1e-4
# the device pool generator at the main pool's size against the numpy
# pool: density relative 3% (numpy draws coverage with replacement by a
# Gamma popularity and drops repeats, ~1% fewer at density 0.01; the
# device draws a Bernoulli per entry), mean depth of covered entries
# relative 1% (1 + Poisson(0.6) over ~3e7 entries: sd ~2e-4), doublet
# share absolute 0.005 (a Bernoulli share of 1e5 cells at 0.08: sd
# 8.6e-4), and the singlets' allele fraction at each genotype within
# SYNTH_THETA_ATOL of theta over the first 2000 variants (~1.8e6 reads)
SYNTH_DENSITY_RTOL, SYNTH_DEPTH_RTOL, SYNTH_DOUBLET_ATOL = 0.03, 0.01, 0.005
SYNTH_THETA_ATOL = 0.005
# the CLI from disk at full width: the CLI's default --nInit, 152M init
# doubles through the device stream
CLI_FULL_N_INIT = 50
# the mesh phases on the main pool: singlet accuracy, and the share of
# singlets called as in the single-device run of the same call, after
# label matching (the ranks sum in another order, and near-tied doublet
# singlets may turn)
MESH_ACC = 0.99
MESH_AGREE = 0.999
# iterations the packed mesh's refit may stop away from phase 8's: a
# float32 ELBO near -1.15e7 meets the 0.01 stop test only when two
# iterations are equal, and the refits of the main pool stopped after 11
# (dense), 22 (packed) and 12 (packed, 1 x 2 mesh) iterations
# (PERF.md section 7)
MESH_REFIT_SLACK = 15
# seconds the spawned ranks of a mesh phase may take
MESH_TIMEOUT_S = 600


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
    """The four kernel libraries, their nvcc runs started together."""
    from concurrent.futures import ThreadPoolExecutor
    from vireo_tpu_torch.ops import fused_em, packed
    from vireo_tpu_torch.probes import coo_pallas_probe, nibbles
    t0 = time.perf_counter()
    libs = (fused_em, packed, nibbles, coo_pallas_probe)
    with ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(m._library) for m in libs]:
            f.result()
    log("[build] K1, K2/K3 and the probes' A/B and C/D built and loaded in "
        "%.2f s" % (time.perf_counter() - t0))


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


def _singlet_accuracy(d, ID_prob, doublet_prob, match=True):
    """As benchmarks/e2e_100k.py: optimal label matching over true
    singlets (none when `match` is False: donor k of the calls must be
    donor k of the truth), accuracy over confident calls, doublet recall
    and FPR."""
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
    remap = np.arange(K)
    if match:
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


def _bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """(ms, what bounds it): the larger of flops at `peak` (the bf16
    peak by default) and bytes at the memory's rate."""
    ops_ms = flops / peak * 1e3
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


def _k23_calls():
    """(kernel, plain) calls of K2 and K3 on a PackedCounts, by name;
    each returns a tuple of outputs."""
    from vireo_tpu_torch.ops import packed
    kern = {"suff_stats": lambda pc, *w: pc.suff_stats(*w),
            "cell_loglik": lambda pc, *w: (pc.cell_loglik(*w),)}
    plain = {"suff_stats": lambda pc, *w: packed.suff_stats_reference(
                 pc.ad_p, pc.dp_p, pc.n_cell, *w),
             "cell_loglik": lambda pc, *w: (packed.cell_loglik_reference(
                 pc.ad_p, pc.dp_p, pc.n_cell, *w),)}
    return kern, plain


def _float_check(torch, name, kern, plain, pc, w):
    """The kernel on float weights within Higham's bound of its plain
    version (the tolerance above K2_TERMS_GAIN); its max |error|."""
    V, C = pc.shape
    got = kern(pc, *w)
    ref = plain(pc, *w)
    mag = plain(pc, *(x.abs() for x in w))
    sides = (3 * C, C) if name == "suff_stats" else (6 * V, 2 * V)
    gamma = sum(n * F32_UNIT / (1 - n * F32_UNIT) for n in sides)
    return max(_bound_check("%s[%d] float" % (name, i), gt, rf, gamma * m)
               for i, (gt, rf, m) in enumerate(zip(got, ref, mag))), got


def phase_k23(torch):
    """K2 and K3 against their plain versions at K23_SHAPES."""
    from vireo_tpu_torch.ops import counts, packed
    dev = torch.device("cuda")
    kern, plain = _k23_calls()
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
            err, got = _float_check(torch, name, kern[name], plain[name], pc,
                                    w)
            res = dict(max_abs_err=err)
            res["err_vs_f64"] = _term_errors(torch, name, kern[name],
                                             plain[name], pc, w, got)
            del got
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


def _bound_check(name, got, ref, bound, tag="k23"):
    err = (got - ref).abs()
    bad = int((err > bound).sum())
    rel = float((err / ref.abs().clamp(min=1e-30)).max())
    ratio = float((err / bound.clamp(min=1e-30)).max())
    log("[%s]   %-22s max_abs_err %.3e  max|ref| %.3e  max rel err %.3e  "
        "max bound %.3e  max err/bound %.3f  %s"
        % (tag, name, float(err.max()), float(ref.abs().max()), rel,
           float(bound.max()), ratio, "ok" if bad == 0 else "%d OVER" % bad))
    if bad:
        raise AssertionError("%s disagrees with its plain version" % name)
    return float(err.max())


def _sms(torch):
    return torch.cuda.get_device_properties(0).multi_processor_count


def _gamma(n):
    """Higham's gamma_n of float32 (n a number or a tensor)."""
    return n * F32_UNIT / (1 - n * F32_UNIT)


def _probe_times(torch, tag, res, kern, plain, library, flops, nbytes,
                 peak=PEAK_BF16_FLOPS, kernels=()):
    """Kernel and plain version in turns, the library call (None where
    there is none) and the bound, into res; the kernel's calls back to
    back, and the device time of its CUDA kernels (names holding one of
    `kernels`) from torch.profiler; logged."""
    res["ms"], res["plain_ms"], nrun = _timed_pair(torch, kern, plain)
    res["library_ms"] = (None if library is None else
                         float(np.median(_time_ms(torch, library, reps=6))))
    res["bound_ms"], res["bound_by"] = _bound(flops, nbytes, peak)
    # the kernel's calls back to back, so the host's work for one call
    # overlaps the card's for the one before
    def stream():
        for _ in range(PROBE_STREAM):
            kern()
    res["stream_ms"] = _time_ms(torch, stream)[-1] / PROBE_STREAM
    by_name = _kernel_ms(torch, kern, kernels)
    res["device_by_kernel"] = by_name
    res["device_ms"] = (None if None in by_name.values()
                        else sum(by_name.values()))
    log("[probes]   %s median ms: kernel %.4f  plain %.4f  library %s "
        "(CUDA events, %d runs each); bound %.4f ms (%s): the kernel at "
        "%.1f%% of it; %d calls back to back %.4f ms a call; device time "
        "of its kernels (torch.profiler) %s"
        % (tag, res["ms"], res["plain_ms"],
           "none" if library is None else "%.4f" % res["library_ms"], nrun,
           res["bound_ms"], res["bound_by"],
           100.0 * res["bound_ms"] / res["ms"], PROBE_STREAM,
           res["stream_ms"],
           ", ".join("%s %s" % (k, "not measured" if v is None
                                else "%.4f ms" % v)
                     for k, v in by_name.items())))
    return res


def _probe_unpack(torch, nibbles, dev):
    """Kernel A's three variants bit for bit against the plain version;
    timed at the larger shape. No single PyTorch call computes both
    planes, so A has no library time."""
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    out = {}
    for R, C in PROBE_UNPACK:
        p = torch.randint(0, 256, (R, C), generator=g, dtype=torch.uint8,
                          device=dev)
        ref = nibbles.nibble_unpack_reference(p)
        for variant in nibbles.VARIANTS:
            got = nibbles.nibble_unpack(p, variant)
            for a, b in zip(got, ref):
                if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
                    raise AssertionError("nibble_unpack %s at %d x %d "
                                         "differs from its plain version"
                                         % (variant, R, C))
            del got
            log("[probes] A nibble_unpack %-7s %d x %d bytes: both planes "
                "equal to the plain version bit for bit" % (variant, R, C))
            if (R, C) == PROBE_UNPACK[-1]:
                out["nibble_unpack_" + variant] = _probe_times(
                    torch, "A " + variant, dict(max_abs_err=0.0),
                    lambda: nibbles.nibble_unpack(p, variant),
                    lambda: nibbles.nibble_unpack_reference(p), None,
                    0.0, 5.0 * R * C, kernels=("nibble_unpack_kernel",))
        del p, ref
        torch.cuda.empty_cache()
    return out


def _mm_magnitude(torch, nibbles, p, we, wo, codec):
    """sum|terms| of each of kernel B's outputs, in float64."""
    if codec != "raw_byte":
        return nibbles.packed_mm_reference(p, we.abs(), wo.abs(), codec,
                                           dtype=torch.float64)
    wa = we.double().abs()
    return torch.cat([torch.matmul(rows.view(torch.int8).double().abs(), wa)
                      for rows in p.split(4096)])


def _full_mantissa_weights(torch, shape, g, dev):
    """+-m 2^-7 (m odd, 129..255) in one row of PROBE_MM_SPARSE, else 0."""
    m = 129 + 2 * torch.randint(0, 64, shape, generator=g, device=dev)
    sign = 2 * torch.randint(0, 2, shape, generator=g, device=dev) - 1
    keep = torch.rand(shape, generator=g, device=dev) < 1.0 / PROBE_MM_SPARSE
    return (m * sign * keep).float() * 2.0 ** -7


def _probe_mm(torch, nibbles, dev):
    """Kernel B's three codecs against the plain version: exactly on
    integer weights and on sparse weights that use every bit of a bf16
    significand, and on random bf16 weights within the probabilistic sum
    bound against float64 sums (PROBE_MM_LAMBDA); timed beside the dense
    products of the unpacked counts (cuBLAS, bf16)."""
    from vireo_tpu_torch.ops.packed import pack_nibbles
    from vireo_tpu_torch.probes import int4_micro
    V, C, K = PROBE_MM
    x8, w, _ = int4_micro.make_pool(V, C, K, dev, seed=1)
    p = pack_nibbles(x8)
    Cb = p.shape[1]
    g = torch.Generator(device=dev)
    g.manual_seed(V + C + K)
    # weights whose sums are exact in float32 in any order of adds while
    # sum|terms| stays below 2^24 of their unit (checked on the data)
    exact = {
        "integer": (1.0, [torch.randint(-2, 3, (Cb, K), generator=g,
                                        device=dev).float()
                          for _ in range(2)]),
        "full-significand": (2.0 ** -7, [
            _full_mantissa_weights(torch, (Cb, K), g, dev)
            for _ in range(2)])}
    we, wo = (x.to(torch.bfloat16).float()
              for x in int4_micro.split_weights(w))
    wb = w.to(torch.bfloat16)
    xb = x8.to(torch.bfloat16)
    lib_ms = float(np.median(_time_ms(torch, lambda: torch.matmul(xb, wb),
                                      reps=6)))
    lib_err = float((torch.matmul(xb, wb).float() - nibbles.
                     packed_mm_reference(p, we, wo)).abs().max())
    int8_ms = float(np.median(_time_ms(
        torch, lambda: torch.matmul(x8.to(torch.bfloat16), wb), reps=6)))
    del x8
    torch.cuda.empty_cache()
    log("[probes] B library: torch.matmul of the bf16 counts (%d x %d) "
        "by bf16 W %.4f ms (max |diff| from the plain version %.3e, its "
        "bf16 output); with the int8 counts converted to bf16 in the call "
        "%.4f ms" % (V, C, lib_ms, lib_err, int8_ms))
    out = {}
    for codec in nibbles.CODECS:
        raw = codec == "raw_byte"
        n = Cb if raw else 2 * Cb
        for kind, (unit, ws) in exact.items():
            got = nibbles.packed_mm(p, *ws, codec=codec)
            ref = nibbles.packed_mm_reference(p, *ws, codec=codec)
            top = float(_mm_magnitude(torch, nibbles, p, *ws, codec).max())
            if top >= 2.0 ** 24 * unit:
                raise AssertionError("B %s %s weights: sum|terms| %.0f "
                                     "is not exact in float32"
                                     % (codec, kind, top))
            if not torch.equal(got, ref):
                raise AssertionError(
                    "packed_mm %s on %s weights differs from its plain "
                    "version by %.3e" % (codec, kind,
                                         float((got - ref).abs().max())))
            log("[probes] B packed_mm %s %d x %d @ %d x %d: %s weights "
                "equal to the plain version (largest sum|terms| %.0f, "
                "exact below %.0f)" % (codec, V, C, C, K, kind, top,
                                       2.0 ** 24 * unit))
        got = nibbles.packed_mm(p, we, wo, codec)
        if not torch.equal(got, nibbles.packed_mm(p, we, wo, codec)):
            raise AssertionError("packed_mm %s gave other sums on a second "
                                 "launch" % codec)
        ref64 = nibbles.packed_mm_reference(p, we, wo, codec,
                                            dtype=torch.float64)
        mag = _mm_magnitude(torch, nibbles, p, we, wo, codec)
        _bound_check("B %s f64" % codec, got, ref64,
                     PROBE_MM_LAMBDA * n ** 0.5 * F32_UNIT * mag,
                     tag="probes")
        err = float((got - nibbles.packed_mm_reference(p, we, wo, codec))
                    .abs().max())
        log("[probes] B %s on normal weights: max |err| against float64 "
            "%.3e, rms of the outputs %.3e; against the float32 plain "
            "version %.3e" % (codec, float((got - ref64).abs().max()),
                              float(ref64.pow(2).mean().sqrt()), err))
        del got, ref64, mag
        res = _probe_times(
            torch, "B " + codec, dict(max_abs_err=err, int8_ms=int8_ms),
            lambda: nibbles.packed_mm(p, we, wo, codec),
            lambda: nibbles.packed_mm_reference(p, we, wo, codec),
            lambda: torch.matmul(xb, wb),
            2.0 * V * n * K, V * Cb + (1 if raw else 2) * Cb * K * 2.0
            + 4.0 * V * K, kernels=("packed_mm_kernel", "sum_slices_kernel"))
        res.update(_mm_geometry(torch, nibbles, p, we, wo, codec, res))
        out["packed_mm_" + codec] = res
    del p, xb
    torch.cuda.empty_cache()
    return out


def _mm_geometry(torch, nibbles, p, we, wo, codec, res):
    """Kernel B's plan and ring on this card (blocks an SM from the
    occupancy API), logged; and its control, the same ring and fragment
    build without the MMAs, timed once against the kernel."""
    V, Cb = p.shape
    shape = nibbles.mm_shape(codec)
    plan = nibbles.card_plan(V, Cb, we.shape[1], codec, p.device)
    flight = shape["blocks_per_sm"] * shape["ring"] * nibbles.TILE[0] \
        * nibbles.TILE[1]
    # device times (torch.profiler) of the control's and the kernel's
    # packed_mm_kernel
    control_ms = _kernel_ms(
        torch, lambda: nibbles.packed_mm_control(p, we, wo, codec),
        ("packed_mm_kernel",))["packed_mm_kernel"]
    kernel_ms = res["device_by_kernel"]["packed_mm_kernel"]
    log("[probes]   B %s: %d blocks an SM, grid %d, %d units (%d stages "
        "of %d k values in %d slices of %d), %.3f waves; ring %d stages "
        "of %d bytes, %d bytes of counts in flight an SM; device time of "
        "the control (no MMAs) %s against the kernel's %s"
        % (codec, shape["blocks_per_sm"], plan["grid"], plan["units"],
           plan["stages"], plan["stage_k"], plan["n_slices"],
           plan["slice_stages"], plan["waves"], shape["ring"],
           shape["stage_bytes"], flight,
           "not measured" if control_ms is None else "%.4f ms" % control_ms,
           "not measured" if kernel_ms is None else "%.4f ms" % kernel_ms))
    return dict(blocks_per_sm=shape["blocks_per_sm"], grid=plan["grid"],
                waves=plan["waves"], ring=shape["ring"],
                bytes_in_flight=flight, control_ms=control_ms)


def _probe_coo(torch, coo, dev):
    """Kernel C in both layouts at each of PROBE_CELLS and kernel D,
    against their plain versions within the bounds stated above; timed
    beside index_select and a product (C) and index_add_ (D)."""
    nnz, K = PROBE_NNZ, coo.K
    g = torch.Generator(device=dev)
    g.manual_seed(nnz)
    val = torch.rand(nnz, generator=g, device=dev)
    out = {}
    for C in PROBE_CELLS:
        idx = torch.randint(0, C, (nnz,), generator=g, dtype=torch.int32,
                            device=dev)
        for layout in coo.LAYOUTS:
            sh = coo.gather_shape(nnz, C, layout)
            staged = bool(sh["staged"])
            depth = (sh["per_thread"] + sh["shuffle_levels"] + sh["warps"]
                     + sh["blocks"])
            shape = (C, K) if layout == "rows" else (K, C)
            w = torch.rand(shape, generator=g, device=dev)
            got = coo.coo_gather(idx, val, w, layout)
            if not torch.equal(got, coo.coo_gather(idx, val, w, layout)):
                raise AssertionError("coo_gather %s C=%d gave other sums "
                                     "on a second launch" % (layout, C))
            ref64 = coo.coo_gather_reference(idx, val, w, layout,
                                             dtype=torch.float64)
            ref = coo.coo_gather_reference(idx, val, w, layout)
            tag = "C %s C=%d (W %s)" % (layout, C, "in shared memory"
                                        if staged else "through L2")
            _bound_check(tag + " f64", got.double(), ref64,
                         _gamma(depth) * ref64, tag="probes")
            err = _bound_check(tag + " f32", got, ref,
                               (_gamma(depth) + _gamma(nnz))
                               * ref64.float(), tag="probes")
            if layout == "rows":
                library = lambda: coo.take_sum(idx, val, w)  # noqa: E731
            else:
                library = lambda: torch.matmul(  # noqa: E731
                    w.index_select(1, idx), val)
            name = "coo_gather_%s%s" % (layout, "_smem" if staged else "")
            out[name] = _probe_times(
                torch, tag, dict(sh, max_abs_err=err, staged=staged,
                                 depth=depth),
                lambda: coo.coo_gather(idx, val, w, layout),
                lambda: coo.coo_gather_reference(idx, val, w, layout),
                library, 2.0 * nnz * K, 8.0 * nnz + 4.0 * C * K + 4.0 * K,
                PEAK_F32_FLOPS,
                kernels=("coo_gather_kernel", "sum_rows_kernel")
                + (("transpose_kernel",) if layout == "cols" and not staged
                   else ()))
            log("[probes]   %s: %d blocks an SM of %d threads (%d threads "
                "an SM), %d blocks, %.3f waves; %d W-row loads of 16 bytes "
                "in flight a thread (%d bytes an SM); sums' depth %d; the "
                "64-byte rows' L2 traffic (%.1f MB) at %.2f TB/s"
                % (tag, sh["blocks_per_sm"], sh["threads"],
                   sh["blocks_per_sm"] * sh["threads"], sh["blocks"],
                   sh["blocks"] / (sh["blocks_per_sm"] * _sms(torch)),
                   sh["loads_in_flight"], sh["blocks_per_sm"] * sh["threads"]
                   * sh["loads_in_flight"] * 16, depth, 64e-6 * nnz,
                   64.0 * nnz / (out[name]["ms"] * 1e9)))
            del w
    r = torch.randint(0, coo.TILE[0], (nnz,), generator=g,
                      dtype=torch.int32, device=dev)
    c = torch.randint(0, coo.TILE[1], (nnz,), generator=g,
                      dtype=torch.int32, device=dev)
    got = coo.coo_scatter(r, c, val)
    ref = coo.coo_scatter_reference(r, c, val)
    n = coo.coo_scatter_reference(r, c, torch.ones_like(val))
    blocks = coo.scatter_blocks(nnz)
    err = _bound_check("D scatter", got, ref,
                       (_gamma(n + blocks) + _gamma(n)) * ref,
                       tag="probes")
    flat = r.long() * coo.TILE[1] + c.long()
    tile = torch.zeros(coo.TILE[0] * coo.TILE[1], device=dev)
    out["coo_scatter"] = _probe_times(
        torch, "D scatter", dict(max_abs_err=err),
        lambda: coo.coo_scatter(r, c, val),
        lambda: coo.coo_scatter_reference(r, c, val),
        lambda: tile.index_add_(0, flat, val), float(nnz),
        12.0 * nnz + 4.0 * tile.numel(), PEAK_F32_FLOPS,
        kernels=("coo_scatter_kernel", "sum_rows_kernel"))
    return out


def _probe_sass():
    """Registers and instruction counts of kernels A, B (and B's control)
    and C by variant, codec and staging, from cuobjdump on the built
    libraries (ops/sass.py)."""
    from vireo_tpu_torch.ops import sass
    from vireo_tpu_torch.ops._build import library_path
    # kernels by their mangled names' templates
    names = {"probe_nibbles": {
        "nibble_unpack_kernelILi0E": "A int8",
        "nibble_unpack_kernelILi1E": "A int32",
        "nibble_unpack_kernelILi2E": "A bitcast",
        "NibbleIntELb1E": "B nibble_int",
        "NibbleFloatELb1E": "B nibble_float",
        "RawByteELb1E": "B raw_byte",
        "NibbleIntELb0E": "B control nibble_int",
        "NibbleFloatELb0E": "B control nibble_float",
        "RawByteELb0E": "B control raw_byte"}, "probe_coo": {
        "coo_gather_kernelILi0E": "C through L2",
        "coo_gather_kernelILi1E": "C rows staged",
        "coo_gather_kernelILi2E": "C cols staged",
        "transpose_kernel": "C cols transpose"}}
    for lib, labels in names.items():
        fns, regs = sass.dump(library_path(lib))
        for fn, code in sorted(fns.items()):
            label = next((v for k, v in labels.items() if k in fn), None)
            if label:
                top = sorted(sass.opcode_counts(code).items(),
                             key=lambda kv: -kv[1])[:12]
                log("[probes] %-22s %s registers; SASS: %d instructions; %s"
                    % (label, regs.get(fn, "?"), len(code),
                       ", ".join("%s %d" % kv for kv in top)))


def phase_probes(torch):
    """The probes' kernels A-D against their plain versions at the probes'
    widths, with their times, library times and bounds; their register
    and instruction counts; then the probes' own entry points, each with
    every launch count set to 0 just before it and read just after: each
    must launch the kernels its lines time, as often as its code calls
    them. Returns the kernels' records and their launches in those runs."""
    import importlib
    from vireo_tpu_torch.probes import coo_pallas_probe, int4_micro, nibbles
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    res = _probe_unpack(torch, nibbles, dev)
    res.update(_probe_mm(torch, nibbles, dev))
    res.update(_probe_coo(torch, coo_pallas_probe, dev))
    _probe_sass()
    it = int4_micro.settings()["ITERS"]
    # module, PB_CELLS, the launches of its code: one a check, one a
    # warm-up and `it` timed by ms_per_call, one and three by timed
    runs = (
        ("unpack_probe", None,
         {"nibble_unpack_" + v: 1 for v in nibbles.VARIANTS}),
        ("int4_micro", None, {"packed_mm_nibble_int": it + 2}),
        ("pack_kernel_tune", None,
         {"packed_mm_nibble_int": it + 2, "packed_mm_nibble_float": it + 2,
          "packed_mm_raw_byte": it + 1}),
        ("coo_pallas_probe", PROBE_CELLS[0],
         {"coo_gather_rows": 4, "coo_gather_cols": 4, "coo_scatter": 4}),
        ("coo_pallas_probe", PROBE_CELLS[1],
         {"coo_gather_rows_smem": 4, "coo_gather_cols_smem": 4,
          "coo_scatter": 4}))
    path = dict.fromkeys(_probe_launches(), 0)
    for name, cells, want in runs:
        log("[probes] %spython -m vireo_tpu_torch.probes.%s"
            % ("" if cells is None else "PB_CELLS=%d " % cells, name))
        with _env("PB_CELLS", None if cells is None else str(cells)):
            _reset_launches()
            importlib.import_module("vireo_tpu_torch.probes." + name).main(
                dev)
            made = {k: v for k, v in _probe_launches().items() if v}
        log("[probes] its launches: %s" % json.dumps(made))
        if made != want:
            raise AssertionError("probes.%s launched %s, not %s"
                                 % (name, json.dumps(made), json.dumps(want)))
        for key, count in made.items():
            path[key] += count
        torch.cuda.empty_cache()
    if not all(path.values()):
        raise AssertionError("the probes launched %s" % json.dumps(path))
    log("[probes] the phase took %.1f s" % (time.perf_counter() - t0))
    return res, path


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


def phase_mt(torch):
    """The main call's seeded inits (20 restarts, 60.8M doubles), drawn
    on the host and regenerated on the card: equal bit for bit in
    float32, with numpy's generator at the same position after; both
    timed in turns (host, card, card, host), each ending in a sync."""
    from vireo_tpu_torch.engine import wrap
    from vireo_tpu_torch.models.vireo import VireoConfig
    V, C, K, R = (MAIN["n_var"], MAIN["n_cell"], MAIN["n_donor"],
                  MAIN["n_init"])
    cfg = VireoConfig(n_var=V, n_cell=C, n_donor=K)
    dev = torch.device("cuda")
    n_doubles = R * (C * K + V * K * 3)
    times = {"host": [], "card": []}
    out, peak = {}, 0
    for which in ("host", "card", "card", "host"):
        fn = wrap._host_batched_init if which == "host" \
            else wrap._mt_batched_init
        out.pop(which, None)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        np.random.seed(0)
        t0 = time.perf_counter()
        st = fn(cfg, R, None, np.random, torch.float32, dev)
        torch.cuda.synchronize()
        times[which].append(time.perf_counter() - t0)
        if which == "card":
            peak = max(peak, torch.cuda.max_memory_allocated() - base)
        out[which] = (st, np.random.get_state())
    (h, pos_h), (c, pos_c) = out["host"], out["card"]
    same = {k: bool(torch.equal(getattr(h, k), getattr(c, k)))
            for k in ("id_prob", "gt_prob", "beta_mu", "beta_sum")}
    same_pos = pos_h[2] == pos_c[2] and np.array_equal(pos_h[1], pos_c[1])
    log("[mt] %d restarts, %d doubles: host %s s, card %s s (CUDA "
        "device stream, float64 transform), card peak %.3f GiB above the "
        "resident; equal bit for bit %s, numpy position equal %s"
        % (R, n_doubles, ["%.3f" % t for t in times["host"]],
           ["%.3f" % t for t in times["card"]], peak / 2**30,
           json.dumps(same), same_pos))
    if not all(same.values()) or not same_pos:
        raise AssertionError("the card's inits differ from the host's")
    del out, h, c, st
    torch.cuda.empty_cache()


def phase_synth(torch, d):
    """synth_pool_dense_device at the main pool's size on the card: time,
    peak memory, and its statistics against the numpy pool `d`."""
    from vireo_tpu_torch.sim.synth import synth_pool_dense_device
    V, C, K = MAIN["n_var"], MAIN["n_cell"], MAIN["n_donor"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = synth_pool_dense_device(V, C, K, doublet_rate=0.08, density=0.01,
                                seed=0, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ad, dp = g["counts"].ad, g["counts"].dp
    assert ad.shape == dp.shape == (V, C) and ad.dtype == torch.int8
    nnz = reads = bad = 0
    for r0 in range(0, V, 2000):          # blocks bound the temporaries
        a, r = ad[r0:r0 + 2000], dp[r0:r0 + 2000]
        nnz += int((r > 0).sum())
        reads += float(r.sum(dtype=torch.float64))
        bad += int((a > r).sum())
    got = dict(density=nnz / (V * C), mean_depth=reads / nnz,
               doublet_share=float(np.mean(g["donor2"] >= 0)))
    want = dict(density=d["DP"].nnz / (V * C),
                mean_depth=float(d["DP"].data.mean()),
                doublet_share=float(np.mean(d["donor2"] >= 0)))
    # allele fraction of the singlets' reads at each genotype
    single = torch.as_tensor(g["donor2"] < 0, device="cuda")
    gt = torch.as_tensor(g["GT"][:2000], device="cuda")[
        :, torch.as_tensor(g["donor"], device="cuda")][:, single]
    a, r = ad[:2000][:, single].double(), dp[:2000][:, single].double()
    frac = [float(a[gt == k].sum() / r[gt == k].sum()) for k in range(3)]
    log("[synth] synth_pool_dense_device %d x %d x %d, 8%% doublets: "
        "%.3f s on the card, peak %.3f GiB; %s against the numpy pool %s; "
        "singlet allele fraction by genotype %s (theta 0.01, 0.5, 0.99); "
        "%d entries with AD > DP"
        % (V, C, K, wall, peak / 2**30, json.dumps(got), json.dumps(want),
           ["%.5f" % f for f in frac], bad))
    ok = (abs(got["density"] / want["density"] - 1) <= SYNTH_DENSITY_RTOL
          and abs(got["mean_depth"] / want["mean_depth"] - 1)
          <= SYNTH_DEPTH_RTOL
          and abs(got["doublet_share"] - want["doublet_share"])
          <= SYNTH_DOUBLET_ATOL
          and all(abs(f - t) <= SYNTH_THETA_ATOL
                  for f, t in zip(frac, (0.01, 0.5, 0.99)))
          and bad == 0)
    del g, ad, dp, a, r, gt
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("the device pool's statistics are off")


def _write_mtx(path, M):
    """A sparse integer matrix as a MatrixMarket coordinate file (every
    line "row col value\\n"), formatted by numpy in bulk: each line's
    digits go into a fixed-width row of bytes, with 0 in place of a
    leading zero, and dropping the 0 bytes leaves the lines."""
    M = M.tocoo()
    fields = [M.row.astype(np.uint32) + 1, M.col.astype(np.uint32) + 1,
              np.rint(M.data).astype(np.uint32)]
    widths = [len(str(int(f.max()))) if len(f) else 1 for f in fields]
    lines = np.zeros((M.nnz, sum(widths) + 3), np.uint8)
    col = 0
    for f, w, sep in zip(fields, widths, b"  \n"):
        for k in range(w):
            digit = (f // np.uint32(10 ** k) % np.uint32(10)).astype(
                np.uint8) + np.uint8(48)
            lines[:, col + w - 1 - k] = digit if k == 0 \
                else np.where(f >= 10 ** k, digit, 0)
        lines[:, col + w] = sep
        col += w + 1
    with open(path, "wb") as f:
        f.write(b"%%MatrixMarket matrix coordinate integer general\n")
        f.write(b"%d %d %d\n" % (M.shape[0], M.shape[1], M.nnz))
        f.write(lines[lines != 0].tobytes())


def _write_cellsnp(folder, d):
    """The pool `d` as a cellSNP folder: the two MatrixMarket files, the
    variants' VCF (one line per variant) and the barcodes."""
    import gzip
    os.makedirs(folder)
    for tag in ("AD", "DP"):
        _write_mtx(os.path.join(folder, "cellSNP.tag.%s.mtx" % tag), d[tag])
    with gzip.open(os.path.join(folder, "cellSNP.base.vcf.gz"), "wt",
                   compresslevel=1) as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        f.write("".join("1\t%d\t.\tA\tG\t.\tPASS\t.\n" % (100 + v)
                        for v in range(d["AD"].shape[0])))
    with open(os.path.join(folder, "cellSNP.samples.tsv"), "w") as f:
        f.write("".join("c%06d\n" % c for c in range(d["AD"].shape[1])))


def phase_cli_full(torch, d, cell):
    """`vireo -c DIR -N 16 --randSeed 0 --noPlot` (the default --nInit 50)
    on the main pool written to local disk at `cell` (kept for the mesh
    phases), in this process: the native library loaded, the matrices it
    read equal the pool, the singlet accuracy of donor_ids.tsv after
    label matching, K1's launches, the phases of its --timing summaries,
    the disk-to-answer wall time (the CLI's whole call) and the peak
    device memory."""
    from scipy.optimize import linear_sum_assignment
    from vireo_tpu_torch.cli import vireo_cli
    from vireo_tpu_torch.io import _native, matrices
    V, C, K = MAIN["n_var"], MAIN["n_cell"], MAIN["n_donor"]
    if not _native.available():
        raise AssertionError("the native reader did not build:\n%s"
                             % _native.build_error())
    read = {}
    real_read = matrices.read_cellSNP

    def timed_read(*args, **kwargs):
        t0 = time.perf_counter()
        read["dat"] = real_read(*args, **kwargs)
        read["s"] = time.perf_counter() - t0
        return read["dat"]

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _write_cellsnp(cell, d)
        size = sum(os.path.getsize(os.path.join(cell, f))
                   for f in os.listdir(cell))
        log("[cli_full] cellSNP folder of the main pool written in %.3f s "
            "(%.1f MB)" % (time.perf_counter() - t0, size / 1e6))
        out = os.path.join(tmp, "out")
        text = io.StringIO()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        matrices.read_cellSNP = timed_read
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                vireo_cli.main(["-c", cell, "-N", str(K), "-o", out,
                                "--randSeed", "0", "--nInit",
                                str(CLI_FULL_N_INIT), "--noPlot",
                                "--timing"])
            wall = time.perf_counter() - t0
        finally:
            matrices.read_cellSNP = real_read
        launches = _launches()
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(out, "donor_ids.tsv")) as f:
            rows = [x.split("\t") for x in f.read().splitlines()[1:]]
    phases = {"read": read["s"]}
    for summary in _timing_summaries(text.getvalue(), seconds=True):
        phases.update(summary)
    for name, sec in phases.items():
        log("[cli_full] phase %-15s %.2f s" % (name, sec))
    same = all((read["dat"][k] != d[k]).nnz == 0 for k in ("AD", "DP"))
    best = np.array([int(r[5][len("donor"):]) for r in rows])
    singlet = d["donor2"] < 0
    hits = np.zeros((K, K))
    np.add.at(hits, (d["donor"][singlet], best[singlet]), 1)
    ti, pi = linear_sum_assignment(-hits)
    acc = hits[ti, pi].sum() / singlet.sum()
    calls = dict(zip(*np.unique([r[1] for r in rows], return_counts=True)))
    log("[cli_full] disk-to-answer wall %.3f s (--nInit %d), peak device "
        "memory %.3f GiB, launches %s; the matrices read equal the pool: "
        "%s; %d rows, singlet accuracy %.5f after label matching; calls: "
        "doublet %d, unassigned %d"
        % (wall, CLI_FULL_N_INIT, peak / 2**30, json.dumps(launches), same,
           len(rows), acc, calls.get("doublet", 0),
           calls.get("unassigned", 0)))
    if not same or len(rows) != C or acc < 0.99 or launches["K1"] < 1:
        raise AssertionError("the full-width CLI run is wrong")


def _reset_launches():
    from vireo_tpu_torch.ops import fused_em, packed
    fused_em.LAUNCHES = 0
    for counts in (packed.LAUNCHES,) + _probe_counters():
        for key in counts:
            counts[key] = 0


def _launches():
    from vireo_tpu_torch.ops import fused_em, packed
    return dict(K1=fused_em.LAUNCHES, K2=packed.LAUNCHES["suff_stats"],
                K3=packed.LAUNCHES["cell_loglik"])


def _probe_counters():
    from vireo_tpu_torch.probes import coo_pallas_probe, nibbles
    return (nibbles.LAUNCHES, coo_pallas_probe.LAUNCHES)


def _probe_launches():
    """The probes' kernels A-D by their wrappers' names."""
    out = {}
    for counts in _probe_counters():
        out.update(counts)
    return out


@contextlib.contextmanager
def _fit_lengths(out):
    """Append the iterations of every fit_vb call in the block to `out`:
    one list per call (the warm restarts', one per restart; a refit's,
    one number)."""
    from vireo_tpu_torch.engine import wrap
    from vireo_tpu_torch.models import vireo
    real = vireo.fit_vb

    def spy(*args, **kwargs):
        res = real(*args, **kwargs)
        out.append(np.atleast_1d(res.n_iter).tolist())
        return res
    wrap.fit_vb = vireo.fit_vb = spy
    try:
        yield
    finally:
        wrap.fit_vb = vireo.fit_vb = real


def _log_fit_lengths(prefix, fits):
    log("%s fit iterations: warm restarts %s; then %s"
        % (prefix, fits[0], ", ".join(str(f[0]) for f in fits[1:])))


def _run_main(torch, d, tag):
    """vireo_wrap on the main pool as a user calls it, with every kernel
    launch count set to 0 just before and read just after."""
    from vireo_tpu_torch.engine.wrap import vireo_wrap
    V, C, K = MAIN["n_var"], MAIN["n_cell"], MAIN["n_donor"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    phases, fits = {}, []
    _reset_launches()
    t0 = time.perf_counter()
    with _fit_lengths(fits):
        res = vireo_wrap(d["AD"], d["DP"], n_donor=K,
                         n_init=MAIN["n_init"], random_seed=0,
                         check_doublet=True, verbose=False, timing=phases)
    wall = time.perf_counter() - t0
    launches = _launches()
    launches.update(_probe_launches())
    _log_fit_lengths("[%s]" % tag, fits)
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
    return res, launches, fits


def phase_main_path(torch, d):
    """The dense rung: K1 in the doublet phase."""
    res, launches, fits = _run_main(torch, d, "main")
    if launches["K1"] < 1:
        raise AssertionError("the main path did not launch K1")
    return res, launches, fits


@contextlib.contextmanager
def _env(name, value):
    """The environment variable `name` set to value (unset when None) for
    the block only."""
    saved = os.environ.pop(name, None)
    if value is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if saved is not None:
            os.environ[name] = saved


def _dense_budget(gb):
    """VIREO_DENSE_BUDGET_GB=gb (unset when None) for the block only."""
    return _env("VIREO_DENSE_BUDGET_GB", gb)


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
        res, launches, fits = _run_main(torch, d, "packed")
    if launches["K2"] < 1 or launches["K3"] < 1 or launches["K1"] != 0:
        raise AssertionError("the packed path launched %s; it must launch "
                             "K2 and K3 and not K1" % json.dumps(launches))
    agree = _matched_agreement(res["ID_prob"], dense_res["ID_prob"])
    log("[packed] argmax agreement with the dense run %.5f after label "
        "matching; LB_doublet %.6e vs dense %.6e"
        % (agree, res["LB_doublet"], dense_res["LB_doublet"]))
    if agree < 0.999:
        raise AssertionError("packed and dense calls disagree")
    return launches, dict(ID_prob=res["ID_prob"], LB_list=res["LB_list"],
                          fits=fits)


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
                     verbose=False, device="cpu", check_ambient=True)
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
                         verbose=False, check_ambient=True)
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
        # the ambient phase (var_subset of the rung, then its densify):
        # argmax psi over the CPU's confident cells, labels matched as
        # for the calls
        pc, pg = cpu["ambient_Psi"], gpu["ambient_Psi"]
        sure = np.isfinite(pg).all(1) & np.isfinite(pc).all(1)
        sure[sure] = pc[sure].max(1) >= 0.9
        amb = _matched_agreement(pg[sure], pc[sure])
        log("[rungs] %s ambient: argmax psi agreement %.5f over %d of %d "
            "cells confident on the CPU after label matching (gate %.2f)"
            % (rung, amb, int(sure.sum()), len(sure), SMALL_AMBIENT_AGREE))
        if amb < SMALL_AMBIENT_AGREE:
            raise AssertionError("%s ambient psi disagrees with the CPU's"
                                 % rung)


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


def phase_fused_fit(torch, counts, d, main_res):
    """The fused EM fit on the main pool's int8 dense counts (K1 at V
    30000, C 100000, K = Ks = 16 in every iteration) against the unfused
    float32 fit_vb (K0), from the same seeded single init (FUSED_MIX of
    the main run's answer); K1's launches over the fused fit must equal
    its iterations. Returns them."""
    from vireo_tpu_torch.models import vireo as tv
    from vireo_tpu_torch.models.vireo_fused import prepare_fused, fused_fit_vb
    dev = counts.ad.device
    K = MAIN["n_donor"]
    cfg = tv.VireoConfig(n_var=counts.n_var, n_cell=counts.n_cell,
                         n_donor=K)
    rng = np.random.RandomState(FUSED_SEED)
    id_init = FUSED_MIX * main_res["ID_prob"] + (1 - FUSED_MIX) \
        * rng.dirichlet(np.ones(K), counts.n_cell)
    gt_init = FUSED_MIX * main_res["GT_prob"] + (1 - FUSED_MIX) \
        * rng.dirichlet(np.ones(3), (counts.n_var, K))
    state = tv.init_state(cfg, ID_prob_init=id_init, GT_prob_init=gt_init,
                          dtype=torch.float32, device=dev)
    priors = tv.default_priors(cfg, dtype=torch.float32, device=dev)
    data = prepare_fused(counts)
    singlets = d["donor2"] < 0
    truth = np.eye(K)[d["donor"][singlets]]
    out = {}
    for name in ("fused", "unfused"):
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        if name == "fused":
            st, _, elbo, n_iter = fused_fit_vb(data, state, priors, cfg)
        else:
            res = tv.fit_vb(counts, state, priors, cfg)
            st, elbo, n_iter = res.state, res.elbo_final, res.n_iter
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = _launches()
        idp = st.id_prob.cpu().numpy()
        scored = float(tv.em_step(counts, st, priors, cfg, True)[2])
        out[name] = dict(id=idp, elbo=float(elbo), n_iter=int(n_iter),
                         scored=scored)
        log("[fused] %-7s fit: %d iterations, %.3f s (%.2f ms an "
            "iteration), final ELBO %.6e (%.6e by one unfused iteration "
            "more), launches %s, singlet accuracy %.5f"
            % (name, n_iter, sec, 1e3 * sec / n_iter, float(elbo), scored,
               json.dumps(launches),
               _matched_agreement(truth, idp[singlets])))
        if name == "fused" and launches["K1"] != n_iter:
            raise AssertionError("the fused fit ran %d iterations and "
                                 "launched K1 %d times"
                                 % (n_iter, launches["K1"]))
    f, u = out["fused"], out["unfused"]
    agree = _matched_agreement(f["id"][singlets], u["id"][singlets])
    rel = abs(f["scored"] - u["scored"]) / abs(u["scored"])
    log("[fused] fused against unfused: final ELBOs differ by %.3e of the "
        "unfused one; scored by one unfused iteration, by %.3e (rtol "
        "%.0e); calls of the true singlets agree %.5f after label matching "
        "(all cells %.5f)" % (abs(f["elbo"] - u["elbo"]) / abs(u["elbo"]),
                              rel, FUSED_ELBO_RTOL, agree,
                              _matched_agreement(f["id"], u["id"])))
    if rel > FUSED_ELBO_RTOL or agree < FUSED_AGREE:
        raise AssertionError("the fused fit disagrees with the unfused fit")
    return f["n_iter"]


def _smoothed(GT):
    """Genotypes (V, K) in {0, 1, 2} as (V, K, 3) probabilities: one-hot
    smoothed by GT_EPS."""
    return np.eye(3)[GT] * (1 - 3 * GT_EPS) + GT_EPS


def _donor_priors(d):
    """vireo_wrap's arguments for the known, superset and subset modes on
    the main pool (V, 16 donors)."""
    V, K = d["GT"].shape
    known = _smoothed(d["GT"])
    # the pool's allele frequencies: synth_pool_counts' first draw
    af = np.random.RandomState(0).beta(0.8, 0.8, size=V)
    decoys = np.random.RandomState(1).binomial(2, af[:, None],
                                               (V, SUBSET_DECOYS))
    decoys = _smoothed(decoys)
    return {
        "known": dict(GT_prior=known, n_donor=K, learn_GT=False),
        "superset": dict(GT_prior=known[:, :SUPERSET_KNOWN], n_donor=K,
                         n_init=MAIN["n_init"]),
        "subset": dict(GT_prior=np.concatenate([known, decoys], 1),
                       n_donor=K, learn_GT=False),
    }


@contextlib.contextmanager
def _ambient_record(out):
    """Record the ambient phase in the block: each cell chunk's
    iterations (`out["iters"]`) and the arguments of the chunked EM
    (`out["cols"]`: counts storage, selected rows, theta, psi0)."""
    from vireo_tpu_torch.models import ambient
    real_chunk, real_cols = ambient._em_chunk, ambient._ambient_em_cols
    out["iters"] = []

    def chunk(*args):
        res = real_chunk(*args)
        out["iters"].append(res[3])
        return res

    def cols(*args, **kwargs):
        out["cols"] = args
        return real_cols(*args, **kwargs)
    ambient._em_chunk, ambient._ambient_em_cols = chunk, cols
    try:
        yield
    finally:
        ambient._em_chunk, ambient._ambient_em_cols = real_chunk, real_cols


def _run_mode(torch, counts, d, tag, kw):
    """vireo_wrap on prebuilt counts in one donor-genotype mode, its
    launch counts set to 0 just before and read just after; returns
    (result, launches, singlet accuracy with and without label
    matching, fit iterations, the ambient phase's record)."""
    from vireo_tpu_torch.engine.wrap import vireo_wrap
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    phases, fits, amb = {}, [], {}
    _reset_launches()
    t0 = time.perf_counter()
    with _fit_lengths(fits), _ambient_record(amb):
        res = vireo_wrap(counts, random_seed=0, verbose=False,
                         timing=phases, **kw)
    wall = time.perf_counter() - t0
    launches = _launches()
    _log_fit_lengths("[modes] %s:" % tag, fits)
    C, K = counts.n_cell, MAIN["n_donor"]
    assert res["ID_prob"].shape == (C, K)
    for key in ("ID_prob", "doublet_prob", "doublet_LLR", "GT_prob"):
        assert np.all(np.isfinite(res[key])), key
    matched = _singlet_accuracy(d, res["ID_prob"], res["doublet_prob"])
    own = _singlet_accuracy(d, res["ID_prob"], res["doublet_prob"],
                            match=False)
    log("[modes] %s: %s; wall %.3f s, peak device memory %.3f GiB, "
        "launches %s; singlet accuracy %.5f after label matching, %.5f "
        "without (assigned %.5f, doublet recall %.5f, FPR %.5f)"
        % (tag, ", ".join("%s %.3f s" % kv for kv in phases.items()), wall,
           torch.cuda.max_memory_allocated() / 2**30, json.dumps(launches),
           matched["singlet_accuracy"], own["singlet_accuracy"],
           matched["singlet_assigned_frac"], matched["doublet_recall"],
           matched["doublet_fpr"]))
    if kw.get("check_ambient"):
        _check_ambient(d, res, amb, phases, tag)
    return res, launches, matched["singlet_accuracy"], \
        own["singlet_accuracy"], fits, amb


def _check_ambient(d, res, amb, phases, tag):
    """The ambient phase of a known-donor run: its record, and gate 1
    (argmax psi of the true singlets is their donor)."""
    psi = res["ambient_Psi"]
    assert psi.shape == (len(d["donor"]), MAIN["n_donor"])
    assert res["Psi_var"].shape == psi.shape
    assert res["Psi_LLRatio"].shape == (psi.shape[0],)
    finite = np.isfinite(psi).all(1)
    singlet = (d["donor2"] < 0) & finite
    acc = float(np.mean(np.argmax(psi[singlet], 1) == d["donor"][singlet]))
    n_sel = len(amb["cols"][2])
    log("[ambient] %s: %d of %d SNPs selected; ambient phase %.3f s; %d "
        "cell chunks, the slowest %d iterations (all: %s); cells with "
        "finite psi %d of %d; argmax psi is the true donor for %.5f of "
        "the true singlets (gate %.2f)"
        % (tag, n_sel, MAIN["n_var"], phases["ambient"], len(amb["iters"]),
           max(amb["iters"]), amb["iters"], int(finite.sum()), len(finite),
           acc, AMBIENT_ACC))
    if acc < AMBIENT_ACC:
        raise AssertionError("%s: ambient singlet accuracy %.5f < %.2f"
                             % (tag, acc, AMBIENT_ACC))


def _ambient_cpu_check(torch, res, amb):
    """Gate 3: the card's float32 psi of the first AMBIENT_CPU_CELLS
    cells against the port's CPU EM in float64 from the same psi0 and
    theta (the card's float32 values) and counts."""
    from vireo_tpu_torch.models import ambient
    ad_vc, dp_vc, rows, theta, psi0 = amb["cols"]
    n = AMBIENT_CPU_CELLS
    t0 = time.perf_counter()
    cpu = ambient._ambient_em_cols(
        ad_vc[rows, :n].cpu(), dp_vc[rows, :n].cpu(),
        torch.arange(len(rows)), theta.cpu().double(),
        psi0[:n].cpu().double(), cell_chunk=n)[0].numpy()
    sec = time.perf_counter() - t0
    card = res["ambient_Psi"][:n]
    ok = np.isfinite(card).all(1) & np.isfinite(cpu).all(1)
    agree = float(np.mean(np.argmax(card[ok], 1) == np.argmax(cpu[ok], 1)))
    log("[ambient] card float32 vs CPU float64 on %d cells (%d finite, "
        "CPU %.2f s): argmax psi agreement %.5f (gate %.3f), max |dpsi| "
        "%.3e" % (n, int(ok.sum()), sec, agree, AMBIENT_AGREE,
                  float(np.abs(card[ok] - cpu[ok]).max())))
    if agree < AMBIENT_AGREE:
        raise AssertionError("the card's ambient psi disagrees with the "
                             "CPU's")


def phase_donor_modes(torch, counts, d):
    """The donor-genotype modes at full width through vireo_wrap on the
    dense rung (K0, K1 in the doublet phase): all 16 donors known, with
    the ambient phase (its gates 1 and 3), 12 of 16 known (superset, 20
    restarts), the 16 among 4 decoys (subset). Singlet accuracy
    >= 0.99; with every donor known, without label matching (donor k of
    the prior is donor k of the calls), and in the superset the known
    donors keep their slots. Returns the known run's result."""
    known = None
    for mode, kw in _donor_priors(d).items():
        if mode == "known":
            kw = dict(kw, check_ambient=True)
        res, launches, matched, own, _, amb = _run_mode(torch, counts, d,
                                                        mode, kw)
        if launches["K1"] < 1:
            raise AssertionError("the %s mode did not launch K1" % mode)
        acc = own if mode == "known" else matched
        if acc < 0.99:
            raise AssertionError("%s mode: singlet accuracy %.5f < 0.99"
                                 % (mode, acc))
        if mode == "known":
            _ambient_cpu_check(torch, res, amb)
            known = res
        del amb
        if mode == "superset":
            known_slots = (d["donor2"] < 0) & (d["donor"] < SUPERSET_KNOWN)
            slot = np.mean(np.argmax(res["ID_prob"], 1)[known_slots]
                           == d["donor"][known_slots])
            log("[modes] superset: %.5f of the known donors' singlets in "
                "their own slots" % slot)
            if slot < 0.99:
                raise AssertionError("the superset moved known donors")
    return known


def phase_known_packed(torch, d, dense_known):
    """The known mode with the ambient phase on the packed rung (K2, K3;
    no K1), placed under VIREO_DENSE_BUDGET_GB=PACKED_BUDGET_GB. Each fit
    iteration launches K2 and K3 once; the doublet phase K3 (its
    log-likelihood) and K2 + K3 (the genotype refresh); the ambient
    phase's SNP gate K2 once (PR 5, without the ambient phase: K2 15 =
    14 + 1, K3 16 = 14 + 2). Gate 2: argmax psi agrees with the dense
    run's. Returns the packed counts."""
    from vireo_tpu_torch.ops.counts import counts_from_scipy
    with _dense_budget(PACKED_BUDGET_GB):
        packed = counts_from_scipy(d["AD"], d["DP"],
                                   device=torch.device("cuda"))
    if type(packed).__name__ != "PackedCounts":
        raise AssertionError("VIREO_DENSE_BUDGET_GB=%s placed %s"
                             % (PACKED_BUDGET_GB, type(packed).__name__))
    kw = dict(_donor_priors(d)["known"], check_ambient=True)
    res, launches, _, own, fits, _ = _run_mode(torch, packed, d,
                                               "known (packed)", kw)
    fit_iters = sum(max(f) for f in fits)
    want = dict(K1=0, K2=fit_iters + 2, K3=fit_iters + 2)
    log("[modes] known (packed): launches %s, expected %s (%d fit "
        "iterations; doublet K2 1, K3 2; ambient gate K2 1)"
        % (json.dumps(launches), json.dumps(want), fit_iters))
    if launches != want:
        raise AssertionError("the packed known mode launched %s, not %s"
                             % (json.dumps(launches), json.dumps(want)))
    if own < 0.99:
        raise AssertionError("known mode on the packed rung: singlet "
                             "accuracy %.5f < 0.99" % own)
    a, b = res["ambient_Psi"], dense_known["ambient_Psi"]
    ok = np.isfinite(a).all(1) & np.isfinite(b).all(1)
    agree = float(np.mean(np.argmax(a[ok], 1) == np.argmax(b[ok], 1)))
    log("[ambient] packed vs dense: argmax psi agreement %.5f over %d "
        "cells (gate %.3f), max |dpsi| %.3e"
        % (agree, int(ok.sum()), AMBIENT_AGREE,
           float(np.abs(a[ok] - b[ok]).max())))
    if agree < AMBIENT_AGREE:
        raise AssertionError("the packed and dense ambient calls disagree")
    return packed


def phase_bmm_full(torch, packed, d):
    """BinomMixtureVB(n_donor=16).fit on the main pool's packed counts at
    the JAX defaults (BMM_FIT): the restarts folded into K2's and K3's
    columns (N = 160), then the best refit (N = 16). Each iteration
    launches K2 and K3 once, so their launches must equal the warm
    restarts' longest run plus the refit's iterations."""
    from vireo_tpu_torch.models import bmm
    C, K = packed.n_cell, MAIN["n_donor"]
    calls = []
    real = bmm.fit_bmm

    def spy(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        calls.append((np.atleast_1d(out[3]), time.perf_counter() - t0))
        return out
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    bmm.fit_bmm = spy
    try:
        t0 = time.perf_counter()
        model = bmm.BinomMixtureVB(n_cell=C, n_var=packed.n_var, n_donor=K)
        model.fit(packed, verbose=False, **BMM_FIT)
        wall = time.perf_counter() - t0
    finally:
        bmm.fit_bmm = real
    launches = _launches()
    (warm_it, warm_s), (refit_it, refit_s) = calls
    n_iter = int(warm_it.max()) + int(refit_it[0])
    singlets = d["donor2"] < 0
    acc = _matched_agreement(np.eye(K)[d["donor"][singlets]],
                             model.ID_prob[singlets])
    log("[bmm] BinomMixtureVB(16).fit on the packed counts %s: warm "
        "restarts %s iterations in %.3f s (%.2f ms an iteration), refit %d "
        "in %.3f s (%.2f ms an iteration); wall %.3f s, peak device memory "
        "%.3f GiB, launches %s; final ELBO %.6e, best restart ELBO %.6e; "
        "singlet accuracy after label matching %.5f (reported, no gate)"
        % (json.dumps(BMM_FIT), warm_it.tolist(), warm_s,
           1e3 * warm_s / max(warm_it.max(), 1), int(refit_it[0]), refit_s,
           1e3 * refit_s / max(int(refit_it[0]), 1), wall,
           torch.cuda.max_memory_allocated() / 2**30, json.dumps(launches),
           float(model.ELBO_iters[-1]), float(np.max(model.ELBO_inits)),
           acc))
    if not (launches["K2"] == launches["K3"] == n_iter
            and launches["K1"] == 0):
        raise AssertionError("the BMM fit ran %d iterations and launched %s"
                             % (n_iter, json.dumps(launches)))
    if not np.all(np.isfinite(model.ID_prob)):
        raise AssertionError("the BMM fit's assignments are not finite")


def _small_branch_pool():
    from vireo_tpu_torch.sim.synth import synth_pool_counts
    V, C, K = (SMALL_BRANCHES[k] for k in ("n_var", "n_cell", "n_donor"))
    return synth_pool_counts(V, C, K, doublet_rate=0.08, density=0.1,
                             seed=1)


def phase_small_branches(torch):
    """The extra-donor and superset branches of vireo_wrap on a seeded
    small pool, on the card (float32, K1) and on the CPU (float64, K1's
    plain version): the same calls up to the donors' labels (confident
    singlets, max ID_prob >= 0.9 on the CPU, and doublet calls) and the
    ELBO to BRANCH_ELBO_RTOL."""
    from vireo_tpu_torch.engine.wrap import vireo_wrap
    d = _small_branch_pool()
    K = SMALL_BRANCHES["n_donor"]
    known = _smoothed(d["GT"])
    branches = {
        "extra donors (distance)": dict(n_extra_donor=2),
        "extra donors (size)": dict(n_extra_donor=2,
                                    extra_donor_mode="size"),
        "superset": dict(GT_prior=known[:, :K - 1]),
    }
    for name, kw in branches.items():
        kw = dict(kw, n_donor=K, n_init=5, random_seed=2, verbose=False)
        gpu = vireo_wrap(d["AD"], d["DP"], device="cuda", **kw)
        cpu = vireo_wrap(d["AD"], d["DP"], device="cpu", **kw)
        conf = cpu["ID_prob"].max(1) >= 0.9
        agree = _matched_agreement(gpu["ID_prob"][conf], cpu["ID_prob"][conf])
        dbl = float(np.mean((gpu["doublet_prob"].max(1) >= 0.9)
                            == (cpu["doublet_prob"].max(1) >= 0.9)))
        rel = abs(gpu["LB_doublet"] - cpu["LB_doublet"]) \
            / abs(cpu["LB_doublet"])
        log("[branches] %s: card float32 vs CPU float64: argmax agreement "
            "%.5f over %d confident singlets after label matching, doublet "
            "calls %.5f, LB_doublet %.6e vs %.6e (rel %.2e)"
            % (name, agree, int(conf.sum()), dbl, gpu["LB_doublet"],
               cpu["LB_doublet"], rel))
        if agree < 0.99 or dbl < 0.99 or rel > BRANCH_ELBO_RTOL:
            raise AssertionError("the %s branch differs on the card" % name)


def phase_small_models(torch):
    """The other model families on the small pool, on the card (float32)
    against the CPU (float64): the BMM on the dense and packed rungs
    (final ELBO to BRANCH_ELBO_RTOL), a seeded sweep_n_donor over
    SWEEP_KS (the same best K) and a sweep_n_clone, and VireoBulk and
    LikRatio_test on a bulk sample mixed from the pool's genotypes (psi
    to BULK_PSI_ATOL)."""
    from vireo_tpu_torch.engine.select import sweep_n_donor, sweep_n_clone
    from vireo_tpu_torch.models.bmm import BinomMixtureVB
    from vireo_tpu_torch.models.bulk import VireoBulk, LikRatio_test
    from vireo_tpu_torch.ops.counts import counts_from_scipy
    d = _small_branch_pool()
    AD, DP = d["AD"], d["DP"]
    V, C = AD.shape
    K = SMALL_BRANCHES["n_donor"]
    cuda = torch.device("cuda")

    def bmm_fit(counts, device):
        m = BinomMixtureVB(n_cell=C, n_var=V, n_donor=K, device=device)
        m.fit(counts, n_init=5, max_iter_pre=50, random_seed=3,
              verbose=False)
        return m
    cpu = bmm_fit(counts_from_scipy(AD, DP, device="cpu"), "cpu")
    for rung, budget in (("dense", None), ("packed", V * C)):
        counts = counts_from_scipy(AD, DP, device=cuda, dense_budget=budget)
        gpu = bmm_fit(counts, cuda)
        rel = abs(gpu.ELBO_iters[-1] - cpu.ELBO_iters[-1]) \
            / abs(cpu.ELBO_iters[-1])
        log("[models] BMM on the %s rung (%s): final ELBO %.6e vs CPU "
            "%.6e (rel %.2e), assignment argmax agreement %.5f after label "
            "matching" % (rung, type(counts).__name__, gpu.ELBO_iters[-1],
                          cpu.ELBO_iters[-1], rel,
                          _matched_agreement(gpu.ID_prob, cpu.ID_prob)))
        if rel > BRANCH_ELBO_RTOL:
            raise AssertionError("the BMM on the %s rung differs from the "
                                 "CPU's" % rung)

    sweeps = {}
    for label, device in (("card", cuda), ("cpu", "cpu")):
        t0 = time.perf_counter()
        sweeps[label] = (
            sweep_n_donor(AD, DP, n_donor_list=SWEEP_KS, n_init=5,
                          random_seed=1, device=device, verbose=False),
            sweep_n_clone(AD, DP, n_clone_list=(3, 4), n_init=4,
                          random_seed=1, device=device, verbose=False),
            time.perf_counter() - t0)
    (gd, gc, gs), (cd, cc, cs) = sweeps["card"], sweeps["cpu"]
    log("[models] sweep_n_donor K=%s: best K %d on the card (%.2f s with "
        "sweep_n_clone), %d on the CPU (%.2f s); top ELBOs card %s, CPU %s; "
        "sweep_n_clone best %d vs %d"
        % (list(SWEEP_KS), gd["best"], gs, cd["best"], cs,
           ["%.1f" % gd[k].max() for k in SWEEP_KS],
           ["%.1f" % cd[k].max() for k in SWEEP_KS], gc["best"], cc["best"]))
    if gd["best"] != cd["best"] or gc["best"] != cc["best"]:
        raise AssertionError("the card's sweeps pick another K")

    rng = np.random.RandomState(4)
    gt = _smoothed(d["GT"])
    psi = rng.dirichlet(np.ones(K) * 2)
    depth = rng.poisson(60, V) + 1
    alt = rng.binomial(depth, (gt @ np.array([0.01, 0.5, 0.99])) @ psi)
    fits = {}
    for label, device in (("card", cuda), ("cpu", "cpu")):
        np.random.seed(5)
        m = VireoBulk(K, device=device)
        m.fit(alt, depth, gt)
        lr = LikRatio_test(m.psi, np.ones(K) / K, alt, depth, gt, m.theta,
                           device=device)
        fits[label] = (m.psi, lr)
    (gp, glr), (cp, clr) = fits["card"], fits["cpu"]
    log("[models] VireoBulk: psi %s on the card, max |dpsi| %.3e from the "
        "CPU's (true %s); LR %.4f vs %.4f, p %.3e vs %.3e"
        % (np.round(gp, 4).tolist(), float(np.abs(gp - cp).max()),
           np.round(psi, 4).tolist(), glr[0], clr[0], glr[1], clr[1]))
    if np.abs(gp - cp).max() > BULK_PSI_ATOL:
        raise AssertionError("the card's bulk psi differs from the CPU's")


def phase_checkpoints(torch):
    """Checkpoints on the card, genotype-free and subset runs of a small
    pool: a checkpointed run, a resume after deleting its step 1 (the
    refit and the subset's redraw run again from the saved RNG position)
    and a resume from step 1 (only the doublet phase runs) both give the
    checkpointed run's results bit for bit, which equal an uninterrupted
    run's without checkpoints (no kernel on these paths uses atomics)."""
    from vireo_tpu_torch.engine.wrap import vireo_wrap
    d = _small_branch_pool()
    K = SMALL_BRANCHES["n_donor"]
    known = _smoothed(d["GT"])
    decoy = _smoothed(np.random.RandomState(3).binomial(
        2, 0.5, (known.shape[0], 1)))
    runs = {"genotype-free": dict(n_init=5),
            "subset": dict(GT_prior=np.concatenate([known, decoy], 1),
                           learn_GT=False)}
    keys = ("ID_prob", "GT_prob", "doublet_prob", "doublet_LLR",
            "LB_doublet", "LB_list")
    for name, kw in runs.items():
        kw = dict(kw, n_donor=K, random_seed=4, verbose=False,
                  device="cuda")
        plain = vireo_wrap(d["AD"], d["DP"], **kw)
        with tempfile.TemporaryDirectory() as tmp:
            ck = os.path.join(tmp, "ck")
            full = vireo_wrap(d["AD"], d["DP"], checkpoint_dir=ck, **kw)
            os.remove(os.path.join(ck, "vireo_ckpt_00000001.npz"))
            after_warm = vireo_wrap(d["AD"], d["DP"], checkpoint_dir=ck, **kw)
            after_refit = vireo_wrap(d["AD"], d["DP"], checkpoint_dir=ck,
                                     **kw)
        for label, other in (("uninterrupted", plain),
                             ("resumed after the warm restarts", after_warm),
                             ("resumed after the refit", after_refit)):
            bad = [k for k in keys
                   if not np.array_equal(np.asarray(full[k]),
                                         np.asarray(other[k]))]
            if bad:
                raise AssertionError("checkpoints, %s run: %s differs from "
                                     "the checkpointed run in %s"
                                     % (name, label, bad))
        log("[checkpoint] %s run: the uninterrupted run and both resumes "
            "equal the checkpointed run bit for bit (%s)"
            % (name, ", ".join(keys)))


def _write_donor_vcf(path, GT, names):
    """A donor VCF of genotypes GT (V, K) on the cellSNP folder's
    variants, GT tags."""
    import gzip
    with gzip.open(path, "wt") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\t" + "\t".join(names) + "\n")
        codes = np.array(["0/0", "0/1", "1/1"])[GT]
        for v in range(GT.shape[0]):
            f.write("1\t%d\t.\tA\tG\t.\tPASS\t.\tGT\t%s\n"
                    % (100 + v, "\t".join(codes[v])))


def _check_native_writer(tmp):
    """The native .tsv.gz writer (glibc's %.2e, zlib) against the Python
    writer's bytes on this machine, on probabilities and on values across
    magnitudes and signs."""
    import gzip
    from vireo_tpu_torch.io import fast, matrices
    rng = np.random.RandomState(1)
    mats = [rng.dirichlet(np.ones(4), 5000),
            np.concatenate([rng.rand(40, 5), rng.rand(40, 5) * 1e-30,
                            rng.randn(40, 5) * 1e3, np.zeros((1, 5))])]
    for i, mat in enumerate(mats):
        cols = ["cell"] + ["d%d" % k for k in range(mat.shape[1])]
        names = ["c%05d-1" % r for r in range(mat.shape[0])]
        path = os.path.join(tmp, "native_%d.tsv.gz" % i)
        if not fast.write_matrix_tsv_fast(path, cols, names, mat, "%.2e",
                                          gzip_level=4):
            raise AssertionError("the native writer failed")
        text = io.StringIO()
        matrices._write_tsv(text, cols,
                            matrices._matrix_rows(names, mat, "%.2e"))
        with gzip.open(path, "rb") as f:
            if f.read() != text.getvalue().encode():
                raise AssertionError("the native writer's bytes differ")
    log("[cli] the native .tsv.gz writer gives the Python writer's bytes "
        "(%s rows)" % [m.shape[0] for m in mats])


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
        with gzip.open(os.path.join(out, "GT_donors.vireo.vcf.gz"),
                       "rt") as f:
            lines = f.read().splitlines()
        head = [x for x in lines if x.startswith("#CHROM")][0].split("\t")
        body = [x.split("\t") for x in lines if not x.startswith("#")]
        log("[cli] GT_donors.vireo.vcf.gz: samples %s, %d variants, FORMAT "
            "%s" % (head[9:], len(body), body[0][8]))
        if head[9:] != ["donor%d" % k for k in range(4)] or len(body) != V \
                or body[0][8] != "GT:AD:DP:PL":
            raise AssertionError("GT_donors.vireo.vcf.gz is not the "
                                 "learnt donors' VCF")
        _check_native_writer(tmp)

        # the donors' genotypes given (-d): the calls name the VCF's
        # samples, donor k of the file being donor k of the pool
        names = ["S%d" % k for k in range(4)]
        donors = os.path.join(tmp, "donors.vcf.gz")
        _write_donor_vcf(donors, d["GT"], names)
        out = os.path.join(tmp, "out_donors")
        t0 = time.perf_counter()
        vireo_cli.main(["-c", cell, "-d", donors, "-t", "GT", "-o", out,
                        "--randSeed", "1", "--noPlot"])
        with open(os.path.join(out, "donor_ids.tsv")) as f:
            rows = [x.split("\t") for x in f.read().splitlines()[1:]]
        singlet = d["donor2"] < 0
        best = np.array([r[5] for r in rows])[singlet]
        acc = float(np.mean(best == np.array(names)[d["donor"][singlet]]))
        calls = sorted({r[1] for r in rows})
        log("[cli] -d donors.vcf.gz -t GT: %d rows in %.2f s, calls %s, "
            "singlet accuracy %.5f (best_singlet against the truth, no "
            "label matching)" % (len(rows), time.perf_counter() - t0, calls,
                                 acc))
        if len(rows) != C or not set(calls) <= set(names) | {
                "doublet", "unassigned"} or acc < 0.99:
            raise AssertionError("the donor-file CLI run is wrong")
        if os.path.exists(os.path.join(out, "GT_donors.vireo.vcf.gz")):
            raise AssertionError("known genotypes: no learnt donor VCF")

        # --callAmbientRNAs under VIREO_TIMING=1: prop_ambient.tsv, and
        # the JAX package's per-phase summary (vireo_wrap's, then the
        # writers')
        out = os.path.join(tmp, "out_ambient")
        text = io.StringIO()
        os.environ["VIREO_TIMING"] = "1"
        try:
            with contextlib.redirect_stdout(text):
                vireo_cli.main(["-c", cell, "-N", "4", "-o", out,
                                "--randSeed", "1", "--nInit", "5",
                                "--noPlot", "--callAmbientRNAs"])
        finally:
            os.environ.pop("VIREO_TIMING")
        summaries = _timing_summaries(text.getvalue())
        with open(os.path.join(out, "prop_ambient.tsv")) as f:
            rows = [x.split("\t") for x in f.read().splitlines()]
        log("[cli] --callAmbientRNAs with VIREO_TIMING=1: prop_ambient.tsv "
            "header %s, %d rows; timing summaries %s"
            % (rows[0], len(rows) - 1, summaries))
        for line in text.getvalue().splitlines():
            if "timing:" in line or re.match(r"^  \S+ +\d", line) \
                    or "SNPs selected" in line:
                log("[cli]   %s" % line)
        if rows[0] != ["cell"] + ["donor%d" % k for k in range(4)] + [
                "logLik_ratio"] or len(rows) - 1 != C:
            raise AssertionError("prop_ambient.tsv is not the ambient table")
        if summaries != [["data_placement", "warm_restarts", "model_build",
                          "refit", "doublet", "ambient"],
                         ["result_writers", "donor_vcf"]]:
            raise AssertionError("VIREO_TIMING=1 did not print the phase "
                                 "summaries")

    # GTbarcode on the in-tree golden
    from vireo_tpu_torch.cli import gtbarcode_cli
    golden = os.path.join(REPO, "tests", "goldens")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "GT_barcodes.tsv")
        gtbarcode_cli.main(["-i", os.path.join(golden,
                                                "GT_donors.ref.vcf.gz"),
                            "-o", out, "--randSeed", "1", "--noPlot"])
        with open(out, "rb") as f, open(os.path.join(
                golden, "GT_barcodes.tsv"), "rb") as g:
            same = f.read() == g.read()
    log("[cli] GTbarcode --randSeed 1 --noPlot on GT_donors.ref.vcf.gz: "
        "%s tests/goldens/GT_barcodes.tsv byte for byte"
        % ("equals" if same else "DIFFERS FROM"))
    if not same:
        raise AssertionError("GTbarcode does not reproduce the golden")


def _main_record(res, fits):
    """What the mesh phases compare with from a main-path run."""
    rec = {k: res[k] for k in ("ID_prob", "LB_list", "doublet_prob",
                               "doublet_LLR", "GT_prob")}
    rec["fits"] = fits
    return rec


def phase_mesh_nccl(torch, d, main7):
    """Phase 7's call on a cells mesh of this one process, in an NCCL
    world of one rank: every output and fit equal to phase 7's bit for
    bit, K1 launched; the process group is destroyed after."""
    import torch.distributed as dist
    from vireo_tpu_torch.engine.wrap import vireo_wrap
    from vireo_tpu_torch.parallel.mesh import (initialize_distributed,
                                               make_mesh)
    initialize_distributed(num_processes=1, process_id=0,
                           store=dist.HashStore())
    try:
        mesh = make_mesh()
        log("[mesh_nccl] %r" % mesh)
        if mesh.backend != "nccl":
            raise AssertionError("a world of one rank on a card must use "
                                 "NCCL, got %s" % mesh.backend)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        phases, fits = {}, []
        _reset_launches()
        t0 = time.perf_counter()
        with _fit_lengths(fits):
            res = vireo_wrap(d["AD"], d["DP"], n_donor=MAIN["n_donor"],
                             n_init=MAIN["n_init"], random_seed=0,
                             check_doublet=True, verbose=False,
                             timing=phases, mesh=mesh)
        wall = time.perf_counter() - t0
        launches = _launches()
        peak = torch.cuda.max_memory_allocated()
    finally:
        dist.destroy_process_group()
    for name, sec in phases.items():
        log("[mesh_nccl] phase %-15s %.3f s" % (name, sec))
    _log_fit_lengths("[mesh_nccl]", fits)
    same = {k: bool(np.array_equal(res[k], main7[k]))
            for k in ("ID_prob", "LB_list", "doublet_prob", "doublet_LLR",
                      "GT_prob")}
    same["fit iterations"] = fits == main7["fits"]
    log("[mesh_nccl] vireo_wrap wall %.3f s, peak device memory %.3f GiB, "
        "launches %s; equal to phase 7 bit for bit: %s"
        % (wall, peak / 2**30, json.dumps(launches), json.dumps(same)))
    if not all(same.values()) or launches["K1"] < 1:
        raise AssertionError("the one-rank NCCL mesh run differs from the "
                             "run without a mesh")
    return launches


def _run_group(cmd, env, timeout):
    """Run `cmd` in a process group of its own; on timeout the whole
    group (the launcher and its ranks) is killed."""
    import signal
    proc = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return proc.returncode, out, err


def _singlet_calls(d, best, want):
    """(singlet accuracy against the truth, agreement with the calls
    `want` (n_cell,)), each after label matching, over true singlets."""
    from scipy.optimize import linear_sum_assignment
    K = MAIN["n_donor"]
    singlet = d["donor2"] < 0
    hits = np.zeros((K, K))
    np.add.at(hits, (d["donor"][singlet], best[singlet]), 1)
    ti, pi = linear_sum_assignment(-hits)
    acc = hits[ti, pi].sum() / singlet.sum()
    return acc, _matched_agreement(np.eye(K)[best[singlet]],
                                   np.eye(K)[want[singlet]])


def phase_mesh_cli(d, cell, main7):
    """The CLI on two ranks sharing the card (gloo), launched by
    torch.distributed.run on phase 12's folder with phase 7's call."""
    K, C = MAIN["n_donor"], MAIN["n_cell"]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2", "-m", "vireo_tpu_torch.cli.vireo_cli",
               "-c", cell, "-N", str(K), "--randSeed", "0", "--noPlot",
               "--nInit", str(MAIN["n_init"]), "--mesh", "1x2", "--timing",
               "-o", out]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
        log("[mesh_cli] %s" % " ".join(cmd[1:]))
        t0 = time.perf_counter()
        rc, text, err = _run_group(cmd, env, MESH_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError("the 2-rank CLI exited with %d:\n%s\n%s"
                                 % (rc, text[-3000:], err[-3000:]))
        with open(os.path.join(out, "donor_ids.tsv")) as f:
            rows = [x.split("\t") for x in f.read().splitlines()[1:]]
    for line in text.splitlines():
        if line.startswith(("[vireo] torch.distributed", "[vireo] rank ",
                            "[vireo] counts sharded")):
            log("[mesh_cli] %s" % line)
    for summary in _timing_summaries(text, seconds=True):
        for name, sec in summary.items():
            log("[mesh_cli] rank 0 phase %-15s %.2f s" % (name, sec))
    ranks = re.findall(r"\[vireo\] rank (\d+) of 2: peak device memory "
                       r"(\S+) GiB, kernel launches K1 (\d+) K2 (\d+) K3 "
                       r"(\d+)", text)
    best = np.array([int(r[5][len("donor"):]) for r in rows])
    acc, agree = _singlet_calls(d, best, np.argmax(main7["ID_prob"], 1))
    log("[mesh_cli] wall %.3f s (two ranks, launch to exit); %d rows, "
        "singlet accuracy %.5f, singlets called as in phase 7 %.5f"
        % (wall, len(rows), acc, agree))
    if len(rows) != C or acc < MESH_ACC or agree < MESH_AGREE \
            or len(ranks) != 2 or any(int(r[2]) < 1 for r in ranks):
        raise AssertionError("the 2-rank CLI run is wrong (per rank peak "
                             "GiB and K1, K2, K3 launches: %s)" % (ranks,))


def _k23_block_check(torch, pc, N, seed):
    """K2 and K3 on a rank's PackedCounts block against their plain
    versions, with phase 4's tolerances: exactly on integer weights,
    within Higham's bound on float weights."""
    kern, plain = _k23_calls()
    g = torch.Generator(device=pc.device)
    g.manual_seed(seed)
    V, C = pc.shape
    errs = {}
    for name in ("suff_stats", "cell_loglik"):
        w = _k23_weights(torch, name, V, C, N, g, pc.device, exact=True)
        for gt, rf in zip(kern[name](pc, *w), plain[name](pc, *w)):
            if not torch.equal(gt, rf):
                raise AssertionError("%s on a rank's block differs from its "
                                     "plain version on integer weights"
                                     % name)
        w = _k23_weights(torch, name, V, C, N, g, pc.device, exact=False)
        errs[name] = _float_check(torch, name, kern[name], plain[name], pc,
                                  w)[0]
    return errs


def _rank_mesh_packed(mesh, folder, n_donor, n_init):
    """A rank of `[mesh_packed]` (run by parallel.launch): its half of the
    folder, packed, through phase 8's call; the launches of K2 and K3 in
    that call; then, on rank 0, the block check of K2 and K3."""
    import torch
    from vireo_tpu_torch.engine.wrap import vireo_wrap
    from vireo_tpu_torch.ops.packed import pack_scipy_sharded
    from vireo_tpu_torch.parallel.loader import load_cellSNP_sharded
    from vireo_tpu_torch.utils.device import pin_matmul_precision, sync
    pin_matmul_precision()
    on_card = mesh.device.type == "cuda"
    t0 = time.perf_counter()
    dat, meta = load_cellSNP_sharded(folder)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts = pack_scipy_sharded(dat["AD"], dat["DP"], mesh, cell_range=meta)
    sync(mesh.device)
    pack_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    phases, fits = {}, []
    _reset_launches()
    t0 = time.perf_counter()
    with _fit_lengths(fits):
        res = vireo_wrap(counts, n_donor=n_donor, n_init=n_init,
                         random_seed=0, check_doublet=True, verbose=False,
                         timing=phases, mesh=mesh)
    wall = time.perf_counter() - t0
    launches = _launches()
    rec = dict(meta=meta, read_s=read_s, pack_s=pack_s, phases=phases,
               fits=fits, wall=wall, launches=launches,
               peak=torch.cuda.max_memory_allocated() if on_card
               else float("nan"), backend=mesh.backend,
               block=tuple(counts.local.shape))
    if mesh.is_root:
        rec.update(ID_prob=res["ID_prob"], doublet_prob=res["doublet_prob"],
                   LB_list=res["LB_list"], LB_doublet=float(res["LB_doublet"]))
        rec["k23"] = _k23_block_check(torch, counts.local,
                                      N=n_init * n_donor, seed=7)
    return rec


def phase_mesh_packed(d, cell, packed_launches, packed8):
    """Two spawned ranks share the card: each reads its half of the
    folder, packs it and runs phase 8's call on a 1 x 2 mesh."""
    from vireo_tpu_torch.parallel.launch import run_ranks, MeshArg
    V, C = MAIN["n_var"], MAIN["n_cell"]
    log("[mesh_packed] a rank's budget counts twice on a 1 x 2 mesh (the "
        "cell extent): the ladder would need VIREO_DENSE_BUDGET_GB=2 (4 GiB "
        "for the two ranks: int8 needs %.1f GiB, packed %.1f GiB) to reach "
        "this rung; here each rank packs its half itself"
        % (2.0 * V * C / 2**30, float(V) * C / 2**30))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        recs = run_ranks("chip_smoke:_rank_mesh_packed", 2,
                         kwargs=dict(mesh=MeshArg((1, 2)), folder=cell,
                                     n_donor=MAIN["n_donor"],
                                     n_init=MAIN["n_init"]),
                         workdir=tmp, device="cuda", timeout=MESH_TIMEOUT_S)
        wall = time.perf_counter() - t0
    for rank, rec in enumerate(recs):
        log("[mesh_packed] rank %d (%s): cells %s, block %s, read %.2f s, "
            "packed %.2f s; vireo_wrap wall %.3f s, peak %.3f GiB, launches "
            "%s; phases %s" % (rank, rec["backend"], rec["meta"][:2],
                               rec["block"], rec["read_s"], rec["pack_s"],
                               rec["wall"], rec["peak"] / 2**30,
                               json.dumps(rec["launches"]),
                               json.dumps({k: round(v, 3) for k, v in
                                           rec["phases"].items()})))
    _log_fit_lengths("[mesh_packed]", recs[0]["fits"])
    root = recs[0]
    acc = _singlet_accuracy(d, root["ID_prob"], root["doublet_prob"])
    _, agree = _singlet_calls(d, np.argmax(root["ID_prob"], 1),
                              np.argmax(packed8["ID_prob"], 1))
    log("[mesh_packed] spawn to results %.1f s; %s; singlets called as in "
        "phase 8 %.5f; phase 8's launches %s; K2/K3 on rank 0's block "
        "against their plain versions: integer weights equal, float max "
        "|err| %s" % (wall, json.dumps(acc), agree,
                      json.dumps(packed_launches), json.dumps(root["k23"])))
    # K2 runs once an iteration of the longest warm restart and of the
    # refit, and once in the doublet phase's GT refresh; K3 also computes
    # the doublet phase's loglik. Against phase 8: the warm phase's
    # launches equal phase 8's less its refit's and doublet phase's; the
    # refit may stop up to MESH_REFIT_SLACK iterations away from phase
    # 8's, since each rank's float32 sums round apart from one device's;
    # the best warm ELBO is phase 8's to SCALAR_RTOL.
    fits, fits8 = root["fits"], packed8["fits"]
    refit, refit8 = (sum(f[0] for f in x[1:]) for x in (fits, fits8))
    want = max(fits[0]) + refit + 1
    counted = all(rec["launches"] == {"K1": 0, "K2": want, "K3": want + 1}
                  and rec["fits"] == fits for rec in recs)
    warm8 = packed_launches["K2"] - refit8 - 1
    lb, lb8 = float(np.max(root["LB_list"])), float(np.max(packed8["LB_list"]))
    lb_rel = abs(lb - lb8) / abs(lb8)
    log("[mesh_packed] launches on each rank %s: the longest warm restart "
        "and the refit plus the doublet phase's, %s; warm launches %d, "
        "phase 8's %d (of %s); refit %d iterations, phase 8's %d (slack %d);"
        " best warm ELBO %.6e, phase 8's %.6e (rel %.2e)"
        % (json.dumps(root["launches"]), "as counted" if counted
           else "NOT as counted", max(fits[0]), warm8,
           json.dumps(packed_launches), refit, refit8, MESH_REFIT_SLACK,
           lb, lb8, lb_rel))
    if not counted or max(fits[0]) != warm8 \
            or abs(refit - refit8) > MESH_REFIT_SLACK \
            or lb_rel > SCALAR_RTOL or acc["singlet_accuracy"] < MESH_ACC \
            or agree < MESH_AGREE:
        raise AssertionError("the packed mesh run is wrong")


def phase_mesh_small():
    """The dry run on four ranks sharing the card, on both meshes."""
    from vireo_tpu_torch.parallel.dryrun import dryrun_multichip, DRYRUN_ITERS
    for shape in ((1, 4), (2, 2)):
        t0 = time.perf_counter()
        dryrun_multichip(4, shape, device="cuda", timeout=MESH_TIMEOUT_S)
        log("[mesh_small] %dx%d: every rung passed in %.1f s (%d fixed "
            "iterations)" % (shape + (time.perf_counter() - t0,
                                      DRYRUN_ITERS)))


def _timing_summaries(text, seconds=False):
    """The phase names of each `[vireo] timing:` summary in `text` (with
    `seconds`, a dict of each phase's seconds), its lines checked against
    the JAX package's format."""
    head = re.compile(r"^\[vireo\] timing: total \d+\.\d\ds$")
    row = re.compile(r"^  (\S+) +(\d+\.\d\d)s +\d+\.\d%$")
    lines = text.splitlines()
    found = []
    for i, line in enumerate(lines):
        if line.startswith("[vireo] timing:"):
            if not head.match(line):
                raise AssertionError("timing summary head %r" % line)
            names = {}
            for r in lines[i + 1:]:
                m = row.match(r)
                if not m:
                    break
                names[m.group(1)] = float(m.group(2))
            found.append(names if seconds else list(names))
    return found


def main():
    t_start = time.perf_counter()
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
    probes, probe_launches = phase_probes(torch)
    phase_mt(torch)
    d = _main_pool()
    phase_synth(torch, d)
    dense_res, dense_launches, dense_fits = phase_main_path(torch, d)
    main7 = _main_record(dense_res, dense_fits)
    packed_launches, packed8 = phase_packed_main_path(torch, d, dense_res)
    phase_profile(torch, d)
    from vireo_tpu_torch.ops.counts import counts_from_scipy
    counts = counts_from_scipy(d["AD"], d["DP"], device=torch.device("cuda"))
    fused_launches = phase_fused_fit(torch, counts, d, dense_res)
    del dense_res
    dense_known = phase_donor_modes(torch, counts, d)
    del counts
    packed = phase_known_packed(torch, d, dense_known)
    del dense_known
    phase_bmm_full(torch, packed, d)
    del packed
    with tempfile.TemporaryDirectory() as work:
        cell = os.path.join(work, "cellsnp")
        phase_cli_full(torch, d, cell)
        phase_mesh_nccl(torch, d, main7)
        phase_mesh_cli(d, cell, main7)
        phase_mesh_packed(d, cell, packed_launches, packed8)
    del d, main7, packed8
    phase_mesh_small()
    phase_small_cross_check(torch)
    phase_small_branches(torch)
    phase_small_rungs(torch)
    phase_many_donors(torch)
    phase_small_models(torch)
    phase_checkpoints(torch)
    phase_cli()

    # each kernel at its main-path shape, with the launches of the run of
    # its path: K1 at the doublet phase's (vireo_wrap on the dense rung),
    # and at the fused fit's with that fit's launches; K2 and K3 at the
    # warm restarts' (N = 20 x 16; vireo_wrap on the packed rung)
    table = [
        ("fused_estep_stats", "vireo_tpu_torch/csrc/fused_estep.cu",
         "vireo_tpu/ops/pallas_em.py:145", "vireo_wrap dense",
         dense_launches["K1"], k1["doublet"]),
        ("fused_estep_stats_fit", "vireo_tpu_torch/csrc/fused_estep.cu",
         "vireo_tpu/ops/pallas_em.py:145", "fused fit", fused_launches,
         k1["fit_full"]),
        ("packed_suff_stats", "vireo_tpu_torch/csrc/packed_counts.cu",
         "vireo_tpu/ops/packed.py:161", "vireo_wrap packed",
         packed_launches["K2"], k23[("warm", "suff_stats")]),
        ("packed_cell_loglik", "vireo_tpu_torch/csrc/packed_counts.cu",
         "vireo_tpu/ops/packed.py:195", "vireo_wrap packed",
         packed_launches["K3"], k23[("warm", "cell_loglik")]),
    ]
    # the probes' kernels: their launches in the runs of the probes' entry
    # points; beside them their launches in the two vireo_wrap runs (0:
    # they lie on no path of vireo_wrap)
    replaces = {
        "nibble_unpack": "benchmarks/unpack_probe.py:27",
        "packed_mm_nibble_int": "benchmarks/int4_micro.py:85, "
                                "benchmarks/pack_kernel_tune.py:87",
        "packed_mm_nibble_float": "benchmarks/pack_kernel_tune.py:87",
        "packed_mm_raw_byte": "benchmarks/pack_kernel_tune.py:87",
        "coo_gather_rows": "benchmarks/coo_pallas_probe.py:78",
        "coo_gather_cols": "benchmarks/coo_pallas_probe.py:204",
        "coo_scatter": "benchmarks/coo_pallas_probe.py:123"}
    wrap_launches = {}
    for name, res in probes.items():
        source = ("vireo_tpu_torch/csrc/probe_coo.cu" if "coo" in name
                  else "vireo_tpu_torch/csrc/probe_nibbles.cu")
        key = next(k for k in replaces if name.startswith(k))
        table.append((name, source, replaces[key], "probes",
                      probe_launches[name], res))
        wrap_launches[name] = dense_launches[name] + packed_launches[name]
    if any(wrap_launches.values()):
        raise AssertionError("vireo_wrap launched a probe's kernel: %s"
                             % json.dumps(wrap_launches))
    log("[time] the whole command took %.1f s"
        % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": [dict({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "path": path,
        "max_abs_err": res["max_abs_err"], "ms": res["ms"],
        "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
        "bound_by": res["bound_by"], "library_ms": res["library_ms"]},
        **({"vireo_wrap_launches": wrap_launches[name]}
           if name in wrap_launches else {}))
        for name, source, replaces, path, launches, res in table]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
