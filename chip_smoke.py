#!/usr/bin/env python3
"""Proof that the PyTorch port (vireo_tpu_torch) runs on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the repository

Phases, in order; any failure raises and the script exits non-zero:

1. environment: torch, CUDA and nvcc versions, the card's name and power
   limit; there is no CPU path;
2. build: the CUDA kernels, K0 (csrc/dense_counts.cu), K1
   (csrc/fused_estep.cu), K2/K3 (csrc/packed_counts.cu), the seeded
   inits' stream (csrc/mt19937.cu) and the probes' A/B
   (csrc/probe_nibbles.cu) and C/D (csrc/probe_coo.cu), from the
   sources in the checkout, one nvcc for each, started together;
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
   TFLOP/s, and as the library calls one cuBLAS float32 torch.matmul on
   the counts unpacked ahead of the timing, and one cuBLAS bf16 on them
   by the weights rounded to one bf16 term, where they fit the card;
4a. `[k0]`: K0, the dense rung's two contractions on int8 counts
   (DenseCounts.suff_stats and .cell_loglik, reached through their
   dispatch), against their plain versions at the warm restarts' and
   the refit's shapes on the main pool's (30000 x 100000 counts in
   [0, 127] drawn on the card; N = 320 and 16), cell_loglik also at the
   doublet phase's N = 136, both at the K sweep's N = 96 and 128,
   and at edge shapes (an
   odd C, also as a cell_slice view that starts at an odd column, both
   read by the kernels' producer without TMA; a C that is a multiple of
   16, read by TMA): bit for bit on integer weights, on a second launch,
   and on weights that need all three bf16 terms (on the counts halved,
   K0_SPLIT_NNZ), with the controls of phase 4; the B operand its
   kernel writes equal to k0_operand's bit for bit; within phase 4's
   bound on float weights and its error against float64 sums; its plan
   (ops/counts.py::k0_plan), registers and shared memory; at each shape
   but the edge ones as a single call in turns with the plain version and
   with the kernels' two controls (no MMAs; no CUDA-core adds of the
   k-block sums), 20 back to back and from torch.profiler, beside the
   bound and, as the library call, cuBLAS bf16 on the counts converted
   in the call by the weights' first bf16 term (lower precision); and
   beside the two library yardsticks that K2 and K3 also get: cuBLAS
   float32 and cuBLAS bf16 with one term, on the counts converted ahead
   of the timing; then K0 on int16 counts at heavy16's shapes and tail
   and at the edge shapes, with K0_INT16_SHAPES' checks and times;
4b. `[probes]`: the kernels of the probes of benchmarks/
   (vireo_tpu_torch/probes/) against their plain versions: A
   (nibble_unpack) in its three variants bit for bit at the probe's 256
   x 512 bytes and the main pool's packed AD (30000 x 50000 bytes); B
   (packed_mm) in its three codecs at 30000 x 100000 @ 100000 x 16,
   exactly on integer weights and on sparse weights that use every bit
   of a bf16 significand, and on random bf16 weights within a
   probabilistic sum bound against float64 sums, and equal to itself on
   a second launch; C (coo_gather) in both layouts at 4,194,304 nonzeros
   over 100000 cells (W through L2) and 3500 (W in shared memory),
   against float64 sums within the bound of its summation tree's depth
   (read from the library), and equal to itself on a second launch; D
   (coo_scatter) equal to itself on a second launch and to its order's
   emulation (`coo_scatter_in_order`) bit for bit at 4,194,304 nonzeros,
   at a ragged count and with indices out of the tile (which add
   nothing), and within the bound of its tree's depth (the library's
   plan, held equal to the host's) against float64 sums; each timed
   against its plain version in turns, beside its library call (B: the
   bf16 dense product of the unpacked counts, and the int8 counts
   converted in the call; C: index_select and a product; D: index_add_;
   A: none), its bound and, for C and D, 20 calls replayed from a CUDA
   graph (the device's time without the wrapper's); B's plan (blocks an
   SM from the occupancy API, grid, units, waves, ring stages, bytes in
   flight an SM) and its control (the ring without the MMAs) timed once;
   C's blocks and threads an SM, waves and loads in flight; A's, B's,
   C's and D's registers and instruction counts (cuobjdump, via
   ops/sass.py); then the four probes' entry points at their JAX
   defaults (and coo_pallas_probe again at PB_CELLS=3500, W in shared
   memory), each with the launch counts set to 0 just before it and read
   just after: each launches exactly the kernels and counts its code
   calls for, and these are the probes' launches in the kernels line.
   The probes lie on no path of vireo_wrap: their launches in phases 7
   and 8 must be 0;
5. `[mt]`: the main call's seeded inits (20 restarts, 60.8M doubles of
   numpy's stream) and the CLI's (50 restarts, 152M) drawn on the host
   and made on the card by csrc/mt19937.cu (ops/mt19937.py): equal bit
   for bit, numpy's position equal after, one launch a card init, both
   timed, the card's peak memory, the kernel alone and its time a step;
6. `[synth]`: synth_pool_dense_device at the main pool's size on the
   card: time, peak memory, and density, mean depth, doublet share and
   allele fractions against the numpy pool within the stated tolerances;
7. the full-size main path on the dense rung: a seeded synthetic pool
   of 30000 variants x 100000 cells x 16 donors with 8% doublets
   through `vireo_wrap(n_init=20, random_seed=0)` (its seeded inits
   regenerated on the card, as in phase 5), with K0's and K1's launch
   counts over that run (both of K0's kernels at least once, its
   cell_loglik at the doublet phase's N = 136 among them; K1 none: the
   doublet phase is unfused unless VIREO_FUSED_DOUBLET asks for K1, as
   in the JAX package), phase times, peak memory and accuracy against
   the simulation's truth; then `[doublet]`: that run's fitted model's
   doublet phase again by the default route (K0) and under
   VIREO_FUSED_DOUBLET=1 (K1 once, no K0), each twice in turns and
   timed: the default equal to the run's outputs bit for bit, each
   route equal to itself on its second run, their doublet calls agreeing
   on at least DOUBLET_ROUTE_AGREE of the cells, and each at the doublet
   recall and FPR gates;
8. the same pool and call on the packed rung, chosen by the ladder under
   VIREO_DENSE_BUDGET_GB=4: K2's and K3's launch counts (and no K0 or K1),
   phase times, peak memory, accuracy, and agreement with the dense
   run's calls; then both runs again under torch.profiler: each rung's
   device time by kernel and the device's idle share;
9. the fused EM fit on the main pool's dense int8 counts (K1 in every
   iteration; its launches must equal the fit's iterations) against the
   unfused float32 fit from the same seeded init: iterations, time per
   iteration, ELBOs, accuracy and the agreement of their calls;
10. the donor-genotype modes on the main pool through vireo_wrap on the
   dense rung (K0 in the doublet phase at its width, no K1): every donor
   known (with the
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
   through the device stream; K0 in the doublet phase at N = 136, no
   K1): the native reader
   built and loaded, the matrices it read equal the pool, singlet
   accuracy >= 0.99 from donor_ids.tsv after label matching; each phase,
   the disk-to-answer wall time and the peak memory;
13. small pools on the card against the CPU: the dense rung, the
   extra-donor and superset branches, then the int8-hybrid,
   packed-hybrid and COO rungs of a heavy-tailed pool, with the ambient
   phase (each rung's contractions also run twice and must give the
   same sums bit for bit; the int8-hybrid base must launch both of K0's
   kernels), then a 23-donor pool on the dense rung under
   VIREO_FUSED_DOUBLET=1, whose doublet space (K = 276 columns) goes
   through K1; the BMM on
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
   bit for bit (an all-reduce over one rank is exact); K0's (at least 1
   each, on the rank's block, cell_loglik at N = 136 among them) and
   K1's (none) launches, the phases and the peak memory;
17. `[mesh_cli]`: `python -m torch.distributed.run --standalone
   --nproc-per-node 2 -m vireo_tpu_torch.cli.vireo_cli -c <phase 12's
   folder> -N 16 --randSeed 0 --noPlot --nInit 20 --mesh 1x2 --timing`:
   the two ranks share the card over gloo, on the dense rung, K0 on each
   rank's block and no K1 (each rank's launches and peak memory from
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
   four ranks, on a 1 x 4 and a 2 x 2 mesh: every rung against one rank;
20. `[ksweep]` (after phase 18): benchmarks/k_sweep.py's sweep_n_donor
   at full width (KSWEEP's note), on int8 counts made on the card (K0 at
   the warm widths 96-144, both kernels in every K's fit, the launches
   read before and after each fit) and on the same counts as float32:
   the best K the truth on both, each K's restart ELBOs within
   RUNG_ELBO_RTOL and the same best restart; walls, launches, tiles and
   peak memory; phase 4a holds K0 at two of these widths (N = 96 and
   128, suff_stats' tiles 48 and 64);
21. `[heavy]` (after phase 20): benchmarks/e2e_hybrid.py's heavy-tailed
   pool at full width through vireo_wrap on its default rung (dense
   int16 through K0 on an 80 GB card), int8-hybrid, packed-hybrid and COO
   (HEAVY's note, phase_heavy's gates): launches by rung, sums bit for
   bit on a second run, calls, ELBO and accuracy against the default
   rung's from its warm restarts; placement, phases, residual
   nonzeros, peak memory and accuracy by rung.

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
# the doublet phase of the main path's fitted model by its two routes,
# the default (K0, unfused) and VIREO_FUSED_DOUBLET=1 (K1, bf16 weights
# and assignments): their doublet calls (top pair probability >= 0.9)
# agree on at least DOUBLET_ROUTE_AGREE of the cells, and each route
# reaches the doublet recall and FPR that the main path logged through
# K1 before the default route changed (1.0 and 0.0 on an H100, PERF.md)
DOUBLET_N = MAIN["n_donor"] + MAIN["n_donor"] * (MAIN["n_donor"] - 1) // 2
DOUBLET_ROUTE_AGREE = 0.99
DOUBLET_ROUTE_RECALL = 1.0
DOUBLET_ROUTE_FPR = 0.0

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
# --- K0 (the dense rung's int8 contractions, csrc/dense_counts.cu) ------
# label, V, C, N, contractions: warm and refit at the main pool's shape
# (the EM fit's N = 20 x 16 and 16), the doublet phase's cell_loglik at
# N = K + C(K,2) = 136 on the same pool, and an edge shape with an odd
# C, run on a
# contiguous pool and on a cell_slice view of a pool K0_VIEW_START cells
# wider that starts at that (odd) column and ends at its parent's last
# one (rows neither 16-byte aligned nor contiguous, the last row's last
# cell the parent's last byte), both through the kernels' producer
# without TMA (ops/counts.py::k0_producer); and the edge shape with C a
# multiple of 16, whose rows TMA reads (ragged rows, cells, variants and
# columns on that path). Counts uniform in [0, 127], every value
# an int8 count takes. The tolerances are K2's and K3's: exact on
# integer weights (sum|terms| below 2^24, checked on the data), Higham's
# bound against the plain version on float weights, three terms
# K0_TERMS_GAIN times as close to float64 sums as one; bit for bit on a
# second launch.
K0_BOTH = ("suff_stats", "cell_loglik")
K0_SHAPES = (
    ("edge", 1001, 1999, 21, K0_BOTH),
    ("edge aligned", 1001, 2000, 21, K0_BOTH),
    ("warm", 30000, 100000, 320, K0_BOTH),
    ("refit", 30000, 100000, 16, K0_BOTH),
    ("doublet", 30000, 100000, 136, ("cell_loglik",)),
    # the K sweep's warm widths n_init x K (KSWEEP_FIT, KSWEEP_KS) that
    # reach suff_stats' column tiles 48 (N = 96) and 64 (N = 128), which
    # no shape above takes; cell_loglik takes 48 and 64 there too
    ("sweep96", 30000, 100000, 96, K0_BOTH),
    ("sweep128", 30000, 100000, 128, K0_BOTH),
)
K0_VIEW_START = 7
K0_TERMS_GAIN = 2.0
# The exact three-term check needs weights of 18 significant bits (the
# SPLIT_NNZ note), and a count above 63 times such a weight has more bits
# than float32's 24: so K0's check runs on the pool's counts halved (0 to
# 63), one nonzero a column, each output one product below 2^24.
K0_SPLIT_NNZ = 1
# K0 on int16 counts (two exact 7-bit planes: c = lo + 128 hi), at
# heavy16's shape and tail (portbench/configs/heavy16.json: 1% of the
# entries covered, depth 1 + Poisson(3) capped at 16, 0.2% of the covered
# entries 200 to 1999 reads deeper; K0_HEAVY): the warm restarts' N = 20
# x 16, the refit's N = 16 and the doublet phase's N = 136; and K0_SHAPES'
# edge shapes (and the view from an odd column) on counts over the whole
# range K0 takes as int16, 0 to 16383, a tenth of the first third of the
# rows above 127, so some warpgroup tiles run the high plane and some
# skip it. Checks: bit for bit on integer weights and on a second
# launch; each plane alone (the counts' bits 0-5 and bits 7-12) on
# weights that need all three bf16 terms (K0_SPLIT_NNZ); Higham's bound
# against the plain version with twice the products (both planes); three
# terms K0_TERMS_GAIN times as close to float64 sums as one; K0_HIGH's
# counts equal to those the counts give (`_k0_high_model`). Timed in
# turns with the plain version (the counts converted to float32 a block
# at a time, cuBLAS float32), beside cuBLAS float32 on the counts held as
# float32 (the dense float32 rung's contraction that heavy16 ran before
# int16 reached K0) and the bound where the high plane runs everywhere.
K0_INT16_SHAPES = (
    ("edge", 1001, 1999, 21, K0_BOTH),
    ("edge aligned", 1001, 2000, 21, K0_BOTH),
    ("warm", 30000, 100000, 320, K0_BOTH),
    ("refit", 30000, 100000, 16, K0_BOTH),
    ("doublet", 30000, 100000, 136, ("cell_loglik",)),
)
K0_HEAVY = dict(density=0.01, mean_extra_depth=3.0, max_depth=16,
                hot_share=0.002, hot_depth=(200, 2000))
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
# D also at PROBE_NNZ - PROBE_RAGGED nonzeros (the last warp's range ends
# inside a 16-byte vector), and with PROBE_OUT_OF_RANGE of its indices
# moved out of the tile
PROBE_RAGGED = 13
PROBE_OUT_OF_RANGE = 3000
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
# D: sums in one fixed order (csrc/probe_coo.cu), so it equals its
#   emulation coo_scatter_in_order bit for bit; a term passes through at
#   most `depth` adds of the plan, so gamma_depth sum|v| over the bin
#   against float64 sums, and (gamma_depth + gamma_n) sum|v| against the
#   float32 plain version (n the bin's nonzeros, added in torch's order).
# float32 outside the tensor cores (C's and D's adds), NVIDIA's data
# sheet, H100 SXM
PEAK_F32_FLOPS = 67e12
# the packed main path's budget: int8 (6.0e9 B) does not fit, packed
# (3.0e9 B) does; what a card of about 7 GiB gives (55% of it)
PACKED_BUDGET_GB = "4"
# the small heavy-tailed pool of the other rungs
SMALL_RUNGS = dict(n_var=3000, n_cell=8000, n_donor=4)
# its ELBO against the CPU's: a fit stops once an iteration gains < 0.01,
# at a point that float32 round-off moves; measured on an H100 2.4e-6
# and 1.7e-5 for COO, 3e-7 for the hybrids, and once 3.8e-4 for COO
# while it summed with atomic index_add_, whose order changes from run
# to run (it now sums in a fixed order, which this phase checks)
RUNG_ELBO_RTOL = 1e-4
# and its calls: the share of the reference's confident singlets (max
# ID_prob >= 0.9) called alike after label matching, and of the cells
# whose doublet call (top pair >= 0.9) is alike
RUNG_AGREE = 0.99
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
# [ksweep]: benchmarks/k_sweep.py's configuration, seeded. The pool of
# synth_pool_dense_device (int8 DenseCounts, so K0) without doublets,
# then sweep_n_donor over KSWEEP_KS with KSWEEP_FIT. Its warm widths
# N = n_init x K (96, 112, 128, 144) take K0's suff_stats column tiles
# 48, 64, 64, 80 and cell_loglik's 48, 64, 64, 48 (ops/counts.py::
# k0_plan). The same sweep on the counts as float32 DenseCounts (the
# plain torch.matmul versions) must pick the same K, reach each K's
# per-restart ELBOs within RUNG_ELBO_RTOL and the same best restart.
KSWEEP = dict(n_var=30000, n_cell=100000, n_donor=16, doublet_rate=0.0,
              density=0.01, seed=0)
KSWEEP_KS = (12, 14, 16, 18)
KSWEEP_FIT = dict(n_init=8, max_iter_init=20, random_seed=0)
# [heavy]: benchmarks/e2e_hybrid.py's heavy-tailed pool (`_heavy_pool`,
# its generator's lines; the largest count ~2000) through vireo_wrap
# with HEAVY_FIT on the rung counts_from_scipy picks by default (dense
# int16 on an 80 GB card) and on the rungs of HEAVY_RUNGS, forced by a
# dense_budget in units of n_var x n_cell bytes (0: one byte). Each
# forced rung's calls against the default rung's: the [rungs] gates
# (RUNG_AGREE, RUNG_ELBO_RTOL); singlet accuracy by the script's
# measure within HEAVY_ACC_ATOL of the default rung's.
HEAVY = dict(n_var=30000, n_cell=100000, n_donor=16, hot_frac=0.002,
             density=0.01, seed=0)
HEAVY_FIT = dict(n_init=20, random_seed=0, check_doublet=True)
HEAVY_RUNGS = (("int8-hybrid", 2), ("packed-hybrid", 1), ("coo", 0))
HEAVY_ACC_ATOL = 0.01


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
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.applications."
         "graphics", "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    log("[env] SM clock: max, application %s" % (clocks or "not read"))
    log("[env] device 0: %s, device count %d"
        % (torch.cuda.get_device_name(0), torch.cuda.device_count()))


def phase_build():
    """The six kernel libraries, their nvcc runs started together."""
    from concurrent.futures import ThreadPoolExecutor
    from vireo_tpu_torch.ops import counts, fused_em, mt19937, packed
    from vireo_tpu_torch.probes import coo_pallas_probe, nibbles
    t0 = time.perf_counter()
    libs = (counts, fused_em, packed, mt19937, nibbles, coo_pallas_probe)
    with ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(m._library) for m in libs]:
            f.result()
    log("[build] K0, K1, K2/K3, the MT stream and the probes' A/B and C/D "
        "built and loaded in %.2f s" % (time.perf_counter() - t0))


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


def _kernel_ms(torch, fn, names, reps=3, seen=None):
    """Mean device ms per call of fn of each kernel whose name holds one
    of `names`, from torch.profiler; None where it reports no device
    time. `seen`, a dict, takes the launches of each that the profiler
    recorded over the `reps` calls."""
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
                if seen is not None:
                    seen[n] = seen.get(n, 0) + evt.count
    return ms


def phase_k1(torch):
    from vireo_tpu_torch.ops import fused_em
    from vireo_tpu_torch.ops.counts import suff_stats_reference
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
        own = suff_stats_reference(args[0], args[1], idb)
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


def _split_weights(torch, C, N, g, device, nnz=SPLIT_NNZ):
    """K2's weights for the exact check of its three terms (SPLIT_NNZ; K0
    K0_SPLIT_NNZ): `nnz` nonzeros a column."""
    shape = (nnz, N)
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


def _split_weights_of(torch, name, V, C, N, g, device, nnz=SPLIT_NNZ):
    """The exact three-term check's weights: (W,) for K2, (Wa, Wd) for K3
    with `nnz` nonzeros a column across the two together."""
    if name == "suff_stats":
        return (_split_weights(torch, C, N, g, device, nnz),)
    W = _split_weights(torch, 2 * V, N, g, device, nnz)
    return W[:V].contiguous(), W[V:].contiguous()


def _cut_terms(torch, w, terms):
    """Each weight matrix of `w` cut to its first `terms` bf16 terms."""
    return tuple(_fewer_terms(torch, x)[terms] for x in w)


def _split_check(torch, name, kern, plain, pc, N, g, dev, nnz=SPLIT_NNZ,
                 tag="k23"):
    """The kernel exactly equal to its plain version on weights that need
    all three terms; the plain version on the same weights cut to one or
    two terms must differ, or the check could not see a lost term."""
    w = _split_weights_of(torch, name, pc.n_var, pc.n_cell, N, g, dev, nnz)
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
    log("[%s]   three-term integer weights: equal to the plain version; "
        "controls: with %d and %d of %d outputs the one- and two-term sums "
        "differ" % (tag, differ[1], differ[2], sum(x.numel() for x in ref)))


def _term_errors(torch, name, kern, plain, pc, w, got, label=None,
                 gain=None, tag="k23"):
    """Max |error| of the outputs against float64 sums, for the plain
    version (float32 on the CUDA cores), the kernel (three terms) and the
    kernel on the weights cut to one and two terms; K2 or K3 (by `name`)
    unless `label` and `gain` say which kernel and gate."""
    if label is None:
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
    log("[%s]   %s float max_abs_err against float64 sums (max|out| "
        "%.3e): %s" % (tag, label, max(float(x.abs().max()) for x in exact),
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


def _float_check(torch, name, kern, plain, pc, w, tag="k23"):
    """The kernel on float weights within Higham's bound of its plain
    version (the tolerance above K2_TERMS_GAIN); its max |error|."""
    V, C = pc.n_var, pc.n_cell
    got = kern(pc, *w)
    ref = plain(pc, *w)
    mag = plain(pc, *(x.abs() for x in w))
    sides = (3 * C, C) if name == "suff_stats" else (6 * V, 2 * V)
    gamma = sum(n * F32_UNIT / (1 - n * F32_UNIT) for n in sides)
    return max(_bound_check("%s[%d] float" % (name, i), gt, rf, gamma * m,
                            tag)
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
    ref = plain(pc, *w)
    _library_f32(torch, "k23", name, X, w, ref, V, res)
    _library_bf16(torch, "k23", name, X, w, ref, V, res)
    del ref
    res["library_ms"] = res["library_f32_ms"]
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


def _k0_inputs(torch, V, C, seed, device, start=0):
    """DenseCounts of int8 counts uniform in [0, 127], drawn in row blocks
    on the card; with `start`, cells [start, start + C) of a pool of
    start + C cells (`cell_slice`, a strided view)."""
    from vireo_tpu_torch.ops.counts import DenseCounts
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    mats = []
    for _ in range(2):
        x = torch.empty((V, start + C), dtype=torch.int8, device=device)
        for r0 in range(0, V, 4096):
            r1 = min(r0 + 4096, V)
            x[r0:r1] = torch.randint(0, 128, (r1 - r0, start + C),
                                     generator=g, dtype=torch.int8,
                                     device=device)
        mats.append(x)
    dc = DenseCounts(*mats)
    return dc.cell_slice(start, start + C) if start else dc


def _k0_inputs16(torch, V, C, seed, device, start=0, heavy=True):
    """DenseCounts of int16 counts drawn in row blocks on the card: with
    `heavy`, K0_HEAVY's pool (depth at 1% of the entries, the hot share
    deeper; AD a binomial draw of DP at 0.02, 0.5 or 0.98); else counts
    uniform in [0, 127], a tenth of the first third of the rows uniform
    in [128, 16383] instead, AD uniform in [0, DP]. `start` as for
    `_k0_inputs`."""
    from vireo_tpu_torch.ops.counts import DenseCounts
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    W = start + C
    ad = torch.empty((V, W), dtype=torch.int16, device=device)
    dp = torch.empty_like(ad)
    h = K0_HEAVY
    for r0 in range(0, V, 2048):
        r1 = min(r0 + 2048, V)
        shape = (r1 - r0, W)

        def rand():
            return torch.rand(shape, generator=g, device=device)
        if heavy:
            cov = rand() < h["density"]
            d = (1 + torch.poisson(torch.full(shape, h["mean_extra_depth"],
                                              device=device), generator=g)
                 ).clamp(max=h["max_depth"])
            lo, hi = h["hot_depth"]
            d = d + (rand() < h["hot_share"]) * torch.randint(
                lo, hi, shape, generator=g, device=device)
            d = d * cov
            p = torch.tensor([0.02, 0.5, 0.98], device=device)[
                torch.randint(0, 3, shape, generator=g, device=device)]
            a = torch.binomial(d, p, generator=g)
        else:
            d = torch.randint(0, 128, shape, generator=g,
                              device=device).float()
            rows = torch.arange(r0, r1, device=device)[:, None] < V // 3
            hot = rows & (rand() < 0.1)
            d = torch.where(hot, torch.randint(128, 16384, shape, generator=g,
                                               device=device).float(), d)
            a = (rand() * (d + 1)).floor().clamp(max=d)
        dp[r0:r1] = d.to(torch.int16)
        ad[r0:r1] = a.to(torch.int16)
    dc = DenseCounts(ad, dp)
    return dc.cell_slice(start, start + C) if start else dc


def _k0_high_model(torch, name, dc, N, sms):
    """K0_HIGH's additions for one int16 call of K0's `name` on
    DenseCounts dc at width N, from the counts: (k_blocks, high). Each
    unit of the plan (ops/counts.py::k0_plan) runs each of its k-blocks
    on two warpgroup tiles, suff_stats' of 64 variants x 64 cells,
    cell_loglik's of 128 cells x 64 variants, past the counts' edge too;
    a tile runs the high plane where AD or DP holds a count above 127."""
    from vireo_tpu_torch.ops import counts
    V, C = dc.n_var, dc.n_cell
    plan = counts.k0_plan(name, V, C, N, sms, 2)
    if name == "suff_stats":
        rows, cols = 2 * plan.m_tiles * 64, plan.nkb * 64
        tile = (64, 64)
    else:
        rows, cols = plan.nkb * 64, 2 * plan.m_tiles * 128
        tile = (64, 128)
    high = 0
    for r0 in range(0, V, 64 * 64):
        r1 = min(r0 + 64 * 64, V)
        hot = (dc.ad[r0:r1] > 127) | (dc.dp[r0:r1] > 127)
        pad = torch.zeros((-(-(r1 - r0) // 64) * 64, cols), dtype=torch.bool,
                          device=hot.device)
        pad[:r1 - r0, :C] = hot
        high += int(pad.view(-1, tile[0], cols // tile[1], tile[1])
                    .any(3).any(1).sum())
    tiles = rows // tile[0] * (cols // tile[1])
    return tiles * plan.n_tiles, high * plan.n_tiles


def _k0_calls():
    """(kernel, plain) calls of K0 on a DenseCounts, by name; each
    returns a tuple of outputs. The kernel is reached as the model
    reaches it, through DenseCounts' dispatch on int8 counts."""
    from vireo_tpu_torch.ops import counts
    kern = {"suff_stats": lambda dc, *w: dc.suff_stats(*w),
            "cell_loglik": lambda dc, *w: (dc.cell_loglik(*w),)}
    plain = {"suff_stats": lambda dc, *w: counts.suff_stats_reference(
                 dc.ad, dc.dp, *w),
             "cell_loglik": lambda dc, *w: (counts.cell_loglik_reference(
                 dc.ad, dc.dp, *w),)}
    return kern, plain


def _k0_library(torch, name, X8, w):
    """One PyTorch call computing K0's function: cuBLAS bf16 on the counts
    [AD; DP] converted to bf16 in the call, by the weights rounded to one
    bf16 term (lower precision than K0's three)."""
    if name == "suff_stats":
        wb = w[0].to(torch.bfloat16)
        return lambda: torch.matmul(X8.to(torch.bfloat16), wb)
    wb = torch.cat(w).to(torch.bfloat16)
    return lambda: torch.matmul(X8.to(torch.bfloat16).t(), wb)


def _library_f32(torch, tag, name, X, w, plain, V, res):
    """The library call in float32, K2's and K3's yardstick, beside a
    kernel of the same function: one cuBLAS float32 torch.matmul on the
    counts [AD; DP] converted to float32 ahead of the timing (X, or None
    where they do not fit the card); its median ms into
    res["library_f32_ms"], logged with its max |diff| from the plain
    version's outputs `plain`."""
    res["library_f32_ms"] = None
    if X is None:
        return
    call = _library_call(torch, name, X, w)
    err = max(float((a - b).abs().max()) for a, b in zip(
        torch.split(call(), V) if name == "suff_stats" else (call(),),
        plain))
    res["library_f32_ms"] = float(np.median(_time_ms(torch, call, reps=6)))
    log("[%s]   library call, float32: cuBLAS float32, one torch.matmul on "
        "the counts converted to float32 ahead of the timing, %.3f ms, max "
        "|diff| from the plain version %.3e" % (tag, res["library_f32_ms"],
                                                err))


def _library_bf16(torch, tag, name, X, w, plain, V, res):
    """The library call in bf16 with one term, K0's yardstick, beside a
    kernel of the same function: cuBLAS bf16 on the counts [AD; DP]
    converted to bf16 ahead of the timing (X, float32, or None), by the
    weights rounded to one bf16 term; into res["library_bf16_ms"]."""
    res["library_bf16_ms"] = None
    if X is None:
        return
    Xb = X.to(torch.bfloat16)
    wb = (w[0] if name == "suff_stats" else torch.cat(w)).to(torch.bfloat16)
    call = ((lambda: torch.matmul(Xb, wb)) if name == "suff_stats"
            else (lambda: torch.matmul(Xb.t(), wb)))
    err = max(float((a.float() - b).abs().max()) for a, b in zip(
        torch.split(call(), V) if name == "suff_stats" else (call(),),
        plain))
    res["library_bf16_ms"] = float(np.median(_time_ms(torch, call,
                                                      reps=6)))
    log("[%s]   library call, bf16 one term: cuBLAS bf16 on the counts "
        "converted to bf16 ahead of the timing, by W rounded to one bf16 "
        "term (lower precision than the kernel's three), %.3f ms, max "
        "|diff| from the plain version %.3e"
        % (tag, res["library_bf16_ms"], err))
    del Xb


def _k0_producer(torch, dc):
    """The producer K0's kernels take for DenseCounts dc: "tma" or
    "loads"."""
    from vireo_tpu_torch.ops import counts
    pitch = dc.ad.stride(0) if dc.n_var > 1 else dc.n_cell
    return counts.k0_producer(dc.ad, dc.dp, pitch)


def _k0_kernels(plan):
    """The CUDA kernels of one K0 call, by the names torch.profiler
    reports (k0_sum_slices where the plan splits the contracted axis)."""
    own = "k0_suff_kernel" if plan.name == "suff_stats" else \
        "k0_loglik_kernel"
    return (own,) + (("k0_sum_slices",) if plan.slices > 1 else ())


def _k0_layout(torch, name, dc, N, w, res):
    """K0's plan, its kernel's registers, shared memory and ring at the
    plan's tile, and the two controls timed in turns with the kernel
    (CUDA events, median of 4 each): without the MMAs (the ring and the
    fragments alone) and without the float32 adds of the k-block sums;
    into res, logged."""
    from vireo_tpu_torch.ops import counts
    width = dc.ad.element_size()
    plan = counts.k0_plan(name, dc.n_var, dc.n_cell, N, _sms(torch), width)
    shape = counts.k0_shape(name, plan.bn, width)
    res["plan"], res["shape"] = plan, shape
    log("[k0]   plan: tile %d x %d, %d x %d tiles, %d slices of %d "
        "k-blocks (%d), %d units on %d blocks (%.1f%% of the last wave); "
        "producer %s" % (counts.K0_TILES[name][0], plan.bn, plan.m_tiles,
                         plan.n_tiles, plan.slices, plan.slice_kb, plan.nkb,
                         plan.units, plan.grid,
                         100.0 * (plan.units % plan.grid or plan.grid)
                         / plan.grid, _k0_producer(torch, dc)))
    log("[k0]   kernel: %s" % json.dumps(shape))
    if shape["spill_bytes"] != 0:
        log("[k0]   WARNING: the kernel spills %d bytes a thread"
            % shape["spill_bytes"])
    kern = (lambda: dc.suff_stats(*w)) if name == "suff_stats" else \
        (lambda: dc.cell_loglik(*w))
    ctrl = {m: (lambda m=m: counts.k0_control(name, dc, *w, mode=m))
            for m in ("no_mma", "no_fold")}
    kern()
    for f in ctrl.values():
        f()
    torch.cuda.synchronize()
    times = {"kernel": [], "no_mma": [], "no_fold": []}
    for order in (("kernel", "no_mma", "no_fold"),
                  ("no_fold", "no_mma", "kernel")):
        for key in order:
            times[key] += _time_ms(torch, kern if key == "kernel"
                                   else ctrl[key], reps=2)
    ms = {k: float(np.median(v)) for k, v in times.items()}
    res["controls_ms"] = ms
    log("[k0]   controls, median ms (CUDA events, %d runs each, in turns): "
        "kernel %.3f  no MMAs %.3f  no adds of the k-block sums %.3f"
        % (len(times["kernel"]), ms["kernel"], ms["no_mma"], ms["no_fold"]))


def phase_k0(torch):
    """K0 against its plain versions at K0_SHAPES, with the checks and
    times of K0_SHAPES' note."""
    from vireo_tpu_torch.ops import counts
    from vireo_tpu_torch.ops.counts import DenseCounts
    dev = torch.device("cuda")
    kern, plain = _k0_calls()
    results = {}
    dc = None
    X32 = None
    for label, V, C, N, names in K0_SHAPES:
        if dc is None or (dc.n_var, dc.n_cell) != (V, C):
            dc = X32 = None
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            pools = [(label, _k0_inputs(torch, V, C, V + C, dev))]
            if label == "edge":
                pools.append(("edge view", _k0_inputs(
                    torch, V, C, V + C + 1, dev, start=K0_VIEW_START)))
            torch.cuda.synchronize()
            log("[k0] %d x %d int8 counts drawn on the card in %.2f s%s"
                % (V, C, time.perf_counter() - t0,
                   "" if label != "edge" else "; the view: cells [%d, %d) "
                   "of %d, row pitch %d bytes" % (
                       K0_VIEW_START, K0_VIEW_START + C, K0_VIEW_START + C,
                       pools[1][1].ad.stride(0))))
            dc = pools[0][1]
        else:
            pools = [(label, dc)]
        if not label.startswith("edge") and X32 is None:
            # the float32 library call's operand, where it fits the card
            X32 = _dense_f32(torch, dc)
        g = torch.Generator(device=dev)
        g.manual_seed(V + C + N)
        for tag, pc in pools:
            half = DenseCounts(pc.ad >> 1, pc.dp >> 1)
            for name in names:
                log("[k0] %s %s V=%d C=%d N=%d" % (tag, name, V, C, N))
                w = _k23_weights(torch, name, V, C, N, g, dev, exact=True)
                top = max(float(x.max()) for x in plain[name](
                    pc, *(x.abs() for x in w)))
                if top >= 2.0 ** 24:
                    raise AssertionError("K0 %s integer weights: sum|terms| "
                                         "%.0f is not exact in float32"
                                         % (name, top))
                for gt, rf in zip(kern[name](pc, *w), plain[name](pc, *w)):
                    if not torch.equal(gt, rf):
                        raise AssertionError(
                            "K0 %s on integer weights differs from its "
                            "plain version by %.3e"
                            % (name, float((gt - rf).abs().max())))
                log("[k0]   integer weights: equal to the plain version "
                    "(largest sum|terms| %.0f, exact below 2^24)" % top)
                _split_check(torch, name, kern[name], plain[name], half, N,
                             g, dev, nnz=K0_SPLIT_NNZ, tag="k0")
                w = _k23_weights(torch, name, V, C, N, g, dev, exact=False)
                err, got = _float_check(torch, name, kern[name],
                                        plain[name], pc, w, tag="k0")
                if not all(torch.equal(a, b)
                           for a, b in zip(got, kern[name](pc, *w))):
                    raise AssertionError("K0 %s gave other sums on a second "
                                         "launch" % name)
                log("[k0]   a second launch: equal bit for bit")
                b = counts.k0_device_operand(name, *w)
                if not torch.equal(b, counts.k0_operand(name, *w)):
                    raise AssertionError("K0 %s's operand kernel wrote "
                                         "another B than k0_operand" % name)
                log("[k0]   B operand %s: the operand kernel's equal to "
                    "k0_operand's bit for bit" % (tuple(b.shape),))
                del b
                res = dict(max_abs_err=err)
                res["err_vs_f64"] = _term_errors(
                    torch, name, kern[name], plain[name], pc, w, got,
                    label="K0 " + name, gain=K0_TERMS_GAIN, tag="k0")
                del got
                if tag.startswith("edge"):
                    plan = counts.k0_plan(name, V, C, N, _sms(torch))
                    log("[k0]   plan: tile %d, %d slices, %d blocks; "
                        "producer %s" % (plan.bn, plan.slices, plan.grid,
                                         _k0_producer(torch, pc)))
                else:
                    _k0_layout(torch, name, pc, N, w, res)
                    X8 = torch.cat([pc.ad, pc.dp])
                    lib = _k0_library(torch, name, X8, w)
                    lib_err = max(float((a.float() - b).abs().max())
                                  for a, b in zip(
                        torch.split(lib(), V) if name == "suff_stats"
                        else (lib(),), plain[name](pc, *w)))
                    log("[k0]   library call: cuBLAS bf16 on the counts "
                        "converted to bf16 in the call, by W rounded to "
                        "one bf16 term (lower precision than K0's three); "
                        "max |diff| from the plain version %.3e" % lib_err)
                    ref = plain[name](pc, *w)
                    _library_f32(torch, "k0", name, X32, w, ref, V, res)
                    _library_bf16(torch, "k0", name, X32, w, ref, V, res)
                    del ref
                    # 2 x 2 V C N flops a term, three bf16 terms; the int8
                    # counts, the float32 weights and outputs once (4 C N
                    # + 8 V N bytes for either contraction)
                    _probe_times(
                        torch, "K0 %s N=%d" % (name, N), res,
                        lambda: kern[name](pc, *w),
                        lambda: plain[name](pc, *w), lib,
                        3 * 2.0 * 2 * V * C * N,
                        2.0 * V * C + 4.0 * C * N + 8.0 * V * N,
                        kernels=_k0_kernels(res["plan"]), phase="k0")
                    del X8, lib
                results[(tag, name)] = res
                del w
                torch.cuda.empty_cache()
            del half
    del dc, pools, X32
    torch.cuda.empty_cache()
    return results


def _planes_split_check(torch, name, kern, plain, pc, N, g, dev):
    """`_split_check` on each plane of int16 counts alone: the counts'
    bits 0-5 (low plane) and bits 7-12 (high plane, 128 h with h < 64),
    so each output, one product of a count and an 18-bit weight, is exact
    in float32."""
    from vireo_tpu_torch.ops.counts import DenseCounts
    for bits in (0x003F, 0x1F80):
        part = DenseCounts(pc.ad & bits, pc.dp & bits)
        log("[k0]   the counts' bits %#06x alone:" % bits)
        _split_check(torch, name, kern, plain, part, N, g, dev,
                     nnz=K0_SPLIT_NNZ, tag="k0")
        del part


def phase_k0_int16(torch):
    """K0 on int16 counts against its plain versions at K0_INT16_SHAPES,
    with the checks and times of K0_INT16_SHAPES' note; by (label, name)
    the results, with K0_HIGH's share of k-blocks that ran the high
    plane."""
    from vireo_tpu_torch.ops import counts
    from vireo_tpu_torch.ops.counts import DenseCounts
    dev = torch.device("cuda")
    kern, plain = _k0_calls()
    results = {}
    dc = f32 = None
    for label, V, C, N, names in K0_INT16_SHAPES:
        heavy = not label.startswith("edge")
        if dc is None or (dc.n_var, dc.n_cell) != (V, C):
            dc = f32 = None
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            pools = [(label, _k0_inputs16(torch, V, C, V + C, dev,
                                          heavy=heavy))]
            if label == "edge":
                pools.append(("edge view", _k0_inputs16(
                    torch, V, C, V + C + 1, dev, start=K0_VIEW_START,
                    heavy=False)))
            torch.cuda.synchronize()
            dc = pools[0][1]
            log("[k0] %d x %d int16 counts drawn on the card in %.2f s "
                "(%s): largest %d, %d above 127"
                % (V, C, time.perf_counter() - t0,
                   "heavy16's tail" if heavy else "0 to 16383",
                   int(dc.dp.max()), int((dc.dp > 127).sum())))
            if heavy:
                # the dense float32 rung's layout of the same counts
                torch.cuda.empty_cache()
                free, _ = torch.cuda.mem_get_info()
                if 8.0 * V * C <= LIBRARY_MEM_SHARE * free:
                    f32 = DenseCounts(dc.ad.float(), dc.dp.float())
                else:
                    log("[k0]   float32 layout not timed: it takes %.1f GB"
                        % (8.0 * V * C / 1e9))
        else:
            pools = [(label, dc)]
        g = torch.Generator(device=dev)
        g.manual_seed(V + C + N)
        for tag, pc in pools:
            for name in names:
                log("[k0] int16 %s %s V=%d C=%d N=%d" % (tag, name, V, C, N))
                w = _k23_weights(torch, name, V, C, N, g, dev, exact=True)
                top = max(float(x.max()) for x in plain[name](
                    pc, *(x.abs() for x in w)))
                if top >= 2.0 ** 24:
                    raise AssertionError("K0 int16 %s integer weights: "
                                         "sum|terms| %.0f is not exact in "
                                         "float32" % (name, top))
                counts.K0_HIGH.reset()
                got = kern[name](pc, *w)
                k_blocks, high = (counts.K0_HIGH[k]
                                  for k in ("k_blocks", "high"))
                want = _k0_high_model(torch, name, pc, N, _sms(torch))
                log("[k0]   K0_HIGH: %d of %d k-blocks ran the high plane "
                    "(%.2f%%); from the counts %d of %d"
                    % (high, k_blocks, 100.0 * high / max(k_blocks, 1),
                       want[1], want[0]))
                if (k_blocks, high) != want:
                    raise AssertionError("K0_HIGH counted other k-blocks "
                                         "than the counts give")
                for gt, rf in zip(got, plain[name](pc, *w)):
                    if not torch.equal(gt, rf):
                        raise AssertionError(
                            "K0 int16 %s on integer weights differs from "
                            "its plain version by %.3e"
                            % (name, float((gt - rf).abs().max())))
                log("[k0]   integer weights: equal to the plain version "
                    "(largest sum|terms| %.0f, exact below 2^24)" % top)
                del got
                _planes_split_check(torch, name, kern[name], plain[name], pc,
                                    N, g, dev)
                w = _k23_weights(torch, name, V, C, N, g, dev, exact=False)
                got = kern[name](pc, *w)
                ref = plain[name](pc, *w)
                mag = plain[name](pc, *(x.abs() for x in w))
                sides = ((6 * C, C) if name == "suff_stats"
                         else (12 * V, 2 * V))
                gamma = sum(_gamma(n) for n in sides)
                err = max(_bound_check("%s[%d] float" % (name, i), gt, rf,
                                       gamma * m, "k0")
                          for i, (gt, rf, m) in enumerate(zip(got, ref, mag)))
                del ref, mag
                if not all(torch.equal(a, b)
                           for a, b in zip(got, kern[name](pc, *w))):
                    raise AssertionError("K0 int16 %s gave other sums on a "
                                         "second launch" % name)
                log("[k0]   a second launch: equal bit for bit")
                res = dict(max_abs_err=err, high_share=high / max(k_blocks, 1))
                res["err_vs_f64"] = _term_errors(
                    torch, name, kern[name], plain[name], pc, w, got,
                    label="K0 int16 " + name, gain=K0_TERMS_GAIN, tag="k0")
                del got
                if heavy:
                    _k0_layout(torch, name, pc, N, w, res)
                    lib = None
                    if f32 is not None:
                        ref = plain[name](pc, *w)
                        lib = lambda: kern[name](f32, *w)
                        diff = max(float((a - b).abs().max())
                                   for a, b in zip(lib(), ref))
                        log("[k0]   library call: cuBLAS float32 on the "
                            "counts held as float32 (the dense float32 "
                            "rung's contraction), max |diff| from the plain "
                            "version %.3e" % diff)
                        del ref
                    # three bf16 terms of both planes, 2 x 2 V C N flops
                    # each, where the high plane runs everywhere; the int16
                    # counts, the float32 weights and outputs once
                    _probe_times(
                        torch, "K0 int16 %s N=%d" % (name, N), res,
                        lambda: kern[name](pc, *w),
                        lambda: plain[name](pc, *w), lib,
                        2 * 3 * 2.0 * 2 * V * C * N,
                        4.0 * V * C + 4.0 * C * N + 8.0 * V * N,
                        kernels=_k0_kernels(res["plan"]), phase="k0")
                    log("[k0]   the bound at K0_HIGH's share (%.2f%% of the "
                        "k-blocks with the high plane): %.4f ms"
                        % (100 * res["high_share"], _bound(
                            (1 + res["high_share"]) * 3 * 2.0 * 2 * V * C
                            * N, 4.0 * V * C + 4.0 * C * N + 8.0 * V * N)[0]))
                results[(tag, name)] = res
                del w
                torch.cuda.empty_cache()
    del dc, pools, f32
    torch.cuda.empty_cache()
    return results


def _dense_f32(torch, dc):
    """[AD; DP] of DenseCounts dc as one (2 n_var, n_cell) float32
    matrix, the operand of the float32 library call, or None (with the
    reason logged) where it does not fit the card."""
    V, C = dc.n_var, dc.n_cell
    need = 8.0 * V * C
    free, _ = torch.cuda.mem_get_info()
    if need > LIBRARY_MEM_SHARE * free:
        log("[k0]   float32 library call not timed: the counts in float32 "
            "take %.1f GB, more than %.0f%% of the card's %.1f GB free"
            % (need / 1e9, 100 * LIBRARY_MEM_SHARE, free / 1e9))
        return None
    X = torch.empty((2 * V, C), dtype=torch.float32, device=dc.ad.device)
    for m, x in enumerate((dc.ad, dc.dp)):
        for r0 in range(0, V, 2048):
            r1 = min(r0 + 2048, V)
            X[m * V + r0:m * V + r1] = x[r0:r1].float()
    return X


def _sms(torch):
    return torch.cuda.get_device_properties(0).multi_processor_count


def _gamma(n):
    """Higham's gamma_n of float32 (n a number or a tensor)."""
    return n * F32_UNIT / (1 - n * F32_UNIT)


def _graph_ms(torch, kern):
    """ms a call of kern with the host's work taken out: PROBE_STREAM
    calls captured once in a CUDA graph (after a warm-up on the side
    stream that captures them), the graph replayed between CUDA events;
    the median of three replays over PROBE_STREAM."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            kern()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(PROBE_STREAM):
            kern()
    graph.replay()
    torch.cuda.synchronize()
    ms = float(np.median(_time_ms(torch, graph.replay))) / PROBE_STREAM
    del graph
    return ms


def _probe_times(torch, tag, res, kern, plain, library, flops, nbytes,
                 peak=PEAK_BF16_FLOPS, kernels=(), graph=False,
                 phase="probes"):
    """Kernel and plain version in turns, the library call (None where
    there is none) and the bound, into res; the kernel's calls back to
    back, with `graph` also inside a CUDA graph (`_graph_ms`), and the
    device time of its CUDA kernels (names holding one of `kernels`) from
    torch.profiler; logged."""
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
    res["graph_ms"] = _graph_ms(torch, kern) if graph else None
    seen = {}
    by_name = _kernel_ms(torch, kern, kernels, seen=seen)
    res["device_by_kernel"] = by_name
    res["device_ms"] = (None if None in by_name.values()
                        else sum(by_name.values()))
    log("[%s]   %s median ms: kernel %.4f  plain %.4f  library %s "
        "(CUDA events, %d runs each); bound %.4f ms (%s): the kernel at "
        "%.1f%% of it; %d calls back to back %.4f ms a call%s; device "
        "time of its kernels (torch.profiler) %s"
        % (phase, tag, res["ms"], res["plain_ms"],
           "none" if library is None else "%.4f" % res["library_ms"], nrun,
           res["bound_ms"], res["bound_by"],
           100.0 * res["bound_ms"] / res["ms"], PROBE_STREAM,
           res["stream_ms"],
           "" if res["graph_ms"] is None else
           ", in a CUDA graph %.4f ms a call (%.1f%% of the bound)"
           % (res["graph_ms"], 100.0 * res["bound_ms"] / res["graph_ms"]),
           ", ".join("%s %s (%d launches recorded in 3 calls)"
                     % (k, "not measured" if v is None else "%.4f ms" % v,
                        seen.get(k, 0))
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
                   else ()), graph=True)
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
    out["coo_scatter"] = _probe_scatter(torch, coo, dev, g, val)
    return out


def _probe_scatter(torch, coo, dev, g, val):
    """Kernel D in its own order (csrc/probe_coo.cu): the library's plan
    equal to the host's (`scatter_plan`); at PROBE_NNZ and at PROBE_NNZ -
    PROBE_RAGGED nonzeros equal bit for bit to `coo_scatter_in_order` on
    the card, within gamma_depth sum|terms| of float64 sums, and within
    (gamma_depth + gamma_n) sum|terms| of the float32 plain version (n a
    bin's nonzeros); equal to itself on a second launch; with
    PROBE_OUT_OF_RANGE indices out of the tile, equal to its emulation
    and to the sums of the others; timed beside index_add_."""
    nnz, sms = PROBE_NNZ, _sms(torch)
    r = torch.randint(0, coo.TILE[0], (nnz,), generator=g,
                      dtype=torch.int32, device=dev)
    c = torch.randint(0, coo.TILE[1], (nnz,), generator=g,
                      dtype=torch.int32, device=dev)

    def gate(tag, r, c, v, keep=None):
        n = r.numel()
        plan = coo.scatter_plan(n, sms)
        if coo.scatter_shape(n) != plan:
            raise AssertionError("coo_scatter: the library's plan %s is not "
                                 "the host's %s" % (coo.scatter_shape(n),
                                                    plan))
        got = coo.coo_scatter(r, c, v)
        emu = coo.coo_scatter_in_order(r, c, v, plan)
        if not torch.equal(got.view(torch.int32), emu.view(torch.int32)):
            raise AssertionError(
                "coo_scatter %s: %d bins differ from coo_scatter_in_order "
                "(max %.3e)" % (tag, int((got != emu).sum()),
                                float((got - emu).abs().max())))
        if keep is not None:
            r, c, v = r[keep], c[keep], v[keep]
        ref64 = coo.coo_scatter_reference(r, c, v, dtype=torch.float64)
        mag = coo.coo_scatter_reference(r, c, v.abs(), dtype=torch.float64)
        count = coo.coo_scatter_reference(r, c, torch.ones_like(v),
                                          dtype=torch.float64)
        _bound_check("D %s f64" % tag, got.double(), ref64,
                     _gamma(plan["depth"]) * mag, tag="probes")
        err = _bound_check("D %s f32" % tag, got,
                           coo.coo_scatter_reference(r, c, v),
                           ((_gamma(plan["depth"]) + _gamma(count))
                            * mag).float(), tag="probes")
        log("[probes] D %s: %d nonzeros, equal to coo_scatter_in_order bit "
            "for bit; plan (library = host) %s" % (tag, n, json.dumps(plan)))
        return got, plan, err

    got, plan, err = gate("scatter", r, c, val)
    if not torch.equal(got.view(torch.int32),
                       coo.coo_scatter(r, c, val).view(torch.int32)):
        raise AssertionError("coo_scatter gave other sums on a second launch")
    log("[probes] D scatter equal to itself on a second launch, bit for bit")
    n = nnz - PROBE_RAGGED
    gate("ragged", r[:n], c[:n], val[:n])
    # some rows past 8, some columns past 128, some rows below 0
    bad = torch.randperm(nnz, generator=g, device=dev)[:PROBE_OUT_OF_RANGE]
    ro, co = r.clone(), c.clone()
    third = PROBE_OUT_OF_RANGE // 3
    ro[bad[:third]] += coo.TILE[0]
    co[bad[third:2 * third]] += coo.TILE[1]
    ro[bad[2 * third:]] = -1 - ro[bad[2 * third:]]
    keep = torch.ones(nnz, dtype=torch.bool, device=dev)
    keep[bad] = False
    gate("out-of-range", ro, co, val, keep)
    flat = r.long() * coo.TILE[1] + c.long()
    tile = torch.zeros(coo.TILE[0] * coo.TILE[1], device=dev)
    return _probe_times(
        torch, "D scatter", dict(plan, max_abs_err=err),
        lambda: coo.coo_scatter(r, c, val),
        lambda: coo.coo_scatter_reference(r, c, val),
        lambda: tile.index_add_(0, flat, val), float(nnz),
        12.0 * nnz + 4.0 * tile.numel(), PEAK_F32_FLOPS,
        kernels=("coo_scatter_kernel",), graph=True)


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
        "transpose_kernel": "C cols transpose",
        "coo_scatter_kernel": "D scatter"}}
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
    """The seeded inits of the main call (20 restarts, 60.8M doubles of
    numpy's stream, heavy16's) and of the CLI's 50 restarts (152M,
    pool16's), drawn on the host and made on the card by csrc/mt19937.cu:
    equal bit for bit in float32, with numpy's generator at the same
    position after, and one launch a card init; both timed in turns
    (host, card, card, host), each ending in a sync; the card's peak
    above the resident; the kernel alone against numpy's `rand` of the
    same stream (`_timed_pair`), and its time a step. Returns the main
    call's kernel row for the kernel table."""
    from vireo_tpu_torch.engine import wrap
    from vireo_tpu_torch.models.vireo import VireoConfig
    from vireo_tpu_torch.ops import mt19937
    V, C, K = MAIN["n_var"], MAIN["n_cell"], MAIN["n_donor"]
    cfg = VireoConfig(n_var=V, n_cell=C, n_donor=K)
    dev = torch.device("cuda")
    rows = {}
    for R in (MAIN["n_init"], 50):
        n_doubles = R * (C * K + V * K * 3)
        times = {"host": [], "card": []}
        out, peak, launches = {}, 0, 0
        for which in ("host", "card", "card", "host"):
            fn = wrap._host_batched_init if which == "host" \
                else wrap._mt_batched_init
            out.pop(which, None)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            before = mt19937.LAUNCHES
            np.random.seed(0)
            t0 = time.perf_counter()
            st = fn(cfg, R, None, np.random, torch.float32, dev)
            torch.cuda.synchronize()
            times[which].append(time.perf_counter() - t0)
            if which == "card":
                peak = max(peak, torch.cuda.max_memory_allocated() - base)
            launches += mt19937.LAUNCHES - before
            out[which] = (st, np.random.get_state())
        (h, pos_h), (c, pos_c) = out["host"], out["card"]
        same = {k: bool(torch.equal(getattr(h, k), getattr(c, k)))
                for k in ("id_prob", "gt_prob", "beta_mu", "beta_sum")}
        same_pos = pos_h[2] == pos_c[2] and np.array_equal(pos_h[1],
                                                           pos_c[1])
        del out, h, c, st
        torch.cuda.empty_cache()
        np.random.seed(0)
        plan = mt19937.take_state(n_doubles, np.random, dev)
        calls, steps0 = mt19937.LAUNCHES, mt19937.STEPS
        ms, plain_ms, _ = _timed_pair(
            torch, lambda: mt19937.kernel_stream(plan),
            lambda: np.random.rand(n_doubles))
        steps = (mt19937.STEPS - steps0) // (mt19937.LAUNCHES - calls)
        bound_ms, bound_by = _bound(0.0, 8.0 * n_doubles)
        rows[R] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=0.0,
                       bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=None)
        log("[mt] %d restarts, %d doubles: host %s s, card %s s (inits "
            "made by csrc/mt19937.cu, float64 transform), card peak %.3f "
            "GiB above the resident; kernel %.3f ms against numpy's rand "
            "%.3f ms, %d steps, %.1f ns a step, bound by its stores %.3f "
            "ms (8 bytes a double at 3.35 TB/s); launches %d for 2 card "
            "inits; equal bit for bit %s, numpy position equal %s"
            % (R, n_doubles, ["%.3f" % t for t in times["host"]],
               ["%.3f" % t for t in times["card"]], peak / 2**30, ms,
               plain_ms, steps, ms * 1e6 / steps, bound_ms, launches,
               json.dumps(same), same_pos))
        if not all(same.values()) or not same_pos:
            raise AssertionError("the card's inits differ from the host's")
        if launches != 2:
            raise AssertionError("2 card inits launched the kernel %d times"
                                 % launches)
        torch.cuda.empty_cache()
    return rows[MAIN["n_init"]]


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
    label matching, the launches (K0's cell_loglik at the doublet's
    width, no K1), the phases of its --timing summaries,
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
        widths = {}
        matrices.read_cellSNP = timed_read
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text), _k0_widths(widths):
                vireo_cli.main(["-c", cell, "-N", str(K), "-o", out,
                                "--randSeed", "0", "--nInit",
                                str(CLI_FULL_N_INIT), "--noPlot",
                                "--timing"])
            wall = time.perf_counter() - t0
        finally:
            matrices.read_cellSNP = real_read
        launches = _launches()
        launches["K0_widths"] = widths
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
    if not same or len(rows) != C or acc < 0.99 or \
            not _doublet_on_k0(launches, DOUBLET_N):
        raise AssertionError("the full-width CLI run is wrong")


def _reset_launches():
    from vireo_tpu_torch.ops import counts, fused_em, mt19937, packed
    fused_em.LAUNCHES = 0
    mt19937.LAUNCHES = 0
    for launches in (counts.LAUNCHES, packed.LAUNCHES) + _probe_counters():
        for key in launches:
            launches[key] = 0


def _launches():
    """K1's, K2's, K3's, the MT stream's and K0's two kernels' launches
    (K0 by its wrappers' names, dense_suff_stats and dense_cell_loglik)."""
    from vireo_tpu_torch.ops import counts, fused_em, mt19937, packed
    return dict(K1=fused_em.LAUNCHES, K2=packed.LAUNCHES["suff_stats"],
                K3=packed.LAUNCHES["cell_loglik"], MT=mt19937.LAUNCHES,
                **counts.LAUNCHES)


def _k0_launched(launches):
    """Whether both of K0's kernels were launched."""
    return min(launches["dense_suff_stats"],
               launches["dense_cell_loglik"]) > 0


@contextlib.contextmanager
def _k0_widths(out):
    """Count, into `out` by "<wrapper> N=<width>", the launches of K0's
    two kernels made in the block, by the width of their weights: a
    launch counts where its wrapper's own count rose over the call (the
    wrappers alone count launches; this only sorts them by width)."""
    from vireo_tpu_torch.ops import counts
    reals = {name: getattr(counts, name)
             for name in ("dense_suff_stats", "dense_cell_loglik")}

    def spy(name):
        def call(ad, dp, *weights, **kwargs):
            before = counts.LAUNCHES[name]
            res = reals[name](ad, dp, *weights, **kwargs)
            if counts.LAUNCHES[name] > before:
                key = "%s N=%d" % (name, weights[0].shape[1])
                out[key] = out.get(key, 0) + counts.LAUNCHES[name] - before
            return res
        return call

    for name in reals:
        setattr(counts, name, spy(name))
    try:
        yield
    finally:
        for name, real in reals.items():
            setattr(counts, name, real)


def _doublet_width(res):
    """K + C(K,2), the doublet phase's columns, of a vireo_wrap result."""
    return res["ID_prob"].shape[1] + res["doublet_prob"].shape[1]


def _doublet_on_k0(launches, width):
    """Whether a run's doublet phase took the default route: K1 not
    launched, K0's cell_loglik launched at the doublet's width."""
    return launches["K1"] == 0 and \
        launches["K0_widths"].get("dense_cell_loglik N=%d" % width, 0) >= 1


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


@contextlib.contextmanager
def _keep_doublet_input(out):
    """Keep, into `out`, what vireo_wrap's doublet phase is called with
    in the block: a copy of the fitted model as it stands before the
    phase (which refreshes the model in place), its counts and its
    arguments."""
    import copy
    from vireo_tpu_torch.engine import wrap
    real = wrap.predict_doublet

    def spy(vobj, AD, DP=None, **kwargs):
        out.update(model=copy.copy(vobj), counts=AD, DP=DP, kwargs=kwargs)
        return real(vobj, AD, DP, **kwargs)

    wrap.predict_doublet = spy
    try:
        yield
    finally:
        wrap.predict_doublet = real


def _run_main(torch, d, tag, keep=None):
    """vireo_wrap on the main pool as a user calls it, with every kernel
    launch count set to 0 just before and read just after (K0's also by
    width); with `keep`, a dict, the doublet phase's input kept there."""
    from vireo_tpu_torch.engine.wrap import vireo_wrap
    V, C, K = MAIN["n_var"], MAIN["n_cell"], MAIN["n_donor"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    phases, fits, widths = {}, [], {}
    _reset_launches()
    t0 = time.perf_counter()
    with _fit_lengths(fits), _k0_widths(widths), \
            (_keep_doublet_input(keep) if keep is not None
             else contextlib.nullcontext()):
        res = vireo_wrap(d["AD"], d["DP"], n_donor=K,
                         n_init=MAIN["n_init"], random_seed=0,
                         check_doublet=True, verbose=False, timing=phases)
    wall = time.perf_counter() - t0
    launches = _launches()
    launches.update(_probe_launches())
    launches["K0_widths"] = widths
    _log_fit_lengths("[%s]" % tag, fits)
    peak = torch.cuda.max_memory_allocated()
    for name, sec in phases.items():
        log("[%s] phase %-15s %.3f s" % (tag, name, sec))
    log("[%s] vireo_wrap wall %.3f s, peak device memory %.3f GiB, "
        "launches %s" % (tag, wall, peak / 2**30, json.dumps(launches)))
    if launches["MT"] != 1:
        raise AssertionError("its one seeded init launched the MT stream "
                             "kernel %d times" % launches["MT"])

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
    """The dense rung: K0 in every iteration and in the doublet phase
    (cell_loglik at N = K + C(K,2), then the GT refresh's E-step at
    N = K); K1 not launched. Returns also the doublet phase's input."""
    keep = {}
    res, launches, fits = _run_main(torch, d, "main", keep=keep)
    if not _k0_launched(launches) or \
            not _doublet_on_k0(launches, _doublet_width(res)):
        raise AssertionError("the main path did not launch both of K0's "
                             "kernels, K0's cell_loglik at the doublet's "
                             "width and no K1: %s" % json.dumps(launches))
    return res, launches, fits, keep


def _doublet_route(torch, keep, knob):
    """predict_doublet on a copy of the kept model and counts, with
    VIREO_FUSED_DOUBLET=knob (unset when None), its launch counts set to
    0 just before and read just after; (outputs, launches, seconds)."""
    import copy
    from vireo_tpu_torch.models.doublet import predict_doublet
    model = copy.copy(keep["model"])
    widths = {}
    with _env("VIREO_FUSED_DOUBLET", knob), _k0_widths(widths):
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        out = predict_doublet(model, keep["counts"], keep["DP"],
                              **keep["kwargs"])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = _launches()
    launches["K0_widths"] = widths
    return dict(doublet_prob=out[0], ID_prob=out[1], doublet_LLR=out[2],
                GT_prob=model.GT_prob), launches, sec


def phase_doublet_routes(torch, d, main_res, keep):
    """The doublet phase of phase 7's fitted model by both routes, on the
    same model and counts: the default (K0, unfused, as in phase 7) and
    VIREO_FUSED_DOUBLET=1 (K1), each run twice in turns (default, knob,
    knob, default) and timed with the card synchronised; each route's
    launches; the doublet calls of the two routes agree on at least
    DOUBLET_ROUTE_AGREE of the cells, and each reaches the doublet recall
    and FPR gates. The default route's outputs equal phase 7's bit for
    bit. Returns K1's launches in the knob's route."""
    runs = {None: [], "1": []}
    for knob in (None, "1", "1", None):
        runs[knob].append(_doublet_route(torch, keep, knob))
    keep.clear()
    torch.cuda.empty_cache()
    width = _doublet_width(main_res)
    calls = {}
    for knob, tag in ((None, "default (K0)"), ("1", "VIREO_FUSED_DOUBLET=1 "
                                                    "(K1)")):
        out, launches, _ = runs[knob][0]
        acc = _singlet_accuracy(d, out["ID_prob"], out["doublet_prob"])
        calls[knob] = out["doublet_prob"].max(1) >= 0.9
        log("[doublet] %s: %s s (two runs), launches %s; %s"
            % (tag, ", ".join("%.4f" % r[2] for r in runs[knob]),
               json.dumps({k: v for k, v in launches.items()
                           if v and not isinstance(v, dict)}
                          | {"K0_widths": launches["K0_widths"]}),
               json.dumps(acc)))
        if acc["doublet_recall"] < DOUBLET_ROUTE_RECALL or \
                acc["doublet_fpr"] > DOUBLET_ROUTE_FPR:
            raise AssertionError("the %s doublet route misses the recall "
                                 "or FPR gate" % tag)
        for later in runs[knob][1:]:
            if not all(np.array_equal(out[k], later[0][k]) for k in out):
                raise AssertionError("the %s doublet route gave other "
                                     "outputs on a second run" % tag)
    default, knob = runs[None][0][0], runs["1"][0][0]
    same = {k: bool(np.array_equal(default[k], main_res[k]))
            for k in ("ID_prob", "doublet_prob", "doublet_LLR", "GT_prob")}
    agree = float(np.mean(calls[None] == calls["1"]))
    gap = {k: float(np.abs(default[k] - knob[k]).max())
           for k in ("ID_prob", "doublet_prob", "doublet_LLR", "GT_prob")}
    log("[doublet] the routes' doublet calls agree on %.6f of %d cells "
        "(gate %.2f), %d and %d called; max |default - knob| %s; the "
        "default route equal to phase 7 bit for bit: %s"
        % (agree, len(calls[None]), DOUBLET_ROUTE_AGREE,
           int(calls[None].sum()), int(calls["1"].sum()), json.dumps(gap),
           json.dumps(same)))
    if agree < DOUBLET_ROUTE_AGREE or not all(same.values()):
        raise AssertionError("the doublet routes disagree")
    if not _doublet_on_k0(runs[None][0][1], width) or \
            runs["1"][0][1]["K1"] != 1 or \
            runs["1"][0][1]["dense_cell_loglik"] != 0:
        raise AssertionError("a doublet route launched other kernels than "
                             "its own")
    return runs["1"][0][1]["K1"]


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
    only): K2 and K3 in every iteration and the doublet phase, no K1 and
    no K0."""
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
    if launches["K2"] < 1 or launches["K3"] < 1 or launches["K1"] != 0 or \
            launches["dense_suff_stats"] or launches["dense_cell_loglik"]:
        raise AssertionError("the packed path launched %s; it must launch "
                             "K2 and K3 and neither K1 nor K0"
                             % json.dumps(launches))
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
    time again, are left out), K0's share of it (its kernels, named
    k0_*), and the idle share, one minus the device time over the
    profiled wall."""
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
        k0 = [(sec, count, re.search(r"k0_\w+", key).group(0))
              for sec, count, key in rows if re.search(r"k0_\w+", key)]
        log("[profile] %s: K0 %.3f s of the device time (%s)"
            % (rung, sum(r[0] for r in k0),
               ", ".join("%s %.3f s x%d" % (name, sec, count)
                         for sec, count, name in k0) or "no launch"))
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


def _rung_agreement(res, base, conf):
    """A vireo_wrap result against a reference one (RUNG_AGREE's note):
    argmax agreement over the reference's confident singlets `conf`
    after label matching, the share of doublet calls alike, and
    LB_doublet's relative difference."""
    agree = _matched_agreement(res["ID_prob"][conf], base["ID_prob"][conf])
    dbl = float(np.mean((res["doublet_prob"].max(1) >= 0.9)
                        == (base["doublet_prob"].max(1) >= 0.9)))
    rel = abs(res["LB_doublet"] - base["LB_doublet"]) \
        / abs(base["LB_doublet"])
    return agree, dbl, rel


def phase_small_cross_check(torch):
    """The same seeded small pool on the card (float32, K0's kernels) and
    on the CPU (float64, K0's plain versions): the same optimum and the
    same calls up to the donors' labels."""
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
    same sums bit for bit. The int8-hybrid rung's base is an int8
    DenseCounts, whose contractions must launch both of K0's kernels."""
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
        _reset_launches()
        gpu = vireo_wrap(c, n_donor=K, n_init=5, random_seed=2,
                         verbose=False, check_ambient=True)
        launches = _launches()
        log("[rungs] %s launches %s" % (rung, json.dumps(launches)))
        if rung == "int8-hybrid" and not _k0_launched(launches):
            raise AssertionError("the int8-hybrid rung's base did not "
                                 "launch both of K0's kernels")
        # doublet cells split their small singlet mass between two
        # donors almost evenly, so their singlet argmax is a near tie
        # that float32 and float64 may break apart: the calls compared
        # are the confident singlets (max ID_prob >= 0.9 on the CPU) and
        # the doublet calls (max doublet_prob >= 0.9)
        conf = cpu["ID_prob"].max(1) >= 0.9
        agree, dbl, _ = _rung_agreement(gpu, cpu, conf)
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
        if agree < RUNG_AGREE or dbl < RUNG_AGREE:
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


@contextlib.contextmanager
def _sweep_fits(torch, out):
    """Append to `out`, for each fit of sweep_n_donor in the block (one a
    K), its K, seconds (ending in a device sync) and the launches of K0's
    two kernels, read from ops/counts.py::LAUNCHES before and after."""
    from vireo_tpu_torch.engine import select
    from vireo_tpu_torch.ops import counts
    real = select.fit_vb

    def spy(*args, **kwargs):
        torch.cuda.synchronize()
        before = dict(counts.LAUNCHES)
        t0 = time.perf_counter()
        res = real(*args, **kwargs)
        torch.cuda.synchronize()
        out.append(dict(K=args[3].n_donor, s=time.perf_counter() - t0,
                        launches={k: counts.LAUNCHES[k] - before[k]
                                  for k in before}))
        return res

    select.fit_vb = spy
    try:
        yield
    finally:
        select.fit_vb = real


def phase_ksweep(torch):
    """`[ksweep]`, KSWEEP's note: the sweep on int8 counts through K0 (the
    best K the truth, both of K0's kernels launched in every K's fit, the
    launches counted by width for the kernel table), then on the same
    counts as float32 (the plain versions). Returns the int8 sweep's
    launches ("K0_widths" by width)."""
    from vireo_tpu_torch.engine.select import sweep_n_donor
    from vireo_tpu_torch.ops import counts
    from vireo_tpu_torch.ops.counts import DenseCounts
    from vireo_tpu_torch.sim.synth import synth_pool_dense_device
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dc = synth_pool_dense_device(device=torch.device("cuda"),
                                 **KSWEEP)["counts"]
    torch.cuda.synchronize()
    V, C = dc.n_var, dc.n_cell
    log("[ksweep] pool %d x %d x %d, int8 DenseCounts, made on the card in "
        "%.2f s" % (V, C, KSWEEP["n_donor"], time.perf_counter() - t0))
    for K in KSWEEP_KS:
        N = KSWEEP_FIT["n_init"] * K
        log("[ksweep] K=%d: warm width N = %d, K0 column tiles: suff_stats "
            "%d, cell_loglik %d" % (K, N, *(
                counts.k0_plan(name, V, C, N, _sms(torch)).bn
                for name in K0_BOTH)))
    sweeps, launches = {}, None
    for label in ("int8", "float32"):
        c = dc if label == "int8" else DenseCounts(dc.ad.float(),
                                                   dc.dp.float())
        fits, widths = [], {}
        _reset_launches()
        t0 = time.perf_counter()
        with _sweep_fits(torch, fits), _k0_widths(widths):
            out = sweep_n_donor(c, n_donor_list=KSWEEP_KS, verbose=False,
                                **KSWEEP_FIT)
        wall = time.perf_counter() - t0
        if _launches()["MT"] != len(KSWEEP_KS):
            raise AssertionError("the sweep's %d seeded inits launched the "
                                 "MT stream kernel %d times"
                                 % (len(KSWEEP_KS), _launches()["MT"]))
        sweeps[label] = out
        for f in fits:
            log("[ksweep] %s K=%d: fit %.3f s, K0 launches %s; ELBOs of "
                "the restarts %s" % (label, f["K"], f["s"],
                                     json.dumps(f["launches"]),
                                     ["%.1f" % e for e in out[f["K"]]]))
        log("[ksweep] %s: best K %d, %.3f s, peak device memory %.3f GiB"
            % (label, out["best"], wall,
               torch.cuda.max_memory_allocated() / 2**30))
        if label == "int8":
            launches = _launches()
            launches["K0_widths"] = widths
            log("[ksweep] int8 launches %s" % json.dumps(launches))
            missed = [f["K"] for f in fits
                      if min(f["launches"].values()) < 1
                      or min(widths.get("%s N=%d" % (
                          k, KSWEEP_FIT["n_init"] * f["K"]), 0)
                          for k in f["launches"]) < 1]
            if len(fits) != len(KSWEEP_KS) or missed:
                raise AssertionError("K0's kernels were not both launched, "
                                     "at the warm width, in the fits of "
                                     "K = %s" % missed)
            if out["best"] != KSWEEP["n_donor"]:
                raise AssertionError("the sweep picked K = %d, not the "
                                     "truth %d" % (out["best"],
                                                   KSWEEP["n_donor"]))
        elif any(counts.LAUNCHES.values()):
            raise AssertionError("float32 counts launched K0: %s"
                                 % json.dumps(counts.LAUNCHES))
        del c
        torch.cuda.empty_cache()
    i8, f32 = sweeps["int8"], sweeps["float32"]
    for K in KSWEEP_KS:
        rel = float(np.max(np.abs(f32[K] - i8[K]) / np.abs(i8[K])))
        log("[ksweep] K=%d: best restart %d (int8) and %d (float32), "
            "largest relative ELBO difference %.3e (gate %.0e)"
            % (K, int(np.argmax(i8[K])), int(np.argmax(f32[K])), rel,
               RUNG_ELBO_RTOL))
        if np.argmax(i8[K]) != np.argmax(f32[K]) or rel > RUNG_ELBO_RTOL:
            raise AssertionError("K=%d: the float32 sweep differs from the "
                                 "int8 sweep" % K)
    if f32["best"] != i8["best"]:
        raise AssertionError("the float32 sweep picked K = %d"
                             % f32["best"])
    del dc
    torch.cuda.empty_cache()
    log("[ksweep] the phase took %.1f s" % (time.perf_counter() - t_phase))
    return launches


def _heavy_pool(n_var, n_cell, n_donor, hot_frac, density, seed=0):
    """benchmarks/e2e_hybrid.py's heavy-tailed pool, its generator's lines
    (:35-63) with its names: AD and DP as scipy CSR, and the truth
    (donor, is_dbl, donor2: -1 for a singlet)."""
    import scipy.sparse as sp
    V, C, K = n_var, n_cell, n_donor
    rng = np.random.RandomState(seed)
    nnz = int(V * C * density)
    rows = rng.randint(0, V, size=nnz)
    cols = rng.randint(0, C, size=nnz)
    GT = rng.randint(0, 3, size=(V, K))
    theta = np.array([0.02, 0.5, 0.98])
    donor = rng.randint(0, K, size=C)
    is_dbl = rng.rand(C) < 0.08
    donor2 = np.where(is_dbl, rng.randint(0, K, size=C), -1)

    dp = rng.poisson(3.0, size=nnz) + 1
    hot = rng.rand(nnz) < hot_frac
    dp = dp + hot * rng.randint(200, 2000, size=nnz)
    p = theta[GT[rows, donor[cols]]]
    p2 = theta[GT[rows, donor2[cols]]]
    use2 = (donor2[cols] >= 0) & (rng.rand(nnz) < 0.5)
    p = np.where(use2, p2, p)
    ad = rng.binomial(dp, p)
    DP = sp.csr_matrix((dp.astype(np.float64), (rows, cols)), shape=(V, C))
    AD = sp.csr_matrix((ad.astype(np.float64), (rows, cols)), shape=(V, C))
    DP.sum_duplicates()
    AD.sum_duplicates()
    return dict(AD=AD, DP=DP, donor=donor, is_dbl=is_dbl, donor2=donor2)


def _heavy_accuracy(pool, ID_prob):
    """benchmarks/e2e_hybrid.py's singlet accuracy: over the true
    singlets called with max ID_prob >= 0.9, after label matching
    (Hungarian) over all true singlets; and the share so called."""
    from scipy.optimize import linear_sum_assignment
    K = ID_prob.shape[1]
    pred = np.argmax(ID_prob, axis=1)
    singlets = ~pool["is_dbl"]
    hits = np.zeros((K, K))
    for t in range(K):
        hits[t] = np.bincount(pred[singlets & (pool["donor"] == t)],
                              minlength=K)
    ti, pi = linear_sum_assignment(-hits)
    remap = np.empty(K, np.int64)
    remap[pi] = ti
    conf = singlets & (ID_prob.max(axis=1) >= 0.9)
    return (float(np.mean(remap[pred[conf]] == pool["donor"][conf])),
            float(np.mean(conf[singlets])))


@contextlib.contextmanager
def _warm_restarts(keep):
    """vireo_wrap's warm restarts (its call of fit_vb) in the block: while
    keep has no "warm", the fit runs and its result is kept there; once
    it has one, the fit is not run and the kept result stands in for it,
    so the run's refit and doublet phase start from the kept run's
    winner (a seeded run hands that winner to its refit through the
    host, so the kept tensors are not written)."""
    from vireo_tpu_torch.engine import wrap
    real = wrap.fit_vb

    def spy(*args, **kwargs):
        if "warm" not in keep:
            keep["warm"] = real(*args, **kwargs)
        return keep["warm"]

    wrap.fit_vb = spy
    try:
        yield
    finally:
        wrap.fit_vb = real


def _heavy_run(torch, pool, c, rung, tag, keep):
    """vireo_wrap(c, HEAVY_FIT) with every launch count set to 0 just
    before and read just after, its warm restarts kept into or taken
    from `keep` (`_warm_restarts`); logged. Returns the result, the
    launches and the accuracy."""
    from vireo_tpu_torch.engine.wrap import vireo_wrap
    phases, fits = {}, []
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    with _fit_lengths(fits), _warm_restarts(keep):
        res = vireo_wrap(c, n_donor=HEAVY["n_donor"], verbose=False,
                         timing=phases, **HEAVY_FIT)
    wall = time.perf_counter() - t0
    launches = _launches()
    acc, assigned = _heavy_accuracy(pool, res["ID_prob"])
    top = np.argsort(res["LB_list"])[::-1][:3]
    log("[heavy] %s, %s: fit iterations %s; the warm restarts' ELBOs (LB_list), best: "
        "%s; vireo_wrap %.3f s (%s); peak device memory %.3f GiB; "
        "launches %s; singlet accuracy %.5f over %.5f of the singlets; "
        "LB_doublet %.6e"
        % (rung, tag, fits[0] if len(fits) == 1 else
           "%s, then %s" % (fits[0], fits[1][0]),
           ", ".join("%d %.6e" % (i, res["LB_list"][i]) for i in top), wall,
           ", ".join("%s %.3f s" % kv for kv in phases.items()),
           torch.cuda.max_memory_allocated() / 2**30, json.dumps(launches),
           acc, assigned, res["LB_doublet"]))
    return res, launches, acc


def phase_heavy(torch):
    """`[heavy]`, HEAVY's note: the pool on its default rung and on each
    rung of HEAVY_RUNGS, each placed by counts_from_scipy (the ladder's
    rung checked), its two contractions run twice (equal bit for bit)
    and handed to vireo_wrap prebuilt. Each rung's own run: the default
    rung (dense int16) and the int8-hybrid base launch both of K0's
    kernels, the packed-hybrid base K2 and K3, the COO rung none of
    K0-K3, and no rung K1; its placement, phases, residual nonzeros,
    peak memory and accuracy are logged, and its calls beside the
    default run's.

    In float32 the warm restarts of this pool reach other optima on
    other rungs (their sums round apart, and 20 iterations from random
    inits amplify that), so each forced rung's calls are held against
    the default rung's from one state: the forced rung runs vireo_wrap
    again with the default run's warm restarts standing in for its own
    (`_warm_restarts`), so its refit and doublet phase start from the
    default run's winner. That run's calls against the default run's:
    RUNG_AGREE of the confident singlets after label matching and of
    the doublet calls, LB_doublet within RUNG_ELBO_RTOL, singlet
    accuracy within HEAVY_ACC_ATOL. The default rung's own rerun from its
    kept restarts must equal its run bit for bit."""
    from vireo_tpu_torch.ops import counts
    V, C, K = (HEAVY[k] for k in ("n_var", "n_cell", "n_donor"))
    cuda = torch.device("cuda")
    t_phase = t0 = time.perf_counter()
    pool = _heavy_pool(**HEAVY)
    AD, DP = pool["AD"], pool["DP"]
    vmax = float(DP.max())
    log("[heavy] pool %d x %d x %d, %d nonzeros (%d above 127, %d above "
        "15; largest count %d), generated on the host in %.2f s"
        % (V, C, K, DP.nnz, int((DP.data > 127).sum()),
           int((DP.data > 15).sum()), int(vmax), time.perf_counter() - t0))
    torch.cuda.empty_cache()
    budget = counts.device_dense_budget(cuda)
    log("[heavy] default budget %.1f GiB (55%% of the card's memory): "
        "rung %s (counts in %s)"
        % (budget / 2**30, counts.ladder_rung((V, C), vmax, budget),
           counts.exact_count_dtype(vmax)))
    keep, base = {}, None
    for rung, units in (("default", None),) + HEAVY_RUNGS:
        if units is not None:
            budget = max(units * V * C, 1)
            if counts.ladder_rung((V, C), vmax, budget) != rung:
                raise AssertionError("budget %d does not give the %s rung"
                                     % (budget, rung))
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        c = counts.counts_from_scipy(AD, DP, device=cuda,
                                     dense_budget=budget)
        torch.cuda.synchronize()
        log("[heavy] %s: %s%s%s placed in %.3f s; residual nonzeros %s"
            % (rung, type(c).__name__,
               "/" + type(c.base).__name__ if hasattr(c, "base") else "",
               " " + str(c.ad.dtype) if hasattr(c, "ad") else "",
               time.perf_counter() - t0,
               c.resid_nnz if hasattr(c, "resid") else None))
        _check_repeatable(torch, rung, c)
        own = {} if base is not None else keep
        res, launches, acc = _heavy_run(torch, pool, c, rung, "own run",
                                        own)
        k0 = launches["dense_suff_stats"] + launches["dense_cell_loglik"]
        k23 = launches["K2"] + launches["K3"]
        want = {"default": _k0_launched(launches) and k23 == 0,
                "int8-hybrid": _k0_launched(launches) and k23 == 0,
                "packed-hybrid": min(launches["K2"], launches["K3"]) > 0
                and k0 == 0}.get(rung, k0 == 0 and k23 == 0)
        if not want or launches["K1"]:
            raise AssertionError("the %s rung launched %s" % (
                rung, json.dumps(launches)))
        again, _, again_acc = _heavy_run(
            torch, pool, c, rung, "from the default run's warm restarts",
            keep)
        del c
        torch.cuda.empty_cache()
        if base is None:
            base, base_acc = res, acc
            conf = base["ID_prob"].max(1) >= 0.9
            same = all(np.array_equal(again[k], res[k]) for k in (
                "ID_prob", "doublet_prob", "LB_doublet", "GT_prob"))
            log("[heavy] default: the rerun from its kept warm restarts "
                "equal bit for bit: %s" % same)
            if not same:
                raise AssertionError("the default rung's rerun from its "
                                     "kept warm restarts differs")
            continue
        log("[heavy] %s's own run vs the default run (not gated: other "
            "optima): argmax agreement %.5f, doublet calls %.5f, "
            "LB_doublet relative difference %.3e, singlet accuracy %.5f "
            "vs %.5f" % ((rung,) + _rung_agreement(res, base, conf)
                         + (acc, base_acc)))
        agree, dbl, rel = _rung_agreement(again, base, conf)
        log("[heavy] %s from the default run's warm restarts vs the "
            "default run: argmax agreement %.5f over %d confident "
            "singlets after label matching, doublet calls %.5f (gates "
            "%.2f), LB_doublet relative difference %.3e (gate %.0e), "
            "singlet accuracy %.5f vs %.5f (gate %.2f)"
            % (rung, agree, int(conf.sum()), dbl, RUNG_AGREE, rel,
               RUNG_ELBO_RTOL, again_acc, base_acc, HEAVY_ACC_ATOL))
        if agree < RUNG_AGREE or dbl < RUNG_AGREE or \
                rel > RUNG_ELBO_RTOL or \
                abs(again_acc - base_acc) > HEAVY_ACC_ATOL:
            raise AssertionError("the %s rung's calls disagree with the "
                                 "default rung's" % rung)
    log("[heavy] the phase took %.1f s" % (time.perf_counter() - t_phase))


def phase_many_donors(torch):
    """A seeded 23-donor pool on the dense rung of the card under
    VIREO_FUSED_DOUBLET=1: its doublet space has 23 + C(23,2) = 276
    columns, more than one 256-column tile of K1 (and more than the
    first design's limit, at which such a pool raised). K1 must launch,
    and the confident singlet calls and the doublet calls must agree
    with the same call on the CPU (float64, K1's plain version) up to
    the donors' labels."""
    from vireo_tpu_torch.ops import fused_em
    from vireo_tpu_torch.sim.synth import synth_pool_counts
    from vireo_tpu_torch.engine.wrap import vireo_wrap
    V, C, K = (MANY_DONORS[k] for k in ("n_var", "n_cell", "n_donor"))
    d = synth_pool_counts(V, C, K, doublet_rate=0.08, density=0.2, seed=7)
    with _env("VIREO_FUSED_DOUBLET", "1"):
        t0 = time.perf_counter()
        fused_em.LAUNCHES = 0
        gpu = vireo_wrap(d["AD"], d["DP"], n_donor=K, n_init=5,
                         random_seed=2, verbose=False, device="cuda")
        launches = fused_em.LAUNCHES
        wall = time.perf_counter() - t0
        cpu = vireo_wrap(d["AD"], d["DP"], n_donor=K, n_init=5,
                         random_seed=2, verbose=False, device="cpu")
    conf = cpu["ID_prob"].max(1) >= 0.9
    agree, dbl, _ = _rung_agreement(gpu, cpu, conf)
    log("[donors] %d donors (%d doublet columns) on the card under "
        "VIREO_FUSED_DOUBLET=1: %.2f s, K1 launches %d; vs the CPU: argmax "
        "agreement %.5f over %d confident singlets after label matching, "
        "doublet calls %.5f; %s"
        % (K, K + K * (K - 1) // 2, wall, launches, agree, int(conf.sum()),
           dbl, json.dumps(_singlet_accuracy(d, gpu["ID_prob"],
                                             gpu["doublet_prob"]))))
    if launches < 1:
        raise AssertionError("the 23-donor pool did not launch K1")
    if agree < RUNG_AGREE or dbl < RUNG_AGREE:
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
    phases, fits, amb, widths = {}, [], {}, {}
    _reset_launches()
    t0 = time.perf_counter()
    with _fit_lengths(fits), _ambient_record(amb), _k0_widths(widths):
        res = vireo_wrap(counts, random_seed=0, verbose=False,
                         timing=phases, **kw)
    wall = time.perf_counter() - t0
    launches = _launches()
    launches["K0_widths"] = widths
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
    dense rung (K0, in the doublet phase too: its cell_loglik at the
    doublet's width, no K1): all 16 donors known, with
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
        if not _doublet_on_k0(launches, _doublet_width(res)):
            raise AssertionError("the %s mode's doublet phase did not take "
                                 "K0 at its width, or launched K1" % mode)
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
    no K0 or K1), placed under VIREO_DENSE_BUDGET_GB=PACKED_BUDGET_GB. Each fit
    iteration launches K2 and K3 once; the doublet phase K3 (its
    log-likelihood) and K2 + K3 (the genotype refresh); the ambient
    phase's SNP gate K2 once (PR 5, without the ambient phase: K2 15 =
    14 + 1, K3 16 = 14 + 2); its one seeded init the MT stream once.
    Gate 2: argmax psi agrees with the dense run's. Returns the packed
    counts."""
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
    want = dict(K1=0, K2=fit_iters + 2, K3=fit_iters + 2, MT=1,
                dense_suff_stats=0, dense_cell_loglik=0, K0_widths={})
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
    small pool, on the card (float32, K0) and on the CPU (float64, K0's
    plain versions): the same calls up to the donors' labels (confident
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
    bit, both of K0's kernels launched on the rank's block, its
    cell_loglik at the doublet's width, and no K1; the process group is
    destroyed after."""
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
        phases, fits, widths = {}, [], {}
        _reset_launches()
        t0 = time.perf_counter()
        with _fit_lengths(fits), _k0_widths(widths):
            res = vireo_wrap(d["AD"], d["DP"], n_donor=MAIN["n_donor"],
                             n_init=MAIN["n_init"], random_seed=0,
                             check_doublet=True, verbose=False,
                             timing=phases, mesh=mesh)
        wall = time.perf_counter() - t0
        launches = _launches()
        launches["K0_widths"] = widths
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
    if not all(same.values()) or not _k0_launched(launches) or \
            not _doublet_on_k0(launches, DOUBLET_N):
        raise AssertionError("the one-rank NCCL mesh run differs from the "
                             "run without a mesh, or did not launch K0 (at "
                             "the doublet's width too), or launched K1")
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
                       r"(\S+) GiB, kernel launches K0 (\d+) (\d+) K1 "
                       r"(\d+) K2 (\d+) K3 (\d+)", text)
    best = np.array([int(r[5][len("donor"):]) for r in rows])
    acc, agree = _singlet_calls(d, best, np.argmax(main7["ID_prob"], 1))
    log("[mesh_cli] wall %.3f s (two ranks, launch to exit); %d rows, "
        "singlet accuracy %.5f, singlets called as in phase 7 %.5f"
        % (wall, len(rows), acc, agree))
    if len(rows) != C or acc < MESH_ACC or agree < MESH_AGREE \
            or len(ranks) != 2 or any(min(int(r[2]), int(r[3])) < 1
                                      or int(r[4]) != 0 for r in ranks):
        raise AssertionError("the 2-rank CLI run is wrong (per rank peak "
                             "GiB and K0's two, K1, K2, K3 launches: %s)"
                             % (ranks,))


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
    # the best warm ELBO is phase 8's to SCALAR_RTOL. Each rank makes the
    # whole init stream: one MT launch.
    fits, fits8 = root["fits"], packed8["fits"]
    refit, refit8 = (sum(f[0] for f in x[1:]) for x in (fits, fits8))
    want = max(fits[0]) + refit + 1
    counted = all(rec["launches"] == {"K1": 0, "K2": want, "K3": want + 1,
                                      "MT": 1, "dense_suff_stats": 0,
                                      "dense_cell_loglik": 0}
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
    k0 = phase_k0(torch)
    phase_k0_int16(torch)
    probes, probe_launches = phase_probes(torch)
    mt = phase_mt(torch)
    d = _main_pool()
    phase_synth(torch, d)
    dense_res, dense_launches, dense_fits, keep = phase_main_path(torch, d)
    knob_k1 = phase_doublet_routes(torch, d, dense_res, keep)
    del keep
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
    ksweep = phase_ksweep(torch)
    phase_heavy(torch)
    phase_mesh_small()
    phase_small_cross_check(torch)
    phase_small_branches(torch)
    phase_small_rungs(torch)
    phase_many_donors(torch)
    phase_small_models(torch)
    phase_checkpoints(torch)
    phase_cli()

    # each kernel at its main-path shape, with the launches of the run of
    # its path: K1 at the doublet phase's shape with the launches of that
    # phase under VIREO_FUSED_DOUBLET=1 (vireo_wrap's dense run, whose
    # default doublet phase launches none), and at the fused fit's with
    # that fit's launches; K0 (vireo_wrap on the dense rung) at the warm
    # restarts' (N = 20 x 16) with all of that run's launches, and its
    # cell_loglik again at the doublet phase's N = 136 with the launches
    # at that width; K2 and K3 (on the packed rung) at the warm restarts';
    # K0 at the K sweep's widths 96 and 128 with [ksweep]'s launches there;
    # the MT stream at the main call's 60.8M doubles with that run's launch
    table = [
        ("fused_estep_stats", "vireo_tpu_torch/csrc/fused_estep.cu",
         "vireo_tpu/ops/pallas_em.py:145",
         "vireo_wrap dense, doublet phase under VIREO_FUSED_DOUBLET=1",
         knob_k1, k1["doublet"]),
        ("fused_estep_stats_fit", "vireo_tpu_torch/csrc/fused_estep.cu",
         "vireo_tpu/ops/pallas_em.py:145", "fused fit", fused_launches,
         k1["fit_full"]),
        ("packed_suff_stats", "vireo_tpu_torch/csrc/packed_counts.cu",
         "vireo_tpu/ops/packed.py:161", "vireo_wrap packed",
         packed_launches["K2"], k23[("warm", "suff_stats")]),
        ("packed_cell_loglik", "vireo_tpu_torch/csrc/packed_counts.cu",
         "vireo_tpu/ops/packed.py:195", "vireo_wrap packed",
         packed_launches["K3"], k23[("warm", "cell_loglik")]),
    ] + [("dense_" + name, "vireo_tpu_torch/csrc/dense_counts.cu",
          "vireo_tpu/ops/counts.py:78, :87 (XLA dots)", "vireo_wrap dense",
          dense_launches["dense_" + name], k0[("warm", name)])
         for name in ("suff_stats", "cell_loglik")] + [
        ("dense_cell_loglik_doublet", "vireo_tpu_torch/csrc/dense_counts.cu",
         "vireo_tpu/ops/counts.py:87 (XLA dot), reached from "
         "vireo_tpu/models/doublet.py:90",
         "vireo_wrap dense, doublet phase (N = %d)" % DOUBLET_N,
         dense_launches["K0_widths"].get(
             "dense_cell_loglik N=%d" % DOUBLET_N, 0),
         k0[("doublet", "cell_loglik")])] + [
        ("dense_%s_sweep_n%d" % (name, N),
         "vireo_tpu_torch/csrc/dense_counts.cu",
         "vireo_tpu/ops/counts.py:%s (XLA dot), reached from "
         "vireo_tpu/engine/select.py:65" % line,
         "sweep_n_donor on int8 counts, K = %d (N = %d)"
         % (N // KSWEEP_FIT["n_init"], N),
         ksweep["K0_widths"].get("dense_%s N=%d" % (name, N), 0),
         k0[("sweep%d" % N, name)])
        for N in (96, 128)
        for name, line in (("suff_stats", 78), ("cell_loglik", 87))] + [
        ("mt_stream", "vireo_tpu_torch/csrc/mt19937.cu",
         "none (vireo_tpu/ops/mt19937.py makes the stream with XLA ops)",
         "vireo_wrap dense, seeded inits (%d restarts; plain: numpy's "
         "rand of the same stream on the host)" % MAIN["n_init"],
         dense_launches["MT"], mt)]
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
           if name in wrap_launches else {}),
        **({"vireo_wrap_launches": dense_launches["K1"]}
           if name == "fused_estep_stats" else {}),
        **{k: res[k] for k in ("library_f32_ms", "library_bf16_ms")
           if k in res},
        **({"note": "redesigned PR 13"} if name.startswith("dense_")
           else {}))
        for name, source, replaces, path, launches, res in table]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
