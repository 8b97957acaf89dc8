// The dense rung's two contractions over int8 and int16 counts: K0.
//
// Replaces the XLA dots of vireo_tpu/ops/counts.py::DenseCounts (no
// Pallas kernel there): for int8 counts `_operand` (:71-76) casts AD and
// DP to bf16 inside the dot, which XLA fuses into the matmul's read, so
// each count byte is read once a contraction:
//
//   suff_stats  (:78):  S1 = AD W,  SS = DP W            (V, N) each
//   cell_loglik (:87):  out = AD^T Wa + DP^T Wd          (C, N)
//
// AD and DP are (V, C) int8 counts in [0, 127] (or int16 counts, below),
// row-major with the cells contiguous. A row's cells need not start on
// any boundary and rows may lie `pitch` bytes apart with pitch > C: a
// cell range of a wider matrix (DenseCounts.cell_slice) runs in place,
// and nothing past a row's C counts is read. The weights are float32; the wrapper
// (vireo_tpu_torch/ops/counts.py) splits them into three bf16 terms,
// W = hi + mid + lo exactly (ops/packed.py::split_bf16x3), written
// K-major as B. A count (< 128) times a bf16 term is exact in float32,
// so the kernels form the products the plain version sums.
//
// What bounds it on an H100, at the main pool's shape (V = 30000,
// C = 100000): the counts are 6.0 GB, 1.79 ms at 3.35 TB/s, and each
// contraction is 3 x 2 x 2 V C N flops on the tensor cores, 11.65 ms at
// 989 TFLOP/s at N = 320 (the warm restarts: 20 x 16 columns), 0.58 ms
// at N = 16 (the refit). So the warm restarts are bound by operations,
// the refit by bytes. The first K0 (K2's and K3's kernels with an int8
// codec) reached 36-44% of those bounds: each 64-deep k-block built its
// A fragments from single bytes, issued its MMAs, drained the tensor
// pipe and added the sums, one after another behind a block barrier, so
// the CUDA-core work never overlapped the MMAs; the grids left tail
// waves (7.12 and 1.78 waves on 132 SMs); and the same bytes were read
// again and again from L2 (the counts four times at N = 320, B from
// 128-cell blocks in cell_loglik, ~120 GB at N = 320). This design:
//
// - A producer warpgroup and two consumer warpgroups; setmaxnreg moves
//   registers from the producer (40 a thread) to the consumers (232),
//   which hold four accumulator sets. One lane of the producer keeps a
//   ring of stages full by TMA: B's boxes and the counts' boxes
//   (2-D tensor maps over the count rows), all reported to the slot's
//   "full" mbarrier. The consumers wait on "full", build A in registers,
//   issue wgmma and arrive on the slot's "empty" barrier (one arrival a
//   warp, by a predicated instruction) once the MMAs that read it are
//   done. No block barrier in the loop.
// - Counts that TMA cannot address (a row start off a 16-byte boundary,
//   as a cell_slice view from an odd column gives, or rows not a whole
//   16 bytes apart) take the other producer path: the producer warp's 32
//   lanes read the aligned 4-byte words that hold the k-block's bytes of
//   each row, realign them with funnel shifts and store them in the
//   layout TMA would have written, zero past the row's C bytes, then
//   arrive on "full"; B still comes by TMA. (cp.async copies only
//   aligned 4-, 8- or 16-byte units, which an odd start does not have.)
//   The consumers' code is the same for both paths; the producer's other
//   warps exit. The wrapper picks the path (ops/counts.py::k0_producer).
// - Two groups of MMAs in flight a warpgroup, so the CUDA-core work
//   overlaps the tensor cores: each k-block's MMAs are committed as two
//   groups, and while one runs the warpgroup adds the other's finished
//   k-block sums and builds its next fragments (`wgmma_wait<1>`).
//   suff_stats' two groups are the two count matrices (S1 and SS have
//   their own accumulators), cell_loglik's the warpgroup's two m64 tiles
//   of cells.
// - A from 16-byte (suff_stats) and 2-byte (cell_loglik) loads, each
//   register one byte_perm and one fma.rn.bf16x2 (`pair_of`: 0x43xx is
//   128 + xx, and subtracting 128 is exact). suff_stats: the order of k
//   inside a k-block is free, so the wrapper writes B's k values in the
//   order that puts a thread's 16 k values of a k-block in 16 adjacent
//   count bytes: k value L = 16 s + 8 h + 2 c + e (k16 step s, register
//   half h, lane column c, element e) is cell 16 c + 4 s + 2 h + e of
//   the k-block (ops/counts.py::k0_k_order). cell_loglik: the cells of
//   a block are permuted instead, thread (warp w, row g) owning cells
//   4 g + q of its warp's 32 (q = 2 tile + (row g + 8)), so one 2-byte
//   load of a variant row gives its two cells of one tile; the epilogue
//   puts the cells back. Its B is split_weights_kmajor's, unpermuted.
// - Wider tiles, fewer bytes read again. suff_stats: a block owns 128
//   variants x at most 80 columns of both matrices (four accumulator
//   sets of 40 floats a thread: one k-block's sums and the running sums
//   of each matrix), stages of one k-block (16 KB of counts, 30 KB of
//   B), four in the ring at 80 columns, eight at 16. cell_loglik: a
//   block owns 256 cells (two m64 tiles a warpgroup) x at most 64
//   columns, which halves the B read from L2 against 128-cell blocks
//   (45 GB at N = 320), in stages of one count matrix of a k-block (16
//   KB of counts as two 128-byte-swizzled boxes, 24 KB of that matrix's
//   B planes), five in the ring at 64 columns, eight at 16.
// - The B operand written by a kernel (`k0_operand_kernel`, the first
//   launch of each call): W read once, its three bf16 terms written
//   transposed through shared memory, in suff_stats' k order, where the
//   wrapper's split, padding, permutation and transposed copies took
//   several passes over W.
// - Persistent blocks on a static tile schedule (ops/counts.py::
//   k0_plan): a unit is (slice of k-blocks, row or cell tile, column
//   tile); block b takes units b, b + grid, ... and its ring flows on
//   across units. Where the tiles leave a tail wave the plan splits the
//   contracted axis into at most 8 slices of whole k-blocks (suff_stats
//   at N = 16: 235 row tiles become 5 x 235 units, 99% of 9 waves), and
//   each slice's sums go to a (slices, ..., N) scratch that
//   `k0_sum_slices` adds in order.
//
// What binds it now, on an H100 at the main pool's shape (PERF.md's K0
// rows, with the controls below): at N = 16 the counts' bytes (both
// kernels at 74-86% of the bytes bound); at N = 320 suff_stats the MMA
// issue (its loop without the CUDA-core adds at about 81% of the
// operations bound, the adds up to 8% more), cell_loglik the ring's
// delivery from L2 (its loop without MMAs is no faster than the kernel;
// in a trial, B's multicast over clusters of two cell tiles made that
// loop faster than the kernel but not the kernel at N = 320: the MMA
// loop binds next).
//
// The order of the sums, fixed, with no atomics, so results do not
// change between runs: each k-block of 64 cells (suff_stats) or
// variants (cell_loglik: both matrices and the six bf16 terms of the
// k-block into one accumulator set) is summed by the tensor cores into
// fresh accumulators (the tensor cores truncate at each k16 step: one
// sum there erred by 153 at N = 320 where this errs by 1.2, PERF.md,
// K2); a slice's k-block sums are added in k order to float32 sums that
// start at 0, rounding to nearest, on the CUDA cores; the slices are
// added in slice order ((s0 + s1) + s2) + ... by k0_sum_slices (one
// slice: written as it is).
//
// int16 counts (0 to 16383: the pools counted by reads, whose counts pass
// int8's 127) go through the same kernels, templated on the count's
// bytes W (the int8 kernels are W = 1). A count splits exactly into two
// 7-bit planes, c = lo + 128 hi, each made a bf16 pair as pair_of makes a
// byte's (`plane_of`; the high plane scaled by 128 in the same fma,
// exact), and both planes multiply the same three bf16 terms of B into
// the same accumulators: every product stays exact in float32, and B's
// shared memory and L2 traffic do not grow, only the count bytes of a
// stage. Every k-block commits four groups of MMAs: the low plane's two,
// then the high plane's two (fr is reused: each build waits for the
// group before the one before it, as in int8's k-blocks), whose MMAs
// run only where the warpgroup's tile of the k-block (suff_stats: 64
// variants x 64 cells; cell_loglik: 128 cells x 64 variants) holds a
// count above 127 in either matrix, decided by a reduction over the
// warpgroup's threads (`warpgroup_any`), so uniform for its MMAs. (With
// the high plane's groups committed only where they ran, ptxas spilled
// suff_stats' int16 kernel at 48 columns.) A pool with its deep entries
// sparse (heavy16: 0.2% of 1% of the entries) runs the high plane in 8%
// of suff_stats' tiles and 15% of cell_loglik's. int16
// tiles are at most 48 columns wide (K0_INT16_WIDTHS), four 50 KB stages
// in the ring: suff_stats' rows are 128 bytes with the 128-byte swizzle;
// cell_loglik's 256 cells are four boxes of 64, one an m64 tile, its A
// read by transposed ldmatrix with the cells in order. Where `high` is
// given, each warpgroup adds its k-blocks and those that ran the high
// plane (ops/counts.py::K0_HIGH). At heavy16's shape (PERF.md's K0 rows)
// cell_loglik at N = 320 is bound by the ring's delivery from L2: the
// counts' bytes doubled, read again for each of 7 column tiles.
//
// Controls for measurement (mode): kNoMma builds the fragments and
// keeps the ring moving but issues no MMA (the fragments are folded into
// one word a thread); kNoFold issues the same MMAs but sums a unit's
// k-blocks on the tensor cores in one accumulator set, with no adds on
// the CUDA cores (its sums are stored, so no MMA is dead code). Neither
// writes the contraction.
//
// Interface: plain C entry points, loaded with ctypes. Each launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError()
// (or cudaErrorInvalidValue for shapes or plans it does not take).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

using hopper::kKBlock;
using hopper::kSmemAlign;

constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
// registers a thread after setmaxnreg: the producer warpgroup gives up
// what the consumers take (128 x 40 + 256 x 232 <= 65536; the launch
// gives each of the 384 threads 168)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kRing = 220 * 1024;          // bytes of stages a block may use
constexpr int kMaxStages = 8;
constexpr uint32_t kBias = 0x43434343u;    // bf16 128.0's high byte, x4

enum Mode { kFull = 0, kNoMma = 1, kNoFold = 2 };
enum Which { kSuff = 0, kLoglik = 1 };

constexpr int ring_stages(int stage) {
  return kRing / stage < kMaxStages ? kRing / stage : kMaxStages;
}

// The static tile schedule (ops/counts.py::k0_plan). Units in order:
// slice-major, then row (or cell) tiles, then column tiles.
struct Plan {
  int m_len;     // output rows: V (suff_stats) or C (cell_loglik)
  int N;
  int m_tiles, n_tiles;
  int nkb;       // 64-deep k-blocks of the contracted axis
  int slice_kb;  // k-blocks a slice
  int slices;
  long long units;
  __device__ __forceinline__ void unit(long long u, int& mt, int& nt,
                                       int& sl, int& t0, int& t1) const {
    const long long per = (long long)m_tiles * n_tiles;
    sl = (int)(u / per);
    const long long rest = u - (long long)sl * per;
    mt = (int)(rest / n_tiles);
    nt = (int)(rest - (long long)mt * n_tiles);
    t0 = sl * slice_kb;
    t1 = min(t0 + slice_kb, nkb);
  }
};

// The two count matrices, for the producer path without TMA.
struct Src {
  const uint8_t* ad;
  const uint8_t* dp;
  long long pitch;  // bytes from a row to the next
  int rows;         // V
  long long len;    // C, the bytes of a row
};

template <int R>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// A register x = (0x43, b1, 0x43, b0) as the exact bf16 pair (b0, b1),
// b0 in the low half (hopper::bf16_pair's arithmetic).
__device__ __forceinline__ uint32_t unbias(uint32_t x) {
  const uint32_t one = 0x3F803F80u, minus128 = 0xC300C300u;
  uint32_t y;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(y)
      : "r"(x), "r"(one), "r"(minus128));
  return y;
}

// The bf16 pair of two bytes of w, chosen by a byte_perm selector whose
// nibbles 0 and 2 name them (nibbles 1 and 3 are 4: kBias's 0x43).
__device__ __forceinline__ uint32_t pair_of(uint32_t w, uint32_t sel) {
  return unbias(__byte_perm(w, kBias, sel));
}

// int16 counts c in [0, 16383] as two exact 7-bit planes, c = lo + 128 hi
// with lo, hi in [0, 127]. x holds two counts as its 16-bit halves; a
// plane of both is one exact bf16 pair (the low half's count in the low
// half): the plane's 7 bits under 0x43, as pair_of's bytes, then
// unbiased, the high plane scaled by 128 in the same fma (128 (128 + h)
// - 16384 = 128 h, exact: h has at most 7 significant bits).
constexpr uint32_t kLow7 = 0x007F007Fu;    // a plane's bits in each half
constexpr uint32_t kBias16 = 0x43004300u;  // 0x43 above each half's byte
constexpr uint32_t kOver127 = 0xFF80FF80u; // a count above 127, each half

template <int kPlane>
__device__ __forceinline__ uint32_t plane_of(uint32_t x) {
  const uint32_t biased = ((x >> (7 * kPlane)) & kLow7) | kBias16;
  // (1, -128) or (128, -16384), bf16 x2
  const uint32_t scale = kPlane ? 0x43004300u : 0x3F803F80u;
  const uint32_t minus = kPlane ? 0xC680C680u : 0xC300C300u;
  uint32_t y;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(y)
      : "r"(biased), "r"(scale), "r"(minus));
  return y;
}

// Whether `p` holds in any thread of the calling consumer warpgroup `wg`
// (named barrier 1 + wg over its 128 threads; the producer's warps never
// reach it), read from lane 0 so that the compiler sees it uniform
// across the warp, as the warpgroup's MMAs that it guards need.
__device__ __forceinline__ bool warpgroup_any(bool p, int wg) {
  uint32_t any;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.b32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, 128, p;\n"
      "selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(any)
      : "r"((int)p), "r"(1 + wg)
      : "memory");
  return __shfl_sync(0xFFFFFFFFu, any, 0) != 0;
}

// Bytes [lo, lo + 16) of a count row of `len` bytes at `row`, zero past
// len, read as the aligned 4-byte words that hold at least one of them
// (such a word holds a byte of the row, so it never crosses a page).
__device__ __forceinline__ uint4 gather16(const uint8_t* row, long long len,
                                          long long lo) {
  uint32_t o[4] = {0u, 0u, 0u, 0u};
  if (lo < len) {
    const uintptr_t end = (uintptr_t)row + (uintptr_t)len;
    const uintptr_t a = (uintptr_t)row + (uintptr_t)lo;
    const uintptr_t a4 = a & ~(uintptr_t)3;
    const uint32_t sh = (uint32_t)(a & 3) * 8u;
    uint32_t w[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const uintptr_t p = a4 + 4 * i;
      w[i] = p < end ? __ldg(reinterpret_cast<const unsigned int*>(p)) : 0u;
    }
    const long long valid = len - lo;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t x = __funnelshift_r(w[i], w[i + 1], sh);
      const long long nb = valid - 4 * i;
      o[i] = nb >= 4 ? x : nb <= 0 ? 0u : x & ((1u << (8 * nb)) - 1u);
    }
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// ---------------------------------------------------------------------
// suff_stats: S1 = AD W, SS = DP W. A block's unit is 128 variants (64 a
// consumer warpgroup) x BN columns of both outputs x one slice of
// k-blocks of 64 cells. A stage: B's three planes (BN rows x 128 bytes
// each, 128-byte swizzle), then each matrix's 128 rows x 64 counts. int8
// rows are 64 bytes, not swizzled: a quarter warp's 16-byte loads read
// 128 contiguous bytes. int16 rows are 128 bytes with the 128-byte
// swizzle (chunk q of row r at chunk q ^ (r % 8)), so the two rows a
// quarter warp reads lie in different banks.
template <int BN, int W = 1>
struct SuffShape {
  static constexpr int ROWS = 128;
  static constexpr int A_ROW = kKBlock * W;  // bytes of a row's k-block
  static constexpr int CHUNKS = A_ROW / 16;
  static constexpr int A_MAT = ROWS * A_ROW;
  static constexpr int B_PLANE = kKBlock * BN * 2;
  static constexpr int B_BYTES = 3 * B_PLANE;
  static constexpr int STAGE = B_BYTES + 2 * A_MAT;
  static constexpr int STAGES = ring_stages(STAGE);
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + kSmemAlign;
  static_assert(STAGE % kSmemAlign == 0, "stages keep the alignment");
  static_assert(B_PLANE % kSmemAlign == 0, "planes keep the alignment");
  static_assert(STAGES >= 2, "a ring needs two stages");
  // where chunk q of row r lies in its row
  __device__ static __forceinline__ int chunk(int q, int r) {
    return W == 1 ? q : q ^ (r & 7);
  }
};

// One matrix's A fragments of a k-block: 16 bytes of each of the
// thread's rows (lo: row g, hi: row g + 8 of its warp's 16) hold its 16 k
// values in B's k order: word s has k 2c, 2c + 1 (bytes 0, 1) and
// 2c + 8, 2c + 9 (bytes 2, 3) of k16 step s.
__device__ __forceinline__ void suff_frags(uint32_t (&f)[4][4], uint4 lo,
                                           uint4 hi) {
  const uint32_t l[4] = {lo.x, lo.y, lo.z, lo.w};
  const uint32_t h[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    f[s][0] = pair_of(l[s], 0x4140);
    f[s][1] = pair_of(h[s], 0x4140);
    f[s][2] = pair_of(l[s], 0x4342);
    f[s][3] = pair_of(h[s], 0x4342);
  }
}

// The 32 bytes of a thread's int16 row r (chunks 2c, 2c + 1) in a stage's
// matrix `a`; their OR into `any`.
__device__ __forceinline__ void suff_row16(uint4 (&x)[2], const uint8_t* a,
                                           int r, int c, uint32_t& any) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    x[j] = *reinterpret_cast<const uint4*>(
        a + r * 128 + 16 * ((2 * c + j) ^ (r & 7)));
    any |= x[j].x | x[j].y | x[j].z | x[j].w;
  }
}

// suff_frags from int16 counts, one plane: 32 bytes of each row (two
// 16-byte chunks) of the stage's matrix `a` hold the thread's 16 k values
// in B's k order, word 2 s + h holding k 2c + 8h, 2c + 8h + 1 of k16 step
// s. The words' OR goes into `any`.
template <int kPlane>
__device__ __forceinline__ void suff_frags16(uint32_t (&f)[4][4],
                                             const uint8_t* a, int r_lo,
                                             int r_hi, int c,
                                             uint32_t& any) {
  uint4 lo[2], hi[2];
  suff_row16(lo, a, r_lo, c, any);
  suff_row16(hi, a, r_hi, c, any);
  const uint32_t l[8] = {lo[0].x, lo[0].y, lo[0].z, lo[0].w,
                         lo[1].x, lo[1].y, lo[1].z, lo[1].w};
  const uint32_t h[8] = {hi[0].x, hi[0].y, hi[0].z, hi[0].w,
                         hi[1].x, hi[1].y, hi[1].z, hi[1].w};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    f[s][0] = plane_of<kPlane>(l[2 * s]);
    f[s][1] = plane_of<kPlane>(h[2 * s]);
    f[s][2] = plane_of<kPlane>(l[2 * s + 1]);
    f[s][3] = plane_of<kPlane>(h[2 * s + 1]);
  }
}

// The kernel's body for counts of W bytes (1: int8, 2: int16); `high`
// (int16, mode kFull) gets the k-blocks the warpgroups ran and those of
// them that ran the high plane.
template <int BN, int kMode, int W>
__device__ __forceinline__ void suff_body(
    const CUtensorMap& ad_map, const CUtensorMap& dp_map,
    const CUtensorMap& b_map, const Src& src, int tma, const Plan& plan,
    float* __restrict__ out0, float* __restrict__ out1,
    float* __restrict__ slices, unsigned long long* high) {
  using S = SuffShape<BN, W>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem = hopper::aligned_smem(smem_raw);
  __shared__ uint64_t full[S::STAGES], empty[S::STAGES];
  const int tid = threadIdx.x;
  // the warpgroup, read from lane 0 so the compiler knows it is uniform
  // across the warp (a branch it cannot see as uniform would serialise
  // the MMAs)
  const int wg = __shfl_sync(0xFFFFFFFFu, tid / 128, 0);
  const int lane = tid % 32;
  if (tid == 0)
    for (int i = 0; i < S::STAGES; ++i) {
      // TMA: the producer's one arrival with the bytes; else that one
      // (B's bytes) and one a lane after its stores
      hopper::mbar_init(&full[i], tma ? 1 : 33);
      hopper::mbar_init(&empty[i], kConsumers / 32);
    }
  __syncthreads();

  if (wg == kConsumers / 128) {
    // the producer warpgroup: its registers go to the consumers, and its
    // first warp (with TMA its first lane) keeps the ring full
    regs_down<kProducerRegs>();
    if (tid >= kConsumers + 32 || (tma && lane != 0)) return;
    long long it = 0;
    for (long long u = blockIdx.x; u < plan.units; u += gridDim.x) {
      int mt, nt, sl, t0, t1;
      plan.unit(u, mt, nt, sl, t0, t1);
      const int row0 = mt * S::ROWS;
      for (int t = t0; t < t1; ++t, ++it) {
        const int slot = (int)(it % S::STAGES);
        hopper::mbar_wait(&empty[slot], ((it / S::STAGES) & 1) ^ 1);
        uint8_t* st = smem + (size_t)slot * S::STAGE;
        if (lane == 0) {
          hopper::mbar_expect_tx(&full[slot], tma ? S::STAGE : S::B_BYTES);
#pragma unroll
          for (int p = 0; p < 3; ++p)
            hopper::tma_load(st + p * S::B_PLANE, &b_map, &full[slot],
                             t * kKBlock, nt * BN, p);
          if (tma) {
            hopper::tma_load_2d(st + S::B_BYTES, &ad_map, &full[slot],
                                t * kKBlock, row0);
            hopper::tma_load_2d(st + S::B_BYTES + S::A_MAT, &dp_map,
                                &full[slot], t * kKBlock, row0);
          }
        }
        if (!tma) {
          for (int i = lane; i < 2 * S::ROWS * S::CHUNKS; i += 32) {
            const int m = i / (S::ROWS * S::CHUNKS);
            const int r = (i / S::CHUNKS) % S::ROWS;
            const int q = i % S::CHUNKS;
            const long long row = (long long)row0 + r;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (row < src.rows)
              v = gather16((m ? src.dp : src.ad) + row * src.pitch, src.len,
                           (long long)t * S::A_ROW + 16 * q);
            *reinterpret_cast<uint4*>(st + S::B_BYTES + m * S::A_MAT +
                                      r * S::A_ROW + 16 * S::chunk(q, r)) = v;
          }
          hopper::mbar_arrive(&full[slot], true);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns variants 64 wg .. 64 wg + 63 of a unit
  regs_up<kConsumerRegs>();
  const int warp = (tid % 128) / 32;
  const int g = lane / 4, c = lane % 4;
  const int r_lo = wg * 64 + warp * 16 + g, r_hi = r_lo + 8;
  // part: a k-block's sums of each matrix, formed by the tensor cores;
  // acc: a slice's sums, added to in float32 on the CUDA cores
  float acc[2][BN / 2], part[2][BN / 2];
  uint32_t fr[2][4][4];
  uint32_t fold = 0;
  // int16: the warpgroup's k-blocks, and those that ran the high plane
  uint32_t k_blocks = 0, high_blocks = 0;
  long long it = 0;
  for (long long u = blockIdx.x; u < plan.units; u += gridDim.x) {
    int mt, nt, sl, t0, t1;
    plan.unit(u, mt, nt, sl, t0, t1);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[m][i] = part[m][i] = 0.f;
    int prev = 0;
    for (int t = t0; t < t1; ++t, ++it) {
      const int slot = (int)(it % S::STAGES);
      hopper::mbar_wait(&full[slot], (it / S::STAGES) & 1);
      const uint8_t* st = smem + (size_t)slot * S::STAGE;
      const uint8_t* a = st + S::B_BYTES;
      if constexpr (W == 1) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const uint4 lo = *reinterpret_cast<const uint4*>(
              a + m * S::A_MAT + r_lo * kKBlock + 16 * c);
          const uint4 hi = *reinterpret_cast<const uint4*>(
              a + m * S::A_MAT + r_hi * kKBlock + 16 * c);
          if constexpr (kMode == kNoMma) {
            suff_frags(fr[m], lo, hi);
#pragma unroll
            for (int s = 0; s < 4; ++s)
              fold ^= fr[m][s][0] ^ fr[m][s][1] ^ fr[m][s][2] ^ fr[m][s][3];
          } else {
            // matrix m's MMAs of the k-block before are done (the other
            // matrix's may still run): add its sums (0 at a unit's start)
            hopper::wgmma_wait<1>();
            hopper::fence_regs(part[m]);
            if constexpr (kMode == kFull) {
#pragma unroll
              for (int i = 0; i < BN / 2; ++i) acc[m][i] += part[m][i];
            }
            // after both matrices: the k-block before no longer reads its
            // slot
            if (m == 1)
              hopper::mbar_arrive(&empty[prev], t > t0 && lane == 0);
            suff_frags(fr[m], lo, hi);
            hopper::fence_regs(part[m]);
            hopper::wgmma_fence();
#pragma unroll
            for (int s = 0; s < 4; ++s)
#pragma unroll
              for (int p = 0; p < 3; ++p)
                hopper::wgmma_rs<BN>(part[m], fr[m][s],
                                     hopper::b_desc<BN, kKBlock>(st, p, s),
                                     s > 0 || p > 0 || kMode == kNoFold);
            hopper::wgmma_commit();
          }
        }
      } else {
        // int16: the low plane's two groups, then the high plane's two,
        // into the same sums by the same B terms, every k-block; the
        // high plane's MMAs only where the warpgroup's rows of either
        // matrix hold a count above 127 (its groups empty elsewhere), so
        // each build of fr[m] follows the group before the one before
        // it, as in int8's k-blocks
        uint32_t any = 0;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if constexpr (kMode == kNoMma) {
            suff_frags16<0>(fr[m], a + m * S::A_MAT, r_lo, r_hi, c, any);
#pragma unroll
            for (int s = 0; s < 4; ++s)
              fold ^= fr[m][s][0] ^ fr[m][s][1] ^ fr[m][s][2] ^ fr[m][s][3];
          } else {
            hopper::wgmma_wait<1>();
            hopper::fence_regs(part[m]);
            if constexpr (kMode == kFull) {
#pragma unroll
              for (int i = 0; i < BN / 2; ++i) acc[m][i] += part[m][i];
            }
            if (m == 1)
              hopper::mbar_arrive(&empty[prev], t > t0 && lane == 0);
            suff_frags16<0>(fr[m], a + m * S::A_MAT, r_lo, r_hi, c, any);
            hopper::fence_regs(part[m]);
            hopper::wgmma_fence();
#pragma unroll
            for (int s = 0; s < 4; ++s)
#pragma unroll
              for (int p = 0; p < 3; ++p)
                hopper::wgmma_rs<BN>(part[m], fr[m][s],
                                     hopper::b_desc<BN, kKBlock>(st, p, s),
                                     s > 0 || p > 0 || kMode == kNoFold);
            hopper::wgmma_commit();
          }
        }
        const bool hot = warpgroup_any((any & kOver127) != 0, wg);
        k_blocks += 1;
        high_blocks += hot;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t seen = 0;
          if constexpr (kMode == kNoMma) {
            if (hot) {
              suff_frags16<1>(fr[m], a + m * S::A_MAT, r_lo, r_hi, c, seen);
#pragma unroll
              for (int s = 0; s < 4; ++s)
                fold ^= fr[m][s][0] ^ fr[m][s][1] ^ fr[m][s][2] ^ fr[m][s][3];
            }
          } else {
            hopper::wgmma_wait<1>();
            if (hot)
              suff_frags16<1>(fr[m], a + m * S::A_MAT, r_lo, r_hi, c, seen);
            hopper::fence_regs(part[m]);
            hopper::wgmma_fence();
            if (hot) {
#pragma unroll
              for (int s = 0; s < 4; ++s)
#pragma unroll
                for (int p = 0; p < 3; ++p)
                  hopper::wgmma_rs<BN>(part[m], fr[m][s],
                                       hopper::b_desc<BN, kKBlock>(st, p, s),
                                       1);
            }
            hopper::wgmma_commit();
          }
        }
      }
      if constexpr (kMode == kNoMma) {
        __syncwarp();
        hopper::mbar_arrive(&empty[slot], lane == 0);
      }
      prev = slot;
    }
    if constexpr (kMode != kNoMma) {  // the unit's last k-block
      hopper::wgmma_wait<1>();
      hopper::fence_regs(part[0]);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(part[1]);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          acc[m][i] = kMode == kFull ? acc[m][i] + part[m][i] : part[m][i];
      hopper::mbar_arrive(&empty[prev], lane == 0);
    } else {
      acc[0][0] = __uint_as_float(fold);
    }
    const long long vn = (long long)plan.m_len * plan.N;
    float* dst[2] = {out0, out1};
    if (plan.slices > 1) {
      dst[0] = slices + (2LL * sl) * vn;
      dst[1] = dst[0] + vn;
    }
    const long long row0 = (long long)mt * S::ROWS;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const long long v = row0 + (((i >> 1) & 1) ? r_hi : r_lo);
        const int n = nt * BN + 8 * (i >> 2) + 2 * c + (i & 1);
        if (v < plan.m_len && n < plan.N) dst[m][v * plan.N + n] = acc[m][i];
      }
  }
  if constexpr (W == 2)
    if (high != nullptr && tid % 128 == 0) {
      atomicAdd(high, (unsigned long long)k_blocks);
      atomicAdd(high + 1, (unsigned long long)high_blocks);
    }
}

template <int BN, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    k0_suff_kernel(const __grid_constant__ CUtensorMap ad_map,
                   const __grid_constant__ CUtensorMap dp_map,
                   const __grid_constant__ CUtensorMap b_map, Src src,
                   int tma, Plan plan, float* __restrict__ out0,
                   float* __restrict__ out1, float* __restrict__ slices) {
  suff_body<BN, kMode, 1>(ad_map, dp_map, b_map, src, tma, plan, out0, out1,
                          slices, nullptr);
}

template <int BN, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    k0_suff_kernel16(const __grid_constant__ CUtensorMap ad_map,
                     const __grid_constant__ CUtensorMap dp_map,
                     const __grid_constant__ CUtensorMap b_map, Src src,
                     int tma, Plan plan, float* __restrict__ out0,
                     float* __restrict__ out1, float* __restrict__ slices,
                     unsigned long long* high) {
  suff_body<BN, kMode, 2>(ad_map, dp_map, b_map, src, tma, plan, out0, out1,
                          slices, high);
}

// ---------------------------------------------------------------------
// cell_loglik: out = AD^T Wa + DP^T Wd, cells as M. A block's unit is 256
// cells (128 a consumer warpgroup, two m64 tiles) x BN columns x one
// slice of k-blocks of 64 variants. A k-block takes two stages, one a
// count matrix m: B's three planes of that matrix's weights (plane 3 m + p
// of the operand), then the matrix's 64 variant rows x 256 cells as two
// TMA boxes of 128 cells (one a warpgroup), 128-byte swizzle: the
// 16-byte chunk q of row r at chunk q ^ (r % 8), so the four rows a k
// pair's lanes read lie in four different bank groups. (Stages of one
// matrix are half as large, so the ring holds five at 64 columns where
// whole k-blocks fit only twice.) int16 counts: four boxes of 64 cells
// (128 bytes a row), two a warpgroup.
template <int BN, int W = 1>
struct LoglikShape {
  static constexpr int CELLS = 256;
  static constexpr int BOX_CELLS = 128 / W;  // a box row is 128 bytes
  static constexpr int A_BOX = kKBlock * 128;
  static constexpr int A_MAT = 2 * W * A_BOX;
  static constexpr int B_PLANE = kKBlock * BN * 2;
  static constexpr int B_BYTES = 3 * B_PLANE;
  static constexpr int STAGE = B_BYTES + A_MAT;
  static constexpr int STAGES = ring_stages(STAGE);
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + kSmemAlign;
  static_assert(STAGE % kSmemAlign == 0, "stages keep the alignment");
  static_assert(B_PLANE % kSmemAlign == 0, "planes keep the alignment");
  // a k-block's two stages are waited for together, and the k-block
  // before releases its two only after both its tiles' MMAs are done
  static_assert(STAGES >= 4, "the ring holds two k-blocks");
};

// Tile mt's A fragments of both matrices for a k-block. Thread (warp w,
// row g, column c) owns cells 4 g + q of its warp's 32 (q = 2 mt for
// fragment row g, 2 mt + 1 for row g + 8), so one 2-byte load of variant
// row r gives both; k values (variants) 16 s + 8 h + 2 c + e are rows
// of the stage in order. box[m]: the warpgroup's box of matrix m.
__device__ __forceinline__ void loglik_frags(uint32_t (&f)[2][4][4],
                                             const uint8_t* const (&box)[2],
                                             int chunk, int word, int c,
                                             int mt) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * s + 8 * h + 2 * c;
        const uint8_t* b = box[m] + 2 * mt + 4 * word;
        const uint32_t u0 = *reinterpret_cast<const uint16_t*>(
            b + r * 128 + 16 * (chunk ^ (r & 7)));
        const uint32_t u1 = *reinterpret_cast<const uint16_t*>(
            b + (r + 1) * 128 + 16 * (chunk ^ ((r + 1) & 7)));
        // (row g of r, row g + 8 of r, row g of r + 1, row g + 8 of r + 1)
        const uint32_t x = __byte_perm(u0, u1, 0x5410);
        f[m][s][2 * h] = pair_of(x, 0x4240);
        f[m][s][2 * h + 1] = pair_of(x, 0x4341);
      }
}

// Four 8 x 8 tiles of 16-bit values from shared memory, transposed
// (ldmatrix): lane l gives the address of row l % 8 of tile l / 8, and
// register q of lane (g, c) holds rows 2c, 2c + 1 of tile q's column g.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const uint8_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_addr(p))
      : "memory");
}

// cell_loglik's A fragments of both matrices for a k-block from int16
// counts, one plane. Cells are not permuted: tile mt of warpgroup wg is
// box 2 wg + mt (64 cells, 128 bytes a variant row), box[m] for matrix m,
// its fragment rows g and g + 8 of warp w are cells 16 w + g and 16 w + g
// + 8, 16-byte chunks 2w and 2w + 1 of each row. Per k16 step one
// transposed ldmatrix gives A's four registers: tile q at chunk 2w + (q &
// 1), variant rows 16 s + 8 (q >> 1) + 0..7, so each register holds one
// cell's two counts at k 2c, 2c + 1 (the lower k in the low half); each
// of its tiles' 8 rows lies in another bank group (the swizzle). The
// words' OR goes into `any`.
template <int kPlane>
__device__ __forceinline__ void loglik_frags16(uint32_t (&f)[2][4][4],
                                               const uint8_t* const (&box)[2],
                                               int warp, int lane,
                                               uint32_t& any) {
  const int q = lane >> 3, j = lane & 7;
  const int chunk = 2 * warp + (q & 1);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k = 16 * s + 8 * (q >> 1) + j;  // k % 8 == j
      uint32_t r[4];
      ldsm_x4_trans(r, box[m] + k * 128 + 16 * (chunk ^ j));
      any |= r[0] | r[1] | r[2] | r[3];
#pragma unroll
      for (int i = 0; i < 4; ++i) f[m][s][i] = plane_of<kPlane>(r[i]);
    }
}

// The kernel's body for counts of W bytes, as suff_body's.
template <int BN, int kMode, int W>
__device__ __forceinline__ void loglik_body(
    const CUtensorMap& ad_map, const CUtensorMap& dp_map,
    const CUtensorMap& b_map, const Src& src, int tma, const Plan& plan,
    float* __restrict__ out, float* __restrict__ slices,
    unsigned long long* high) {
  using S = LoglikShape<BN, W>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem = hopper::aligned_smem(smem_raw);
  __shared__ uint64_t full[S::STAGES], empty[S::STAGES];
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xFFFFFFFFu, tid / 128, 0);
  const int lane = tid % 32;
  if (tid == 0)
    for (int i = 0; i < S::STAGES; ++i) {
      hopper::mbar_init(&full[i], tma ? 1 : 33);
      hopper::mbar_init(&empty[i], kConsumers / 32);
    }
  __syncthreads();

  if (wg == kConsumers / 128) {
    // the producer warpgroup: its registers go to the consumers, and its
    // first warp (with TMA its first lane) keeps the ring full
    regs_down<kProducerRegs>();
    if (tid >= kConsumers + 32 || (tma && lane != 0)) return;
    long long it = 0;
    for (long long u = blockIdx.x; u < plan.units; u += gridDim.x) {
      int mt, nt, sl, t0, t1;
      plan.unit(u, mt, nt, sl, t0, t1);
      const int cell0 = mt * S::CELLS;
      for (int t = t0; t < t1; ++t)
        for (int m = 0; m < 2; ++m, ++it) {
          const int slot = (int)(it % S::STAGES);
          hopper::mbar_wait(&empty[slot], ((it / S::STAGES) & 1) ^ 1);
          uint8_t* st = smem + (size_t)slot * S::STAGE;
          if (lane == 0) {
            hopper::mbar_expect_tx(&full[slot],
                                   tma ? S::STAGE : S::B_BYTES);
#pragma unroll
            for (int p = 0; p < 3; ++p)
              hopper::tma_load(st + p * S::B_PLANE, &b_map, &full[slot],
                               t * kKBlock, nt * BN, 3 * m + p);
            if (tma) {
#pragma unroll
              for (int h = 0; h < 2 * W; ++h)
                hopper::tma_load_2d(st + S::B_BYTES + h * S::A_BOX,
                                    m ? &dp_map : &ad_map, &full[slot],
                                    cell0 + S::BOX_CELLS * h, t * kKBlock);
            }
          }
          if (!tma) {
            const uint8_t* a = m ? src.dp : src.ad;
            for (int i = lane; i < kKBlock * 16 * W; i += 32) {
              const int r = i / (16 * W), q = i % (16 * W);
              const long long row = (long long)t * kKBlock + r;
              uint4 v = make_uint4(0u, 0u, 0u, 0u);
              if (row < src.rows)
                v = gather16(a + row * src.pitch, src.len,
                             (long long)cell0 * W + 16 * q);
              *reinterpret_cast<uint4*>(st + S::B_BYTES + (q / 8) * S::A_BOX +
                                        r * 128 + 16 * ((q % 8) ^ (r & 7))) =
                  v;
            }
            hopper::mbar_arrive(&full[slot], true);
          }
        }
    }
    return;
  }

  regs_up<kConsumerRegs>();
  const int warp = (tid % 128) / 32;
  const int g = lane / 4, c = lane % 4;
  // int8: this thread's 4 cells, 4 bytes at 16-byte chunk `chunk` (before
  // the swizzle), word `word` of a row of its warpgroup's box
  const int chunk = 2 * warp + (g >> 2), word = g & 3;
  float acc[2][BN / 2], part[2][BN / 2];
  uint32_t fr[2][2][4][4];
  uint32_t fold = 0;
  // int16: the warpgroup's k-blocks, and those that ran the high plane
  uint32_t k_blocks = 0, high_blocks = 0;
  long long it = 0;
  for (long long u = blockIdx.x; u < plan.units; u += gridDim.x) {
    int mt_blk, nt, sl, t0, t1;
    plan.unit(u, mt_blk, nt, sl, t0, t1);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mt][i] = part[mt][i] = 0.f;
    int prev[2] = {0, 0};
    for (int t = t0; t < t1; ++t, it += 2) {
      // the k-block's stages: AD's, then DP's
      const int slot[2] = {(int)(it % S::STAGES), (int)((it + 1) % S::STAGES)};
      hopper::mbar_wait(&full[slot[0]], (it / S::STAGES) & 1);
      hopper::mbar_wait(&full[slot[1]], ((it + 1) / S::STAGES) & 1);
      const uint8_t* st[2] = {smem + (size_t)slot[0] * S::STAGE,
                              smem + (size_t)slot[1] * S::STAGE};
      const uint8_t* const box[2] = {st[0] + S::B_BYTES + wg * S::A_BOX,
                                     st[1] + S::B_BYTES + wg * S::A_BOX};
      if constexpr (W == 1) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if constexpr (kMode == kNoMma) {
            loglik_frags(fr[mt], box, chunk, word, c, mt);
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
              for (int s = 0; s < 4; ++s)
                fold ^= fr[mt][m][s][0] ^ fr[mt][m][s][1] ^ fr[mt][m][s][2] ^
                        fr[mt][m][s][3];
          } else {
            // tile mt's MMAs of the k-block before are done (the other
            // tile's may still run): add its sums (0 at a unit's start)
            hopper::wgmma_wait<1>();
            hopper::fence_regs(part[mt]);
            if constexpr (kMode == kFull) {
#pragma unroll
              for (int i = 0; i < BN / 2; ++i) acc[mt][i] += part[mt][i];
            }
            // after both tiles: the k-block before no longer reads its
            // stages
            if (mt == 1) {
              hopper::mbar_arrive(&empty[prev[0]], t > t0 && lane == 0);
              hopper::mbar_arrive(&empty[prev[1]], t > t0 && lane == 0);
            }
            loglik_frags(fr[mt], box, chunk, word, c, mt);
            hopper::fence_regs(part[mt]);
            hopper::wgmma_fence();
#pragma unroll
            for (int s = 0; s < 4; ++s)
#pragma unroll
              for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int p = 0; p < 3; ++p)
                  hopper::wgmma_rs<BN>(
                      part[mt], fr[mt][m][s],
                      hopper::b_desc<BN, kKBlock>(st[m], p, s),
                      s > 0 || m > 0 || p > 0 || kMode == kNoFold);
            hopper::wgmma_commit();
          }
        }
      } else {
        // int16: the low plane's two groups, then the high plane's two,
        // as suff_body's, the high plane's MMAs only where the
        // warpgroup's cells of either matrix hold a count above 127.
        // Tile mt is box 2 wg + mt of each matrix's stage.
        uint32_t any = 0;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint8_t* const tile[2] = {
              st[0] + S::B_BYTES + (2 * wg + mt) * S::A_BOX,
              st[1] + S::B_BYTES + (2 * wg + mt) * S::A_BOX};
          if constexpr (kMode == kNoMma) {
            loglik_frags16<0>(fr[mt], tile, warp, lane, any);
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
              for (int s = 0; s < 4; ++s)
                fold ^= fr[mt][m][s][0] ^ fr[mt][m][s][1] ^ fr[mt][m][s][2] ^
                        fr[mt][m][s][3];
          } else {
            hopper::wgmma_wait<1>();
            hopper::fence_regs(part[mt]);
            if constexpr (kMode == kFull) {
#pragma unroll
              for (int i = 0; i < BN / 2; ++i) acc[mt][i] += part[mt][i];
            }
            if (mt == 1) {
              hopper::mbar_arrive(&empty[prev[0]], t > t0 && lane == 0);
              hopper::mbar_arrive(&empty[prev[1]], t > t0 && lane == 0);
            }
            loglik_frags16<0>(fr[mt], tile, warp, lane, any);
            hopper::fence_regs(part[mt]);
            hopper::wgmma_fence();
#pragma unroll
            for (int s = 0; s < 4; ++s)
#pragma unroll
              for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int p = 0; p < 3; ++p)
                  hopper::wgmma_rs<BN>(
                      part[mt], fr[mt][m][s],
                      hopper::b_desc<BN, kKBlock>(st[m], p, s),
                      s > 0 || m > 0 || p > 0 || kMode == kNoFold);
            hopper::wgmma_commit();
          }
        }
        const bool hot = warpgroup_any((any & kOver127) != 0, wg);
        k_blocks += 1;
        high_blocks += hot;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint8_t* const tile[2] = {
              st[0] + S::B_BYTES + (2 * wg + mt) * S::A_BOX,
              st[1] + S::B_BYTES + (2 * wg + mt) * S::A_BOX};
          uint32_t seen = 0;
          if constexpr (kMode == kNoMma) {
            if (hot) {
              loglik_frags16<1>(fr[mt], tile, warp, lane, seen);
#pragma unroll
              for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int s = 0; s < 4; ++s)
                  fold ^= fr[mt][m][s][0] ^ fr[mt][m][s][1] ^
                          fr[mt][m][s][2] ^ fr[mt][m][s][3];
            }
          } else {
            hopper::wgmma_wait<1>();
            if (hot) loglik_frags16<1>(fr[mt], tile, warp, lane, seen);
            hopper::fence_regs(part[mt]);
            hopper::wgmma_fence();
            if (hot) {
#pragma unroll
              for (int s = 0; s < 4; ++s)
#pragma unroll
                for (int m = 0; m < 2; ++m)
#pragma unroll
                  for (int p = 0; p < 3; ++p)
                    hopper::wgmma_rs<BN>(
                        part[mt], fr[mt][m][s],
                        hopper::b_desc<BN, kKBlock>(st[m], p, s), 1);
            }
            hopper::wgmma_commit();
          }
        }
      }
      if constexpr (kMode == kNoMma) {
        __syncwarp();
        hopper::mbar_arrive(&empty[slot[0]], lane == 0);
        hopper::mbar_arrive(&empty[slot[1]], lane == 0);
      }
      prev[0] = slot[0];
      prev[1] = slot[1];
    }
    if constexpr (kMode != kNoMma) {
      hopper::wgmma_wait<1>();
      hopper::fence_regs(part[0]);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(part[1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          acc[mt][i] =
              kMode == kFull ? acc[mt][i] + part[mt][i] : part[mt][i];
      hopper::mbar_arrive(&empty[prev[0]], lane == 0);
      hopper::mbar_arrive(&empty[prev[1]], lane == 0);
    } else {
      acc[0][0] = __uint_as_float(fold);
    }
    float* dst = plan.slices > 1
                     ? slices + (long long)sl * plan.m_len * plan.N
                     : out;
    // int8: cell 4 g + 2 mt (+ 1 for fragment row g + 8) of the warp's 32;
    // int16: cell 16 warp + g (+ 8) of tile mt's 64
    const long long cell =
        W == 1 ? (long long)mt_blk * S::CELLS + 128 * wg + 32 * warp + 4 * g
               : (long long)mt_blk * S::CELLS + 128 * wg + 16 * warp + g;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const long long cl =
            W == 1 ? cell + 2 * mt + ((i >> 1) & 1)
                   : cell + 64 * mt + 8 * ((i >> 1) & 1);
        const int n = nt * BN + 8 * (i >> 2) + 2 * c + (i & 1);
        if (cl < plan.m_len && n < plan.N) dst[cl * plan.N + n] = acc[mt][i];
      }
  }
  if constexpr (W == 2)
    if (high != nullptr && tid % 128 == 0) {
      atomicAdd(high, (unsigned long long)k_blocks);
      atomicAdd(high + 1, (unsigned long long)high_blocks);
    }
}

template <int BN, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    k0_loglik_kernel(const __grid_constant__ CUtensorMap ad_map,
                     const __grid_constant__ CUtensorMap dp_map,
                     const __grid_constant__ CUtensorMap b_map, Src src,
                     int tma, Plan plan, float* __restrict__ out,
                     float* __restrict__ slices) {
  loglik_body<BN, kMode, 1>(ad_map, dp_map, b_map, src, tma, plan, out,
                            slices, nullptr);
}

template <int BN, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    k0_loglik_kernel16(const __grid_constant__ CUtensorMap ad_map,
                       const __grid_constant__ CUtensorMap dp_map,
                       const __grid_constant__ CUtensorMap b_map, Src src,
                       int tma, Plan plan, float* __restrict__ out,
                       float* __restrict__ slices,
                       unsigned long long* high) {
  loglik_body<BN, kMode, 2>(ad_map, dp_map, b_map, src, tma, plan, out,
                            slices, high);
}

// The B operand (ops/counts.py::k0_operand, whose layout this kernel
// writes): B[3 i + p, n, j] = term p of W_i[k(j), n], the three bf16
// terms of split_bf16x3 (hi = W rounded to bf16, mid = (W - hi) rounded,
// lo = (W - hi - mid) rounded; each difference exact in float32), 0 where
// k(j) >= K. k(j) = j for cell_loglik; for suff_stats the k order
// within each k-block of 64: k value L = 16 s + 8 h + 2 c + e is cell
// 16 c + 4 s + 2 h + e. W_i: (K, N) float32, row-major; B: (3 mats, N,
// ld) bf16. A block transposes a 32 x 32 tile through shared memory, so
// W is read and B written along their contiguous axes.
constexpr int kOperandTile = 32;

template <bool kPermute>
__global__ void __launch_bounds__(kOperandTile * 8)
    k0_operand_kernel(const float* __restrict__ w0,
                      const float* __restrict__ w1, int K, int N, int ld,
                      uint16_t* __restrict__ b) {
  __shared__ float tile[kOperandTile][kOperandTile + 1];
  const float* w = blockIdx.z ? w1 : w0;
  const int j0 = blockIdx.x * kOperandTile, n0 = blockIdx.y * kOperandTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int r = ty; r < kOperandTile; r += 8) {
    const int j = j0 + r, n = n0 + tx;
    int k = j;
    if (kPermute) {
      const int L = j & (kKBlock - 1);
      k = (j - L) + 16 * ((L >> 1) & 3) + 4 * (L >> 4) + 2 * ((L >> 3) & 1) +
          (L & 1);
    }
    tile[r][tx] = (k < K && n < N) ? w[(long long)k * N + n] : 0.f;
  }
  __syncthreads();
  for (int r = ty; r < kOperandTile; r += 8) {
    const int n = n0 + r, j = j0 + tx;
    if (n >= N || j >= ld) continue;
    const float x = tile[tx][r];
    const __nv_bfloat16 hi = __float2bfloat16_rn(x);
    const float rest = x - __bfloat162float(hi);
    const __nv_bfloat16 mid = __float2bfloat16_rn(rest);
    const __nv_bfloat16 lo = __float2bfloat16_rn(rest - __bfloat162float(mid));
    const long long plane = (long long)N * ld;
    uint16_t* o = b + 3 * blockIdx.z * plane + (long long)n * ld + j;
    o[0] = __bfloat16_as_ushort(hi);
    o[plane] = __bfloat16_as_ushort(mid);
    o[2 * plane] = __bfloat16_as_ushort(lo);
  }
}

// B for `mats` (1 or 2) weight matrices; ld a multiple of 8 and >= K.
cudaError_t operand(int which, const float* w0, const float* w1, int mats,
                    int K, int N, int ld, uint16_t* b, cudaStream_t s) {
  if (K <= 0 || N <= 0 || ld < K || ld % 8 != 0 || mats < 1 || mats > 2)
    return cudaErrorInvalidValue;
  const dim3 grid((ld + kOperandTile - 1) / kOperandTile,
                  (N + kOperandTile - 1) / kOperandTile, mats);
  const dim3 block(kOperandTile, 8);
  if (which == kSuff)
    k0_operand_kernel<true><<<grid, block, 0, s>>>(w0, w1, K, N, ld, b);
  else
    k0_operand_kernel<false><<<grid, block, 0, s>>>(w0, w1, K, N, ld, b);
  return cudaGetLastError();
}

// out[i] = part[i] + part[stride + i] + ... over `slices` slices, in
// slice order.
__global__ void k0_sum_slices(const float* __restrict__ part, int slices,
                              long long stride, long long n,
                              float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  for (int k = 1; k < slices; ++k) s += part[(long long)k * stride + i];
  out[i] = s;
}

cudaError_t sum_slices(const float* part, int slices, long long stride,
                       long long n, float* out, cudaStream_t s) {
  k0_sum_slices<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(part, slices,
                                                           stride, n, out);
  return cudaGetLastError();
}

// The tensor map of one count matrix: `rows` rows of `len` counts of
// `width` bytes (1: int8, 2: int16), `pitch` bytes apart, read in boxes
// of box_cols counts x box_rows rows; counts outside the matrix (past a
// row's len, past the last row) read as 0. False where TMA cannot
// address the rows (a start off 16 bytes, a pitch that is not a whole 16
// bytes) or the encoder refuses.
bool encode_counts(CUtensorMap* map, const void* a, long long rows,
                   long long len, long long pitch, int width, int box_cols,
                   int box_rows, CUtensorMapSwizzle swizzle) {
  const hopper::TensorMapEncoder encode = hopper::tensor_map_encoder();
  if (encode == nullptr || ((uintptr_t)a & 15) || pitch % 16 != 0 ||
      pitch < len * width)
    return false;
  const cuuint64_t dims[2] = {(cuuint64_t)len, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map,
                width == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                           : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                2, (void*)a, dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The plan the host computed, checked: the slices tile the k-blocks,
// each slice holding at least one.
bool make_plan(Plan* plan, int m_len, int k_len, int N, int bn, int rows,
               int slices, int slice_kb) {
  if (m_len <= 0 || k_len <= 0 || N <= 0 || bn <= 0 || slices <= 0 ||
      slice_kb <= 0)
    return false;
  plan->m_len = m_len;
  plan->N = N;
  plan->m_tiles = (m_len + rows - 1) / rows;
  plan->n_tiles = (N + bn - 1) / bn;
  plan->nkb = (k_len + kKBlock - 1) / kKBlock;
  plan->slice_kb = slice_kb;
  plan->slices = slices;
  plan->units = (long long)slices * plan->m_tiles * plan->n_tiles;
  return (long long)slices * slice_kb >= plan->nkb &&
         (long long)(slices - 1) * slice_kb < plan->nkb &&
         k_len <= 0x7FFFFFFF - kKBlock;
}

template <class Sh, class Kernel>
cudaError_t prepare(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::SMEM);
}

template <int BN, int kMode, int W>
cudaError_t launch_suff(const CUtensorMap& ad_map, const CUtensorMap& dp_map,
                        const CUtensorMap& b_map, const Src& src, int tma,
                        const Plan& plan, int grid, float* s1, float* ss,
                        float* part, unsigned long long* high,
                        cudaStream_t s) {
  using Sh = SuffShape<BN, W>;
  cudaError_t err;
  if constexpr (W == 1) {
    auto kernel = k0_suff_kernel<BN, kMode>;
    err = prepare<Sh>(kernel);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, Sh::SMEM, s>>>(ad_map, dp_map, b_map, src, tma,
                                            plan, s1, ss, part);
  } else {
    auto kernel = k0_suff_kernel16<BN, kMode>;
    err = prepare<Sh>(kernel);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, Sh::SMEM, s>>>(ad_map, dp_map, b_map, src, tma,
                                            plan, s1, ss, part, high);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || plan.slices == 1 || kMode != kFull) return err;
  const long long vn = (long long)plan.m_len * plan.N;
  err = sum_slices(part, plan.slices, 2 * vn, vn, s1, s);
  if (err != cudaSuccess) return err;
  return sum_slices(part + vn, plan.slices, 2 * vn, vn, ss, s);
}

template <int BN, int kMode, int W>
cudaError_t launch_loglik(const CUtensorMap& ad_map,
                          const CUtensorMap& dp_map,
                          const CUtensorMap& b_map, const Src& src, int tma,
                          const Plan& plan, int grid, float* out,
                          float* part, unsigned long long* high,
                          cudaStream_t s) {
  using Sh = LoglikShape<BN, W>;
  cudaError_t err;
  if constexpr (W == 1) {
    auto kernel = k0_loglik_kernel<BN, kMode>;
    err = prepare<Sh>(kernel);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, Sh::SMEM, s>>>(ad_map, dp_map, b_map, src, tma,
                                            plan, out, part);
  } else {
    auto kernel = k0_loglik_kernel16<BN, kMode>;
    err = prepare<Sh>(kernel);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, Sh::SMEM, s>>>(ad_map, dp_map, b_map, src, tma,
                                            plan, out, part, high);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || plan.slices == 1 || kMode != kFull) return err;
  const long long cn = (long long)plan.m_len * plan.N;
  return sum_slices(part, plan.slices, cn, cn, out, s);
}

// Each kernel's tile widths; the host's plan picks one
// (ops/counts.py::K0_TILES, K0_TILES_INT16). The int16 kernels stop at
// 48 columns: wider, their consumers spill and ran 1.5-3x slower on an
// H100.
#define K0_SUFF_WIDTHS(X) X(16) X(32) X(48) X(64) X(80)
#define K0_LOGLIK_WIDTHS(X) X(16) X(32) X(48) X(64)
#define K0_INT16_WIDTHS(X) X(16) X(32) X(48)

template <int kMode, int W>
cudaError_t suff_any(int bn, const CUtensorMap& ad_map,
                     const CUtensorMap& dp_map, const CUtensorMap& b_map,
                     const Src& src, int tma, const Plan& plan, int grid,
                     float* s1, float* ss, float* part,
                     unsigned long long* high, cudaStream_t s) {
#define K0_CASE(BN)                                                       \
  case BN:                                                                \
    return launch_suff<BN, kMode, W>(ad_map, dp_map, b_map, src, tma,     \
                                     plan, grid, s1, ss, part, high, s);
  if constexpr (W == 1) {
    switch (bn) { K0_SUFF_WIDTHS(K0_CASE) }
  } else {
    switch (bn) { K0_INT16_WIDTHS(K0_CASE) }
  }
#undef K0_CASE
  return cudaErrorInvalidValue;
}

template <int kMode, int W>
cudaError_t loglik_any(int bn, const CUtensorMap& ad_map,
                       const CUtensorMap& dp_map, const CUtensorMap& b_map,
                       const Src& src, int tma, const Plan& plan, int grid,
                       float* out, float* part, unsigned long long* high,
                       cudaStream_t s) {
#define K0_CASE(BN)                                                       \
  case BN:                                                                \
    return launch_loglik<BN, kMode, W>(ad_map, dp_map, b_map, src, tma,   \
                                       plan, grid, out, part, high, s);
  if constexpr (W == 1) {
    switch (bn) { K0_LOGLIK_WIDTHS(K0_CASE) }
  } else {
    switch (bn) { K0_INT16_WIDTHS(K0_CASE) }
  }
#undef K0_CASE
  return cudaErrorInvalidValue;
}

// The launch of mode `mode` for counts of `width` bytes: fn<kMode, W>(...).
#define K0_DISPATCH(fn, mode, width, ...)                                  \
  ((width) == 1                                                          \
       ? ((mode) == kFull    ? fn<kFull, 1>(__VA_ARGS__)                  \
          : (mode) == kNoMma ? fn<kNoMma, 1>(__VA_ARGS__)                 \
                             : fn<kNoFold, 1>(__VA_ARGS__))               \
       : ((mode) == kFull    ? fn<kFull, 2>(__VA_ARGS__)                  \
          : (mode) == kNoMma ? fn<kNoMma, 2>(__VA_ARGS__)                 \
                             : fn<kNoFold, 2>(__VA_ARGS__)))

template <int BN>
using SuffShape16 = SuffShape<BN, 2>;
template <int BN>
using LoglikShape16 = LoglikShape<BN, 2>;

template <class Sh, class Kernel>
void shape_of(Kernel kernel, int* out) {
  out[0] = Sh::STAGES;
  out[1] = Sh::STAGE;
  out[2] = kThreads;
  out[3] = (int)Sh::SMEM;
  int blocks = 0;
  cudaFuncAttributes attr;
  if (prepare<Sh>(kernel) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                    kThreads, Sh::SMEM) !=
          cudaSuccess)
    blocks = 0;
  out[4] = blocks;
  if (cudaFuncGetAttributes(&attr, kernel) == cudaSuccess) {
    out[5] = attr.numRegs;
    out[6] = (int)attr.localSizeBytes;
  } else {
    out[5] = out[6] = -1;
  }
}

}  // namespace

extern "C" {

const char* vireo_dense_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// ad, dp: V rows of C counts of `width` bytes (1: int8 in [0, 127], 2:
// int16 in [0, 16383]), `pitch` >= C width bytes apart. w: (C, N)
// float32. b3: (3, N, ldb) bf16 scratch, written first with the three
// terms of W^T with the cells in K0's k order (k0_operand_kernel), ldb
// the cells rounded up to whole k-blocks. s1, ss: (V, N) float32.
// part: (slices, 2, V, N) float32 scratch where slices > 1. high (int16,
// mode 0; or null): two int64 counters, to which the launch adds the
// k-blocks its warpgroups ran and those that ran the high plane. The
// plan (ops/counts.py::k0_plan): column tile bn, `slices` slices of
// slice_kb k-blocks, `grid` blocks.
// tma: 1 to read the counts by TMA (both starts on 16 bytes, pitch a
// multiple of 16), 0 by the producer warp's loads. mode: 0, or a control
// (1 no MMA, 2 no adds of the k-block sums).
int vireo_dense_suff_stats(const void* ad, const void* dp, const void* w,
                           void* b3, void* s1, void* ss, void* part, int V,
                           int C, int N, int ldb, int width, void* high,
                           long long pitch, int bn, int slices, int slice_kb,
                           int grid, int tma, int mode, void* stream) {
  Plan plan;
  if ((width != 1 && width != 2) || mode < kFull || mode > kNoFold ||
      pitch < (long long)C * width || ldb % kKBlock != 0 || ldb < C ||
      grid <= 0 ||
      !make_plan(&plan, V, C, N, bn, SuffShape<16>::ROWS, slices,
                 slice_kb) ||
      (slices > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  // int8 rows of 64 bytes as they lie; int16 rows of 128 swizzled
  const CUtensorMapSwizzle swizzle =
      width == 1 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap ad_map = {}, dp_map = {}, b_map;
  if (!hopper::encode_b(&b_map, b3, 3, N, ldb, ldb, bn) ||
      (tma && (!encode_counts(&ad_map, ad, V, C, pitch, width, kKBlock,
                              SuffShape<16>::ROWS, swizzle) ||
               !encode_counts(&dp_map, dp, V, C, pitch, width, kKBlock,
                              SuffShape<16>::ROWS, swizzle))))
    return (int)cudaErrorInvalidValue;
  const Src src = {(const uint8_t*)ad, (const uint8_t*)dp, pitch, V,
                   (long long)C * width};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = operand(kSuff, (const float*)w, nullptr, 1, C, N, ldb,
                            (uint16_t*)b3, s);
  if (err != cudaSuccess) return (int)err;
  return (int)K0_DISPATCH(suff_any, mode, width, bn, ad_map, dp_map, b_map,
                          src, tma, plan, grid, (float*)s1, (float*)ss,
                          (float*)part, (unsigned long long*)high, s);
}

// ad, dp: as above. wa, wd: (V, N) float32. b6: (6, N, ldv) bf16
// scratch, written first with the three terms of Wa^T, then of Wd^T,
// variants contiguous (k0_operand_kernel; split_weights_kmajor's
// layout), ldv >= V a multiple of 8. out: (C, N) float32. part: (slices, C, N)
// float32 scratch where slices > 1. The rest as for suff_stats.
int vireo_dense_cell_loglik(const void* ad, const void* dp, const void* wa,
                            const void* wd, void* b6, void* out, void* part,
                            int V, int C, int N, int ldv, int width,
                            void* high, long long pitch, int bn, int slices,
                            int slice_kb, int grid, int tma, int mode,
                            void* stream) {
  Plan plan;
  if ((width != 1 && width != 2) || mode < kFull || mode > kNoFold ||
      pitch < (long long)C * width || grid <= 0 ||
      !make_plan(&plan, C, V, N, bn, LoglikShape<16>::CELLS, slices,
                 slice_kb) ||
      (slices > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  // boxes of 128 bytes a row: 128 int8 cells or 64 int16 ones
  CUtensorMap ad_map = {}, dp_map = {}, b_map;
  if (!hopper::encode_b(&b_map, b6, 6, N, V, ldv, bn) ||
      (tma && (!encode_counts(&ad_map, ad, V, C, pitch, width, 128 / width,
                              kKBlock, CU_TENSOR_MAP_SWIZZLE_128B) ||
               !encode_counts(&dp_map, dp, V, C, pitch, width, 128 / width,
                              kKBlock, CU_TENSOR_MAP_SWIZZLE_128B))))
    return (int)cudaErrorInvalidValue;
  const Src src = {(const uint8_t*)ad, (const uint8_t*)dp, pitch, V,
                   (long long)C * width};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = operand(kLoglik, (const float*)wa, (const float*)wd, 2,
                            V, N, ldv, (uint16_t*)b6, s);
  if (err != cudaSuccess) return (int)err;
  return (int)K0_DISPATCH(loglik_any, mode, width, bn, ad_map, dp_map,
                          b_map, src, tma, plan, grid, (float*)out,
                          (float*)part, (unsigned long long*)high, s);
}

// The B operand alone (which: 0 suff_stats from w0 (K, N), 1
// cell_loglik from w0 and w1), into b (3 or 6, N, ld) bf16.
int vireo_dense_operand(int which, const void* w0, const void* w1, int K,
                        int N, int ld, void* b, void* stream) {
  if (which != kSuff && which != kLoglik) return (int)cudaErrorInvalidValue;
  return (int)operand(which, (const float*)w0, (const float*)w1,
                      which == kSuff ? 1 : 2, K, N, ld, (uint16_t*)b,
                      (cudaStream_t)stream);
}

// A kernel's shape (which: 0 suff_stats, 1 cell_loglik; its tile bn;
// the counts' width in bytes, 1 or 2):
// out[0] stages in the ring, out[1] bytes a stage, out[2] threads a
// block, out[3] dynamic shared memory, out[4] blocks an SM (the
// occupancy API; 0 where it fails), out[5] registers a thread, out[6]
// local (spilled) bytes a thread (-1 where cudaFuncGetAttributes fails).
// Returns 0, or cudaErrorInvalidValue for an unknown kernel or width.
int vireo_dense_shape(int which, int bn, int width, int* out) {
#define K0_CASE(Shape, kernel, BN)                                        \
  case BN:                                                                \
    shape_of<Shape>(kernel<BN, kFull>, out);                              \
    return 0;
#define K0_SUFF8(BN) K0_CASE(SuffShape<BN>, k0_suff_kernel, BN)
#define K0_LOGLIK8(BN) K0_CASE(LoglikShape<BN>, k0_loglik_kernel, BN)
#define K0_SUFF16(BN) K0_CASE(SuffShape16<BN>, k0_suff_kernel16, BN)
#define K0_LOGLIK16(BN) K0_CASE(LoglikShape16<BN>, k0_loglik_kernel16, BN)
  if (which == kSuff && width == 1) {
    switch (bn) { K0_SUFF_WIDTHS(K0_SUFF8) }
  } else if (which == kLoglik && width == 1) {
    switch (bn) { K0_LOGLIK_WIDTHS(K0_LOGLIK8) }
  } else if (which == kSuff && width == 2) {
    switch (bn) { K0_INT16_WIDTHS(K0_SUFF16) }
  } else if (which == kLoglik && width == 2) {
    switch (bn) { K0_INT16_WIDTHS(K0_LOGLIK16) }
  }
#undef K0_SUFF8
#undef K0_LOGLIK8
#undef K0_SUFF16
#undef K0_LOGLIK16
#undef K0_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
