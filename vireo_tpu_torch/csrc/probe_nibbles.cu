// The nibble probes of benchmarks/ on Hopper: kernels A and B.
//
// Kernel A, `nibble_unpack<Variant>`, replaces the three bodies that
// benchmarks/unpack_probe.py launches through `run` (pl.pallas_call at
// unpack_probe.py:27): `k_int8_ops` (:43), `k_int32_ops` (:49) and
// `k_bitcast_int4` (:55). Each turns a byte of two 4-bit counts into two
// bf16 planes, lo = p & 15 and hi = p >> 4, by another instruction
// sequence:
//
//   kInt8Ops   the & and >> on the bytes themselves, four at a time in a
//              32-bit register (the byte lanes a TPU's int8 ops work on),
//              then one int -> bf16 conversion a value;
//   kInt32Ops  each byte widened to a 32-bit int first, then & and >>
//              and the same conversion;
//   kBitcast   bit reinterpretation: the nibble is put into the mantissa
//              of bf16 128.0 and 128 is subtracted (one fma.rn.bf16x2 for
//              two values): `hopper::bf16_pair`, the sequence K2 and K3
//              build their A fragments with, so this variant times it.
//
// What bounds A on an H100: bytes. It reads R C bytes and writes 4 R C
// (two bf16 planes), 7.5 GB at the main pool's packed AD (30000 x 50000
// bytes), 2.24 ms at 3.35 TB/s; a few integer operations a byte are far
// below the CUDA cores' rate. So each thread reads 8 bytes with one load
// and writes each plane's 8 values with one 16-byte store, and the three
// variants differ only in the registers between.
//
// Kernel B, `packed_mm_kernel<Codec>`, replaces the packed matmul of
// benchmarks/int4_micro.py (`packed_mm`, pl.pallas_call at :85, body
// `_packed_mm_kernel` :66-78) and the variants of
// benchmarks/pack_kernel_tune.py (`build`, pl.pallas_call at :87; bodies
// `make_kernel(unpack_base)`, `make_kernel(unpack_f32)` and
// `nounpack_kernel`): S = lo(P) We + hi(P) Wo for packed bytes P
// (V, ceil(C / 2)) in K2's layout (ops/packed.py) and one bf16 term of
// W, float32 sums, by one of three codecs, the ways each A register is
// built from the bytes:
//
//   nibble_int    K2's own arithmetic (hopper::Nibbles): & and >> on the
//                 byte, then bf16_pair (the TPU's `unpack_base`);
//   nibble_float  one widening conversion of the signed byte to float,
//                 256 added where it is negative, hi = floor(q / 16),
//                 lo = q - 16 hi, one conversion of the pair to bf16x2
//                 (`unpack_f32`);
//   raw_byte      no unpack (`nounpack`): each signed byte is one k value,
//                 times We only, over C / 2 k values. Wrong values, the
//                 same bytes read and half the MMAs: the control that
//                 separates the unpack from the memory traffic. Bytes span
//                 -128..127, where bf16_pair's 128 + n does not serve;
//                 each is converted exactly through float.
//
// What bounds B on an H100: bytes. At 30000 x 100000 @ 100000 x 16 it
// reads 1.5 GB of packed counts (0.449 ms at 3.35 TB/s) for 9.6e10 flop
// (0.097 ms at 989 TFLOP/s of dense bf16). The earlier B, K2's
// rows_kernel with one matrix, reached 27% of that: each block walked
// all of k in 32-byte steps of its rows, copied by every thread, with a
// block barrier and an MMA wait each step, and its 235 blocks sat two
// to an SM on 103 SMs and alone on 29. This design:
//
// - Deep stages by TMA. A stage is 128 bytes of each of a unit's 256
//   rows, one 2D TMA box with the 128-byte swizzle (32 KB), and the
//   KS = 256 cells (128 bytes for raw_byte) of B they meet, as 64-deep
//   boxes (8 or 4 KB). The ring holds 5 (nibbles) or 6 (raw_byte)
//   stages, ~200 KB, so a block keeps 160-192 KB of A in flight.
// - A producer warp. One thread waits on a slot's "empty" barrier and
//   starts its copies, reported to the slot's "full" barrier. Four
//   consumer warpgroups (64 rows each) wait on "full", build their A
//   fragments, run wgmma and arrive on "empty" (one arrival a warp) once
//   the MMAs that read the slot are done. No block barrier in the loop,
//   and no branch the compiler cannot see as uniform between the MMAs
//   (the warpgroup comes from lane 0, the arrivals are predicated),
//   which would make it serialise them. (Two warpgroups on 128-row
//   units took as long as the same ring without its MMAs on an H100:
//   too few warps built the fragments. PERF.md §6.)
// - A grid that fills the card. A unit is (256 rows, 16 columns, one
//   k-slice); the slices are whole stages, chosen with the grid by
//   nibbles.py's `mm_plan` so the units cover the SMs evenly. One
//   persistent block an SM walks its units in a fixed order, the ring
//   flowing on across units. Each unit writes its float32 sums to a
//   (slices, V, N) scratch, and `sum_slices_kernel` adds the slices in
//   order, so B gives the same bits from run to run.
// - Fragments from whole words. Each thread reads 32 contiguous bytes of
//   each of its two rows a stage (two 16-byte loads through the
//   swizzle's XOR, no bank conflicts) and builds its pairs from them.
//   That needs B's k values in the matching order: k value L of a stage
//   (L = 16 s + 8 h + 2 c + e: step s, register half h, lane column c,
//   element e) is cell (KS / 4) c + 4 s + 2 h + e of it, an order that
//   nibbles.py's `k_order` writes into B on the host.
// - K2's precision rule (the top of hopper_gemm.cuh): each 64-deep
//   k-block is summed apart on the tensor cores and added in float32 on
//   the CUDA cores, two sum sets alternating so that one k-block's adds
//   overlap the next one's MMAs.
//
// Interface: plain C entry points, loaded with ctypes. Each launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError()
// (or cudaErrorInvalidValue for shapes it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

using hopper::bf16_pair;

constexpr int kUnpackThreads = 256;
constexpr int kUnpackBytes = 8;  // bytes a thread

enum Unpack { kInt8Ops = 0, kInt32Ops = 1, kBitcast = 2 };

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two small ints as a bf16 pair by conversion, a in the low half.
__device__ __forceinline__ uint32_t cvt_pair(int a, int b) {
  return bits(__halves2bfloat162(__int2bfloat16_rn(a), __int2bfloat16_rn(b)));
}

// The four bytes of w as the lo pairs (bytes 0, 1 and 2, 3) and the hi
// pairs of the two planes.
template <int V>
__device__ __forceinline__ void unpack4(uint32_t w, uint32_t& lo01,
                                        uint32_t& lo23, uint32_t& hi01,
                                        uint32_t& hi23) {
  if constexpr (V == kInt8Ops) {
    const uint32_t l = w & 0x0F0F0F0Fu;         // every byte's low nibble
    const uint32_t h = (w >> 4) & 0x0F0F0F0Fu;  // every byte's high nibble
    lo01 = cvt_pair(l & 0xFF, (l >> 8) & 0xFF);
    lo23 = cvt_pair((l >> 16) & 0xFF, l >> 24);
    hi01 = cvt_pair(h & 0xFF, (h >> 8) & 0xFF);
    hi23 = cvt_pair((h >> 16) & 0xFF, h >> 24);
  } else if constexpr (V == kInt32Ops) {
    int q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = (int)(int8_t)(w >> (8 * i));
    lo01 = cvt_pair(q[0] & 15, q[1] & 15);
    lo23 = cvt_pair(q[2] & 15, q[3] & 15);
    hi01 = cvt_pair((q[0] >> 4) & 15, (q[1] >> 4) & 15);
    hi23 = cvt_pair((q[2] >> 4) & 15, (q[3] >> 4) & 15);
  } else {
    uint32_t b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = (w >> (8 * i)) & 0xFFu;
    lo01 = bf16_pair(b[0] & 0xFu, b[1] & 0xFu);
    lo23 = bf16_pair(b[2] & 0xFu, b[3] & 0xFu);
    hi01 = bf16_pair(b[0] >> 4, b[1] >> 4);
    hi23 = bf16_pair(b[2] >> 4, b[3] >> 4);
  }
}

// p: n bytes, 8-byte aligned; lo, hi: n bf16 each, 16-byte aligned.
template <int V>
__global__ void __launch_bounds__(kUnpackThreads)
    nibble_unpack_kernel(const uint8_t* __restrict__ p, long long n,
                         uint16_t* __restrict__ lo,
                         uint16_t* __restrict__ hi) {
  const long long b0 =
      ((long long)blockIdx.x * kUnpackThreads + threadIdx.x) * kUnpackBytes;
  if (b0 + kUnpackBytes <= n) {
    const uint2 w = *reinterpret_cast<const uint2*>(p + b0);
    uint4 l, h;
    unpack4<V>(w.x, l.x, l.y, h.x, h.y);
    unpack4<V>(w.y, l.z, l.w, h.z, h.w);
    *reinterpret_cast<uint4*>(lo + b0) = l;
    *reinterpret_cast<uint4*>(hi + b0) = h;
  } else {
    // the ragged end, a byte at a time, by the same sequence
    for (long long j = b0; j < n; ++j) {
      uint32_t l, l23, h, h23;
      unpack4<V>(p[j], l, l23, h, h23);
      lo[j] = (uint16_t)l;
      hi[j] = (uint16_t)h;
    }
  }
}

template <int V>
cudaError_t launch_unpack(const uint8_t* p, long long n, uint16_t* lo,
                          uint16_t* hi, cudaStream_t s) {
  const long long per_block = (long long)kUnpackThreads * kUnpackBytes;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  nibble_unpack_kernel<V><<<(unsigned)blocks, kUnpackThreads, 0, s>>>(
      p, n, lo, hi);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// Kernel B (see the file note). A unit is 256 rows x one 16-column tile
// x one k-slice; a stage is 128 bytes of each of the unit's rows (A, one
// TMA box) and the KS k values of B they meet (KS = 256 cells for the
// nibble codecs, 128 bytes for raw_byte).
constexpr int kMmRows = 256;         // rows of a unit: four warpgroups of 64
constexpr int kMmStageBytes = 128;   // bytes of each row a stage
constexpr int kMmN = 16;             // columns of a tile
constexpr int kMmConsumers = 512;    // four consumer warpgroups
constexpr int kMmThreads = kMmConsumers + 32;  // and one producer warp
constexpr int kMmA = kMmRows * kMmStageBytes;  // A bytes a stage, 32 KB
constexpr int kMmRing = 220 * 1024;  // bytes of stages a block may use

template <class C>
struct MmShape {
  static constexpr int KS = kMmStageBytes * C::kCellsPerByte;
  static constexpr int KBLOCKS = KS / hopper::kKBlock;  // 64-deep k-blocks
  static constexpr int B_BOX = hopper::kKBlock * kMmN * 2;  // 2 KB
  static constexpr int B_BYTES = KBLOCKS * B_BOX;
  static constexpr int STAGE = kMmA + B_BYTES;
  static constexpr int STAGES = kMmRing / STAGE;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + hopper::kSmemAlign;
  static_assert(STAGE % hopper::kSmemAlign == 0, "stages keep the alignment");
  static_assert(KBLOCKS % 2 == 0, "k-blocks alternate two sum sets");
};

// The codecs. Each thread holds 32 bytes of each of its two rows a stage
// as eight 32-bit words w, and `pair(w, j)` is the bf16 pair of k values
// j of its run: for the nibble codecs byte j (cells 2j, 2j + 1), for
// raw_byte bytes 2j and 2j + 1.
struct NibbleInt {  // hopper::Nibbles' arithmetic: & 15, >> 4, bf16_pair
  static constexpr int kCellsPerByte = 2;
  __device__ static __forceinline__ uint32_t pair(const uint32_t (&w)[8],
                                                  int j) {
    const uint32_t word = w[j >> 2];
    const uint32_t i = j & 3;
    // byte i of the word in byte 0, byte i of word >> 4 in byte 2: the
    // low nibble in the low half, the high nibble in the high half
    const uint32_t x = __byte_perm(word, word >> 4,
                                   i | (i << 4) | ((4 + i) << 8) |
                                       ((4 + i) << 12));
    return bf16_pair(x & 0xFu, (x >> 16) & 0xFu);
  }
};

struct NibbleFloat {
  static constexpr int kCellsPerByte = 2;
  __device__ static __forceinline__ uint32_t pair(const uint32_t (&w)[8],
                                                  int j) {
    float q = (float)(int8_t)(w[j >> 2] >> (8 * (j & 3)));
    q = q < 0.f ? q + 256.f : q;
    const float h = floorf(q * 0.0625f);
    return bits(__floats2bfloat162_rn(fmaf(-16.f, h, q), h));
  }
};

struct RawByte {
  static constexpr int kCellsPerByte = 1;
  __device__ static __forceinline__ uint32_t pair(const uint32_t (&w)[8],
                                                  int j) {
    const uint32_t half = w[j >> 1] >> (16 * (j & 1));
    return bits(__floats2bfloat162_rn((float)(int8_t)half,
                                      (float)(int8_t)(half >> 8)));
  }
};

enum Codec { kNibbleInt = 0, kNibbleFloat = 1, kRawByte = 2 };

// The 16 bytes at chunks q and q + 1 of a swizzled A row, as words.
__device__ __forceinline__ void load_run(uint32_t (&w)[8], const uint8_t* a,
                                         int r, int q) {
  const uint4 x = *reinterpret_cast<const uint4*>(a + 128 * r +
                                                  16 * (q ^ (r & 7)));
  const uint4 y = *reinterpret_cast<const uint4*>(a + 128 * r +
                                                  16 * ((q + 1) ^ (r & 7)));
  w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
  w[4] = y.x, w[5] = y.y, w[6] = y.z, w[7] = y.w;
}

// Units in order: slice-major, then 256-row blocks, then column tiles;
// block b takes units b, b + gridDim.x, ... Both roles walk the same
// sequence of (unit, stage), so `it` counts the ring's slots alike.
struct MmPlan {
  int n_rows, n_tiles, n_stages, slice_stages;
  long long units, row_blocks;
  __device__ void unit(long long u, int& t0, int& t1, int& rb,
                       int& nt) const {
    const long long per_slice = row_blocks * n_tiles;
    const int sl = (int)(u / per_slice);
    const long long rest = u % per_slice;
    rb = (int)(rest / n_tiles);
    nt = (int)(rest % n_tiles);
    t0 = sl * slice_stages;
    t1 = min(t0 + slice_stages, n_stages);
  }
};

// kMma = false is the control: the same ring and fragment build with the
// MMAs left out (the fragments folded into one word a thread, so the
// build stays).
template <class C, bool kMma>
__global__ void __launch_bounds__(kMmThreads, 1)
    packed_mm_kernel(const __grid_constant__ CUtensorMap a_map,
                     const __grid_constant__ CUtensorMap b_map, MmPlan plan,
                     int N, float* __restrict__ part) {
  using S = MmShape<C>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem = hopper::aligned_smem(smem_raw);
  __shared__ uint64_t full[S::STAGES], empty[S::STAGES];
  const int tid = threadIdx.x;
  // the warpgroup, read from lane 0 so the compiler knows it is the same
  // across the warp (a branch it cannot see as uniform would serialise
  // the MMAs)
  const int wg = __shfl_sync(0xFFFFFFFFu, tid / 128, 0);
  if (tid == 0)
    for (int i = 0; i < S::STAGES; ++i) {
      hopper::mbar_init(&full[i]);
      hopper::mbar_init(&empty[i], kMmConsumers / 32);
    }
  __syncthreads();

  if (wg == kMmConsumers / 128) {  // the producer warp: one thread keeps
    if (tid != kMmConsumers) return;  // the ring full
    long long it = 0;
    for (long long u = blockIdx.x; u < plan.units; u += gridDim.x) {
      int t0, t1, rb, nt;
      plan.unit(u, t0, t1, rb, nt);
      for (int t = t0; t < t1; ++t, ++it) {
        const int slot = (int)(it % S::STAGES);
        hopper::mbar_wait(&empty[slot], ((it / S::STAGES) & 1) ^ 1);
        uint8_t* st = smem + (size_t)slot * S::STAGE;
        hopper::mbar_expect_tx(&full[slot], S::STAGE);
        hopper::tma_load_2d(st, &a_map, &full[slot], t * kMmStageBytes,
                            rb * kMmRows);
#pragma unroll
        for (int q = 0; q < S::KBLOCKS; ++q)
          hopper::tma_load(st + kMmA + q * S::B_BOX, &b_map, &full[slot],
                           t * S::KS + q * hopper::kKBlock, nt * kMmN, 0);
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of a unit
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int r_lo = wg * 64 + warp * 16 + g, r_hi = r_lo + 8;
  float acc[kMmN / 2], part_kb[2][kMmN / 2];
  uint32_t fold = 0;
  long long it = 0;
  for (long long u = blockIdx.x; u < plan.units; u += gridDim.x) {
    int t0, t1, rb, nt;
    plan.unit(u, t0, t1, rb, nt);
#pragma unroll
    for (int i = 0; i < kMmN / 2; ++i)
      acc[i] = part_kb[0][i] = part_kb[1][i] = 0.f;
    int prev_slot = 0;
    for (int t = t0; t < t1; ++t, ++it) {
      const int slot = (int)(it % S::STAGES);
      hopper::mbar_wait(&full[slot], (it / S::STAGES) & 1);
      const uint8_t* st = smem + (size_t)slot * S::STAGE;
      // this thread's run: bytes 32 c .. 32 c + 31 of each of its rows
      uint32_t wl[8], wh[8];
      load_run(wl, st, r_lo, 2 * c);
      load_run(wh, st, r_hi, 2 * c);
#pragma unroll
      for (int q = 0; q < S::KBLOCKS; ++q) {
        // k16 step s of the stage takes pairs 2s (k 2c, 2c + 1 of the
        // step) and 2s + 1 (k 2c + 8, 2c + 9) of the run
        uint32_t frag[4][4];
#pragma unroll
        for (int s4 = 0; s4 < 4; ++s4) {
          const int j = 2 * (4 * q + s4);
          frag[s4][0] = C::pair(wl, j);
          frag[s4][1] = C::pair(wh, j);
          frag[s4][2] = C::pair(wl, j + 1);
          frag[s4][3] = C::pair(wh, j + 1);
        }
        if constexpr (kMma) {
          float(&d)[kMmN / 2] = part_kb[q & 1];
          hopper::fence_regs(d);
          hopper::wgmma_fence();
#pragma unroll
          for (int s4 = 0; s4 < 4; ++s4)
            hopper::wgmma_rs<kMmN>(
                d, frag[s4],
                hopper::b_desc<kMmN, hopper::kKBlock>(st + kMmA, q, s4),
                s4 > 0);
          hopper::wgmma_commit();
          // the k-block before this one is done: add it on the CUDA
          // cores (zeros before a unit's first); when it was the last of
          // the stage before, that stage's slot is free
          hopper::wgmma_wait<1>();
          float(&e)[kMmN / 2] = part_kb[(q & 1) ^ 1];
          hopper::fence_regs(e);
#pragma unroll
          for (int i = 0; i < kMmN / 2; ++i) acc[i] += e[i];
          if (q == 0)
            hopper::mbar_arrive(&empty[prev_slot], t > t0 && lane == 0);
        } else {
#pragma unroll
          for (int s4 = 0; s4 < 4; ++s4)
            fold ^= frag[s4][0] ^ frag[s4][1] ^ frag[s4][2] ^ frag[s4][3];
        }
      }
      if constexpr (!kMma) {
        __syncwarp();
        hopper::mbar_arrive(&empty[slot], lane == 0);
      }
      prev_slot = slot;
    }
    if constexpr (kMma) {  // the unit's last k-block
      hopper::wgmma_wait<0>();
      float(&e)[kMmN / 2] = part_kb[(S::KBLOCKS - 1) & 1];
      hopper::fence_regs(e);
#pragma unroll
      for (int i = 0; i < kMmN / 2; ++i) acc[i] += e[i];
      hopper::mbar_arrive(&empty[prev_slot], lane == 0);
    } else {
      acc[0] = __uint_as_float(fold);
    }
    // this unit's (128, 16) sums into its slice of part (slices, V, N)
    const int sl = t0 / plan.slice_stages;
    const long long v0 = (long long)rb * kMmRows;
#pragma unroll
    for (int i = 0; i < kMmN / 2; ++i) {
      const long long v = v0 + (((i >> 1) & 1) ? r_hi : r_lo);
      const int n = nt * kMmN + 8 * (i >> 2) + 2 * c + (i & 1);
      if (v < plan.n_rows && n < N)
        part[((long long)sl * plan.n_rows + v) * N + n] = acc[i];
    }
  }
}

// out[i] = sum over slices s of part[s, i], s in order.
__global__ void sum_slices_kernel(const float* __restrict__ part, int slices,
                                  long long n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < slices; ++k) s += part[(long long)k * n + i];
  out[i] = s;
}

template <class C, bool kMma>
cudaError_t mm_attributes() {
  return cudaFuncSetAttribute(packed_mm_kernel<C, kMma>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)MmShape<C>::SMEM);
}

template <class C>
int mm_blocks_per_sm() {
  int n = 0;
  if (mm_attributes<C, true>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, packed_mm_kernel<C, true>, kMmThreads, MmShape<C>::SMEM) !=
          cudaSuccess)
    return 0;
  return n;
}

// p: (V, row_bytes) bytes, row_bytes a multiple of 16, 16-byte aligned.
// b: (N, n_stages KS) bf16, B^T in the kernel's k order (nibbles.py).
// part: (slices, V, N) float32; out: (V, N) float32 (not written by the
// control).
template <class C, bool kMma>
cudaError_t launch_mm(const uint8_t* p, long long row_bytes, int V,
                      const void* b, int N, int n_stages, int slice_stages,
                      int slices, int grid, float* part, float* out,
                      cudaStream_t s) {
  using Sh = MmShape<C>;
  MmPlan plan;
  plan.n_rows = V;
  plan.n_tiles = (N + kMmN - 1) / kMmN;
  plan.n_stages = n_stages;
  plan.slice_stages = slice_stages;
  plan.row_blocks = (V + kMmRows - 1) / kMmRows;
  plan.units = (long long)slices * plan.row_blocks * plan.n_tiles;
  // the slices must tile the stages, each slice holding at least one
  if (V <= 0 || N <= 0 || grid <= 0 || slice_stages <= 0 ||
      n_stages != (row_bytes + kMmStageBytes - 1) / kMmStageBytes ||
      (long long)slices * slice_stages < n_stages ||
      (long long)(slices - 1) * slice_stages >= n_stages ||
      (long long)n_stages * Sh::KS > 0x7FFFFFFF)
    return cudaErrorInvalidValue;
  CUtensorMap a_map, b_map;
  if (!hopper::encode_bytes(&a_map, p, V, row_bytes, kMmRows) ||
      !hopper::encode_b(&b_map, b, 1, N, (long long)n_stages * Sh::KS,
                        (long long)n_stages * Sh::KS, kMmN))
    return cudaErrorInvalidValue;
  cudaError_t err = mm_attributes<C, kMma>();
  if (err != cudaSuccess) return err;
  packed_mm_kernel<C, kMma><<<grid, kMmThreads, Sh::SMEM, s>>>(
      a_map, b_map, plan, N, part);
  err = cudaGetLastError();
  if (err != cudaSuccess || !kMma) return err;
  const long long n = (long long)V * N;
  sum_slices_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      part, slices, n, out);
  return cudaGetLastError();
}

template <bool kMma>
cudaError_t launch_codec(int codec, const uint8_t* p, long long row_bytes,
                         int V, const void* b, int N, int n_stages,
                         int slice_stages, int slices, int grid, float* part,
                         float* out, cudaStream_t s) {
  switch (codec) {
    case kNibbleInt:
      return launch_mm<NibbleInt, kMma>(p, row_bytes, V, b, N, n_stages,
                                        slice_stages, slices, grid, part,
                                        out, s);
    case kNibbleFloat:
      return launch_mm<NibbleFloat, kMma>(p, row_bytes, V, b, N, n_stages,
                                          slice_stages, slices, grid, part,
                                          out, s);
    case kRawByte:
      return launch_mm<RawByte, kMma>(p, row_bytes, V, b, N, n_stages,
                                      slice_stages, slices, grid, part, out,
                                      s);
  }
  return cudaErrorInvalidValue;
}

template <class C>
void mm_shape(int* out) {
  out[0] = MmShape<C>::KS;
  out[1] = MmShape<C>::STAGES;
  out[2] = MmShape<C>::STAGE;
  out[3] = kMmThreads;
  out[4] = mm_blocks_per_sm<C>();
}

}  // namespace

extern "C" {

const char* vireo_probe_nibbles_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// p: n bytes; lo, hi: n bf16 each. variant: 0 int8 ops, 1 int32 ops,
// 2 bitcast.
int vireo_probe_nibble_unpack(const void* p, long long n, void* lo, void* hi,
                              int variant, void* stream) {
  const uint8_t* src = (const uint8_t*)p;
  uint16_t *l = (uint16_t*)lo, *h = (uint16_t*)hi;
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || ((uintptr_t)p & 7) || ((uintptr_t)lo & 15) ||
      ((uintptr_t)hi & 15))
    return (int)cudaErrorInvalidValue;
  switch (variant) {
    case kInt8Ops: return (int)launch_unpack<kInt8Ops>(src, n, l, h, s);
    case kInt32Ops: return (int)launch_unpack<kInt32Ops>(src, n, l, h, s);
    case kBitcast: return (int)launch_unpack<kBitcast>(src, n, l, h, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Kernel B's shape for `codec`: out[0] k values a stage, out[1] stages
// in the ring, out[2] bytes a stage, out[3] threads a block, out[4]
// blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor; 0 where
// it fails). Returns 0, or cudaErrorInvalidValue for an unknown codec.
int vireo_probe_packed_mm_shape(int codec, int* out) {
  switch (codec) {
    case kNibbleInt: mm_shape<NibbleInt>(out); return 0;
    case kNibbleFloat: mm_shape<NibbleFloat>(out); return 0;
    case kRawByte: mm_shape<RawByte>(out); return 0;
  }
  return (int)cudaErrorInvalidValue;
}

// p: (V, row_bytes) bytes, row_bytes a multiple of 16, 16-byte aligned.
// b: (N, n_stages KS) bf16: B^T in the kernel's k order, zero past the
// contracted length (nibbles.py's `mm_weights`). The plan (nibbles.py's
// `mm_plan`): n_stages = ceil(row_bytes / 128), slices of slice_stages
// stages, `grid` blocks. part: (slices, V, N) float32 scratch; out: (V,
// N) float32.
int vireo_probe_packed_mm(const void* p, long long row_bytes, int V,
                          const void* b, int N, int n_stages,
                          int slice_stages, int slices, int grid, void* part,
                          void* out, int codec, void* stream) {
  return (int)launch_codec<true>(codec, (const uint8_t*)p, row_bytes, V, b,
                                 N, n_stages, slice_stages, slices, grid,
                                 (float*)part, (float*)out,
                                 (cudaStream_t)stream);
}

// The control: kernel B's ring and fragment build without the MMAs, on
// the same arguments; writes only part (a word a thread, no sums).
int vireo_probe_packed_mm_control(const void* p, long long row_bytes, int V,
                                  const void* b, int N, int n_stages,
                                  int slice_stages, int slices, int grid,
                                  void* part, int codec, void* stream) {
  return (int)launch_codec<false>(codec, (const uint8_t*)p, row_bytes, V, b,
                                  N, n_stages, slice_stages, slices, grid,
                                  (float*)part, nullptr,
                                  (cudaStream_t)stream);
}

}  // extern "C"
