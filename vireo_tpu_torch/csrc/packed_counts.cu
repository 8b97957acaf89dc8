// Contractions over nibble-packed counts: K2 and K3.
//
// Replaces the two TPU kernels of vireo_tpu/ops/packed.py:
//
//   K2  PackedCounts.suff_stats  (pl.pallas_call at packed.py:161, body
//       `_suff_kernel` at :67-88):  S1 = AD W,  SS = DP W
//   K3  PackedCounts.cell_loglik (pl.pallas_call at packed.py:195, body
//       `_loglik_kernel` at :98-121):  out = AD^T Wa + DP^T Wd
//
// Layout (vireo_tpu_torch/ops/packed.py): AD and DP are (V, Cb) uint8,
// Cb = ceil(C / 2), row-major and unpadded; byte [v, j] holds cell 2j in
// its low nibble and cell 2j + 1 in its high nibble. Offsets are 64-bit:
// one matrix may hold more than 2^31 bytes.
//
// K2 on the tensor cores. What bounds it on an H100: a packed byte
// carries 2 cells x N columns x 2 flop = 4N flop for each matrix, far
// past the ridge point of the CUDA cores (about 20 flop/byte), so the
// first, CUDA-core design ran at 28 of their 67 TFLOP/s. Nibbles are
// exact in bf16, but W is float32, so the wrapper splits it once per call
// into three bf16 terms, W = hi + mid + lo exactly (ops/packed.py,
// `split_bf16x3`), written transposed as (3, N, ldw), ldw = C rounded up
// to a multiple of 8 (TMA's 16-byte row stride):
// a nibble times a bf16 term is exact in float32, so the kernel forms
// exactly the products the plain version sums, and the tensor work
// triples (11.5 TFLOP at N = 320, C = 100000, V = 30000, against 989
// TFLOP/s of dense bf16). The tensor cores truncate into their float32
// accumulators at every k16 step, so the kernel sums each k-block of
// 64 cells there and adds it to float32 sums on the CUDA cores
// (kRowsMaxTile in hopper_gemm.cuh): on an H100, at N = 320 and dense
// random counts, 1.2 from the float64 sums where one sum on the tensor
// cores erred by 153 (cuBLAS's float32: 0.3). The kernel is
// `hopper::rows_kernel` (hopper_gemm.cuh) with the nibble codec: each
// packed byte is one A-fragment register (a bf16 pair of adjacent cells),
// converted in registers, so no float planes are staged; S1 and SS share
// each B tile. A block owns 128 variants x at most 80 columns; at
// N = 320 that is four column tiles, and each block pulls C x 80 x 3 x
// 2 B = 48 MB of split W through its ring, 45 GB in all, from L2: the
// blocks in flight walk the cells in step, so the 192 MB of split W is
// read from device memory about once per wave of blocks. The counts,
// 3 GB, are read from device memory about once and from L2 once per
// column tile. Measured on an H100 (PERF.md): with W copied by every
// thread's cp.async the kernel took 30 ms at N = 320, and its copies
// alone, the MMAs left out, 12.6 ms: 16-byte copies could not bring the
// split W in fast enough. W comes by TMA, one box per plane and stage:
// 21.2 ms with one sum on the tensor cores and 160-column tiles, 29.7 ms
// with the sums added per k-block. About 1.3 us of each k-block's time
// goes to work that does not overlap the MMAs (the A fragments, the
// barriers, the adds), which is why the narrower tiles cost time.
//
// K3 (`loglik_kernel`) is the first, CUDA-core design: a block owns 128
// cell pairs (bytes) x BN columns and loops over V in tiles of 16
// variants, staging unpacked float planes, Wa and Wd in shared memory;
// each thread keeps TA x TN even cells and TA x TN odd cells and writes
// cells 2j and 2j + 1 straight to cell order (the TPU's caller
// interleaves, packed.py:222). Its N tile is picked by N (16, 32 or 64
// columns). It is the next kernel to move to the tensor cores.
//
// No atomics: each output element belongs to one thread of one block and
// is summed in a fixed order, so results do not change between runs.
//
// Interface: plain C entry points, loaded with ctypes. Each launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError()
// (or cudaErrorInvalidValue for shapes it does not take).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsBlock = 128;   // bytes (cell pairs) a block
constexpr int kVarTile = 16;      // variants a tile

// T consecutive floats from shared memory, in 16- or 8-byte loads.
template <int T>
__device__ __forceinline__ void load_row(float (&dst)[T], const float* src) {
  if constexpr (T % 4 == 0) {
#pragma unroll
    for (int q = 0; q < T / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(src)[q];
      dst[4 * q] = x.x;
      dst[4 * q + 1] = x.y;
      dst[4 * q + 2] = x.z;
      dst[4 * q + 3] = x.w;
    }
  } else if constexpr (T % 2 == 0) {
#pragma unroll
    for (int q = 0; q < T / 2; ++q) {
      const float2 x = reinterpret_cast<const float2*>(src)[q];
      dst[2 * q] = x.x;
      dst[2 * q + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < T; ++q) dst[q] = src[q];
  }
}

// Byte j of a row, with the padding nibble of an odd C cleared.
__device__ __forceinline__ unsigned packed_byte(const uint8_t* __restrict__ p,
                                                size_t off, long long j,
                                                long long C) {
  const unsigned b = p[off];
  return (2 * j + 1 < C) ? b : (b & 0xFu);
}

// TA: bytes (cell pairs) a thread; TN: columns a thread; NTN: threads
// along N.
template <int TA, int TN, int NTN>
__global__ void __launch_bounds__(kThreads) loglik_kernel(
    const uint8_t* __restrict__ ad, const uint8_t* __restrict__ dp,
    const float* __restrict__ wa, const float* __restrict__ wd,
    float* __restrict__ out, int V, int C, int N, int n_tiles) {
  constexpr int NTJ = kThreads / NTN;
  constexpr int BJ = NTJ * TA;
  constexpr int BN = NTN * TN;
  static_assert(BJ == kRowsBlock, "a block owns kRowsBlock bytes");
  // planes[0..3] = AD lo, AD hi, DP lo, DP hi: [kVarTile][BJ]
  __shared__ __align__(16) float planes[4][kVarTile * BJ];
  __shared__ __align__(16) float wa_s[kVarTile * BN];
  __shared__ __align__(16) float wd_s[kVarTile * BN];

  const int tid = threadIdx.x;
  const int tn = tid % NTN;
  const int tj = tid / NTN;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const long long j0 = (long long)(blockIdx.x / n_tiles) * BJ;
  const long long Cl = C;
  const long long Cb = (Cl + 1) / 2;

  float ev[TA][TN], od[TA][TN];
#pragma unroll
  for (int i = 0; i < TA; ++i)
#pragma unroll
    for (int k = 0; k < TN; ++k) {
      ev[i][k] = 0.f;
      od[i][k] = 0.f;
    }

  for (int v0 = 0; v0 < V; v0 += kVarTile) {
    for (int idx = tid; idx < kVarTile * BJ; idx += kThreads) {
      const int v = v0 + idx / BJ;
      const long long j = j0 + idx % BJ;
      unsigned a = 0, d = 0;
      if (v < V && j < Cb) {
        const size_t off = (size_t)v * (size_t)Cb + (size_t)j;
        a = packed_byte(ad, off, j, Cl);
        d = packed_byte(dp, off, j, Cl);
      }
      planes[0][idx] = (float)(a & 0xFu);
      planes[1][idx] = (float)(a >> 4);
      planes[2][idx] = (float)(d & 0xFu);
      planes[3][idx] = (float)(d >> 4);
    }
    for (int idx = tid; idx < kVarTile * BN; idx += kThreads) {
      const int v = v0 + idx / BN;
      const int n = n0 + idx % BN;
      const bool in = v < V && n < N;
      const size_t off = (size_t)v * (size_t)N + n;
      wa_s[idx] = in ? wa[off] : 0.f;
      wd_s[idx] = in ? wd[off] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kVarTile; ++r) {
      float al[TA], ah[TA], dl[TA], dh[TA], xa[TN], xd[TN];
      load_row(al, &planes[0][r * BJ + tj * TA]);
      load_row(ah, &planes[1][r * BJ + tj * TA]);
      load_row(dl, &planes[2][r * BJ + tj * TA]);
      load_row(dh, &planes[3][r * BJ + tj * TA]);
      load_row(xa, &wa_s[r * BN + tn * TN]);
      load_row(xd, &wd_s[r * BN + tn * TN]);
#pragma unroll
      for (int i = 0; i < TA; ++i)
#pragma unroll
        for (int k = 0; k < TN; ++k) {
          ev[i][k] = fmaf(al[i], xa[k], ev[i][k]);
          ev[i][k] = fmaf(dl[i], xd[k], ev[i][k]);
          od[i][k] = fmaf(ah[i], xa[k], od[i][k]);
          od[i][k] = fmaf(dh[i], xd[k], od[i][k]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TA; ++i) {
    const long long j = j0 + tj * TA + i;
    if (j >= Cb) continue;
    const long long c = 2 * j;
#pragma unroll
    for (int k = 0; k < TN; ++k) {
      const int n = n0 + tn * TN + k;
      if (n >= N) continue;
      out[(size_t)c * (size_t)N + n] = ev[i][k];
      if (c + 1 < Cl) out[(size_t)(c + 1) * (size_t)N + n] = od[i][k];
    }
  }
}

// The grid: n_tiles x row tiles, N tiles fastest.
inline bool grid_size(long long rows, int N, int bn, int* n_tiles,
                      int* blocks) {
  const long long nt = (N + bn - 1) / bn;
  const long long total = nt * ((rows + kRowsBlock - 1) / kRowsBlock);
  if (total <= 0 || total > INT_MAX) return false;
  *n_tiles = (int)nt;
  *blocks = (int)total;
  return true;
}

template <int TA, int TN, int NTN>
int launch_loglik(const uint8_t* ad, const uint8_t* dp, const float* wa,
                  const float* wd, float* out, int V, int C, int N,
                  cudaStream_t s) {
  int n_tiles, blocks;
  if (!grid_size(((long long)C + 1) / 2, N, TN * NTN, &n_tiles, &blocks))
    return (int)cudaErrorInvalidValue;
  loglik_kernel<TA, TN, NTN><<<blocks, kThreads, 0, s>>>(ad, dp, wa, wd, out,
                                                         V, C, N, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* vireo_packed_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// ad_p, dp_p: (V, ceil(C / 2)) uint8. w3: (3, N, ldw) bf16, the three
// terms of W^T, cells contiguous, ldw >= C a multiple of 8. s1, ss:
// (V, N) float32.
int vireo_packed_suff_stats(const void* ad_p, const void* dp_p,
                            const void* w3, void* s1, void* ss, int V, int C,
                            int N, int ldw, void* stream) {
  if (V <= 0 || C <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  return (int)hopper::launch_rows_any<hopper::Nibbles, 3>(
      (const uint8_t*)ad_p, (const uint8_t*)dp_p, ((long long)C + 1) / 2, V,
      w3, ldw, C, (float*)s1, (float*)ss, N, N, (cudaStream_t)stream);
}

// ad_p, dp_p: (V, ceil(C / 2)) uint8. wa, wd: (V, N) float32. out: (C, N)
// float32.
int vireo_packed_cell_loglik(const void* ad_p, const void* dp_p,
                             const void* wa, const void* wd, void* out,
                             int V, int C, int N, void* stream) {
  if (V <= 0 || C <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const uint8_t* a = (const uint8_t*)ad_p;
  const uint8_t* d = (const uint8_t*)dp_p;
  cudaStream_t s = (cudaStream_t)stream;
  if (N <= 16)
    return launch_loglik<2, 4, 4>(a, d, (const float*)wa, (const float*)wd,
                                  (float*)out, V, C, N, s);
  if (N <= 32)
    return launch_loglik<4, 4, 8>(a, d, (const float*)wa, (const float*)wd,
                                  (float*)out, V, C, N, s);
  return launch_loglik<8, 4, 16>(a, d, (const float*)wa, (const float*)wd,
                                 (float*)out, V, C, N, s);
}

}  // extern "C"
