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
// its low nibble and cell 2j + 1 in its high nibble. Weights are float32,
// row-major: W (C, N); Wa, Wd (V, N). Outputs are float32: S1, SS (V, N);
// out (C, N) in cell order. Ragged V, Cb and N are masked here, and so is
// the high nibble of a row's last byte when C is odd; the caller pads
// nothing. Offsets are 64-bit: one matrix may hold more than 2^31 bytes.
//
// What bounds them on an H100: arithmetic on the CUDA cores. A packed
// byte carries 2 cells x N columns x 2 flop = 4N flop for each of the two
// matrices; the CUDA cores' ridge point is about 20 flop/byte (67 TFLOP/s
// float32 at 3.35 TB/s), so every N this path uses (16, 21, 136, 320) is
// past it. Both kernels therefore read each byte from device memory about
// once per block of N columns and spend their time in FMA, in the layout
// of a plain float32 GEMM:
//
//   suff_kernel (K2): a block owns 128 variant rows x BN columns of BOTH
//     S1 and SS, so each staged W tile serves AD and DP. It loops over all
//     cells in tiles of 16 bytes (32 cells): the bytes are loaded once,
//     unpacked in registers into four float planes (AD lo/hi, DP lo/hi) in
//     shared memory, and W's even and odd rows of the tile are staged
//     beside them. Each thread keeps a TA x TN tile of S1 and of SS in
//     registers.
//   loglik_kernel (K3): a block owns 128 cell pairs (bytes) x BN columns
//     and loops over V in tiles of 16 variants, staging the unpacked
//     planes, Wa and Wd. Each thread keeps TA x TN even cells and TA x TN
//     odd cells, and writes cells 2j and 2j + 1 straight to cell order, so
//     there is no interleave pass (the TPU's caller interleaves,
//     packed.py:222).
//
// The N tile is picked by N (16, 32 or 64 columns), so the refit's N = 16
// keeps every thread busy. Blocks that share rows and differ in their N
// tile are adjacent in the grid, so their byte reads meet in L2.
//
// No atomics: each output element belongs to one thread of one block and
// is summed in a fixed order, so results do not change between runs.
// Products and sums are float32 (FMA), as the TPU kernels accumulate.
// The faster design is the tensor cores: nibbles are exact in bf16, and
// the float32 weights would need a split into bf16 terms, or TF32, with
// a stated tolerance (PERF.md, section 7).
//
// Interface: plain C entry points, loaded with ctypes. Each launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError()
// (or cudaErrorInvalidValue for shapes it does not take).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsBlock = 128;   // K2: variants a block; K3: bytes a block
constexpr int kByteTile = 16;     // K2: packed bytes (32 cells) a tile
constexpr int kVarTile = 16;      // K3: variants a tile
constexpr int kPad = 4;           // K2 plane row padding, keeps 16-B rows

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

// TA: variant rows a thread; TN: columns a thread; NTN: threads along N.
template <int TA, int TN, int NTN>
__global__ void __launch_bounds__(kThreads) suff_kernel(
    const uint8_t* __restrict__ ad, const uint8_t* __restrict__ dp,
    const float* __restrict__ w, float* __restrict__ s1,
    float* __restrict__ ss, int V, int C, int N, int n_tiles) {
  constexpr int NTA = kThreads / NTN;
  constexpr int BV = NTA * TA;
  constexpr int BN = NTN * TN;
  constexpr int LD = BV + kPad;
  static_assert(BV == kRowsBlock, "a block owns kRowsBlock variants");
  // planes[0..3] = AD lo, AD hi, DP lo, DP hi: [kByteTile][LD]
  __shared__ __align__(16) float planes[4][kByteTile * LD];
  __shared__ __align__(16) float w_s[2 * kByteTile * BN];

  const int tid = threadIdx.x;
  const int tn = tid % NTN;
  const int ta = tid / NTN;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const long long v0 = (long long)(blockIdx.x / n_tiles) * BV;
  const long long Cl = C;
  const long long Cb = (Cl + 1) / 2;

  float acc1[TA][TN], acc2[TA][TN];
#pragma unroll
  for (int i = 0; i < TA; ++i)
#pragma unroll
    for (int k = 0; k < TN; ++k) {
      acc1[i][k] = 0.f;
      acc2[i][k] = 0.f;
    }

  for (long long j0 = 0; j0 < Cb; j0 += kByteTile) {
    for (int idx = tid; idx < BV * kByteTile; idx += kThreads) {
      const int r = idx / kByteTile;
      const int jj = idx % kByteTile;
      const long long v = v0 + r;
      const long long j = j0 + jj;
      unsigned a = 0, d = 0;
      if (v < V && j < Cb) {
        const size_t off = (size_t)v * (size_t)Cb + (size_t)j;
        a = packed_byte(ad, off, j, Cl);
        d = packed_byte(dp, off, j, Cl);
      }
      planes[0][jj * LD + r] = (float)(a & 0xFu);
      planes[1][jj * LD + r] = (float)(a >> 4);
      planes[2][jj * LD + r] = (float)(d & 0xFu);
      planes[3][jj * LD + r] = (float)(d >> 4);
    }
    // W rows 2 j0 .. 2 j0 + 2 kByteTile - 1: row 2jj is the even cell of
    // byte jj, row 2jj + 1 the odd one
    for (int idx = tid; idx < 2 * kByteTile * BN; idx += kThreads) {
      const long long c = 2 * j0 + idx / BN;
      const int n = n0 + idx % BN;
      w_s[idx] = (c < Cl && n < N) ? w[(size_t)c * (size_t)N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < kByteTile; ++jj) {
      float al[TA], ah[TA], dl[TA], dh[TA], we[TN], wo[TN];
      load_row(al, &planes[0][jj * LD + ta * TA]);
      load_row(ah, &planes[1][jj * LD + ta * TA]);
      load_row(dl, &planes[2][jj * LD + ta * TA]);
      load_row(dh, &planes[3][jj * LD + ta * TA]);
      load_row(we, &w_s[(2 * jj) * BN + tn * TN]);
      load_row(wo, &w_s[(2 * jj + 1) * BN + tn * TN]);
#pragma unroll
      for (int i = 0; i < TA; ++i)
#pragma unroll
        for (int k = 0; k < TN; ++k) {
          acc1[i][k] = fmaf(al[i], we[k], acc1[i][k]);
          acc1[i][k] = fmaf(ah[i], wo[k], acc1[i][k]);
          acc2[i][k] = fmaf(dl[i], we[k], acc2[i][k]);
          acc2[i][k] = fmaf(dh[i], wo[k], acc2[i][k]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TA; ++i) {
    const long long v = v0 + ta * TA + i;
    if (v >= V) continue;
#pragma unroll
    for (int k = 0; k < TN; ++k) {
      const int n = n0 + tn * TN + k;
      if (n < N) {
        s1[(size_t)v * (size_t)N + n] = acc1[i][k];
        ss[(size_t)v * (size_t)N + n] = acc2[i][k];
      }
    }
  }
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
int launch_suff(const uint8_t* ad, const uint8_t* dp, const float* w,
                float* s1, float* ss, int V, int C, int N, cudaStream_t s) {
  int n_tiles, blocks;
  if (!grid_size(V, N, TN * NTN, &n_tiles, &blocks))
    return (int)cudaErrorInvalidValue;
  suff_kernel<TA, TN, NTN><<<blocks, kThreads, 0, s>>>(ad, dp, w, s1, ss, V,
                                                       C, N, n_tiles);
  return (int)cudaGetLastError();
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

// ad_p, dp_p: (V, ceil(C / 2)) uint8. w: (C, N) float32. s1, ss: (V, N)
// float32.
int vireo_packed_suff_stats(const void* ad_p, const void* dp_p,
                            const void* w, void* s1, void* ss, int V, int C,
                            int N, void* stream) {
  if (V <= 0 || C <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const uint8_t* a = (const uint8_t*)ad_p;
  const uint8_t* d = (const uint8_t*)dp_p;
  cudaStream_t s = (cudaStream_t)stream;
  if (N <= 16)
    return launch_suff<2, 4, 4>(a, d, (const float*)w, (float*)s1,
                                (float*)ss, V, C, N, s);
  if (N <= 32)
    return launch_suff<4, 4, 8>(a, d, (const float*)w, (float*)s1,
                                (float*)ss, V, C, N, s);
  return launch_suff<8, 4, 16>(a, d, (const float*)w, (float*)s1,
                               (float*)ss, V, C, N, s);
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
