// Fused doublet/fit E-step with the next sufficient statistics (K1).
//
// Replaces the TPU kernel vireo_tpu/ops/pallas_em.py::fused_estep_stats
// (the pl.pallas_call at pallas_em.py:145, body `_kernel` at :46-90).
// For int8 counts AD, DP of shape (V, C), weights W = [Wa | Wd] of
// shape (V, 2K) rounded to bf16, and a (K,) float32 log prior:
//
//   loglik = AD^T Wa + DP^T Wd                       (C, K)
//   id     = softmax(loglik + log_prior)             (C, K)
//   S1     = AD  bf16(id[:, :Ks])                    (V, Ks)
//   SS     = DP  bf16(id[:, :Ks])                    (V, Ks)
//   lb_p   = sum loglik * id
//   kl_id  = sum_{id > 0} id * (log id - log_prior)
//
// The counts are converted in registers, products and sums are float32,
// and W and the id that feeds S carry the same bf16 rounding as the TPU
// kernel (pallas_em.py:72 and :116). Ragged V and C are masked here, so
// the caller pads nothing.
//
// What bounds it on an H100: the bytes of int8 counts. At the slice's
// doublet shape (V = 30000, C = 100000, K = 136, Ks = 16) the two
// matrices are 6 GB, while W is 16 MB and the outputs about 120 MB.
// The Pallas design keeps a whole (V, 128) panel of each matrix in
// 100 MB of VMEM and forms loglik and S from that one resident panel;
// an SM has 227 KB of shared memory, so that cannot carry over. This
// first design reads the counts twice, once per kernel, each time
// exactly once and in full rows of 32 bytes:
//
//   estep_kernel: one block per 64 cells, looping over V in tiles of 16
//     variants staged through shared memory; loglik (64 x K) stays in
//     registers; the softmax runs in the epilogue, one warp per cell;
//     each block writes id, loglik and one (lb_p, kl_id) partial.
//   stats_kernel: one block per 64 variants, looping over all cells in
//     tiles of 32 in a fixed order, forming S1 and SS from the counts
//     and bf16(id); block 0 also sums the scalar partials in block
//     order.
//
// No atomics, so the results do not change from run to run. The
// arithmetic is on the CUDA cores (FMA), not the tensor cores: a single
// pass and tensor-core tiles are later work.
//
// Interface: a plain C entry point, loaded with ctypes. It launches on
// the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for shapes it does not
// take).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 256;

// estep_kernel tiling
constexpr int kCellBlock = 64;                 // cells per block
constexpr int kVarTile = 16;                   // variants per smem tile
constexpr int kCellGroups = 16;                // threads along cells
constexpr int kCellsPerThread = kCellBlock / kCellGroups;   // 4
constexpr int kKGroups = kThreads / kCellGroups;            // 16

// stats_kernel tiling
constexpr int kVarBlock = 64;                  // variants per block
constexpr int kCellTile = 32;                  // cells per smem tile
constexpr int kSGroups = 16;                   // threads along stats cols
constexpr int kVarGroups = kThreads / kSGroups;             // 16
constexpr int kVarsPerThread = kVarBlock / kVarGroups;      // 4

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// KPT: k columns per thread, >= ceil(K / kKGroups).
template <int KPT>
__global__ void __launch_bounds__(kThreads) estep_kernel(
    const int8_t* __restrict__ ad, const int8_t* __restrict__ dp,
    const __nv_bfloat16* __restrict__ w, const float* __restrict__ prior,
    float* __restrict__ id_out, float* __restrict__ ll_out,
    float* __restrict__ partials, int V, int C, int K) {
  extern __shared__ float smem[];
  // main loop: a_s, d_s [kVarTile][kCellBlock], w_s [kVarTile][2K]
  float* a_s = smem;
  float* d_s = a_s + kVarTile * kCellBlock;
  float* w_s = d_s + kVarTile * kCellBlock;
  // epilogue (reuses the same memory): ll_s [kCellBlock][K]
  float* ll_s = smem;
  __shared__ float red_s[2][kThreads / 32];

  const int tid = threadIdx.x;
  const int tc = tid % kCellGroups;
  const int tk = tid / kCellGroups;
  const int two_k = 2 * K;
  const long long c0 = (long long)blockIdx.x * kCellBlock;

  float acc[kCellsPerThread][KPT];
#pragma unroll
  for (int i = 0; i < kCellsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < KPT; ++j) acc[i][j] = 0.f;

  for (int v0 = 0; v0 < V; v0 += kVarTile) {
    for (int idx = tid; idx < kVarTile * kCellBlock; idx += kThreads) {
      const int r = idx / kCellBlock;
      const long long v = v0 + r;
      const long long c = c0 + idx % kCellBlock;
      float a = 0.f, d = 0.f;
      if (v < V && c < C) {
        const size_t off = (size_t)v * (size_t)C + (size_t)c;
        a = (float)ad[off];
        d = (float)dp[off];
      }
      a_s[idx] = a;
      d_s[idx] = d;
    }
    for (int idx = tid; idx < kVarTile * two_k; idx += kThreads) {
      const long long v = v0 + idx / two_k;
      w_s[idx] = (v < V)
          ? __bfloat162float(w[(size_t)v * two_k + idx % two_k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kVarTile; ++r) {
      float a[kCellsPerThread], d[kCellsPerThread];
#pragma unroll
      for (int i = 0; i < kCellsPerThread; ++i) {
        a[i] = a_s[r * kCellBlock + tc + kCellGroups * i];
        d[i] = d_s[r * kCellBlock + tc + kCellGroups * i];
      }
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int k = tk + kKGroups * j;
        const float wa = (k < K) ? w_s[r * two_k + k] : 0.f;
        const float wd = (k < K) ? w_s[r * two_k + K + k] : 0.f;
#pragma unroll
        for (int i = 0; i < kCellsPerThread; ++i) {
          acc[i][j] = fmaf(a[i], wa, acc[i][j]);
          acc[i][j] = fmaf(d[i], wd, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // loglik block to shared memory, then one warp per cell row
#pragma unroll
  for (int i = 0; i < kCellsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int k = tk + kKGroups * j;
      if (k < K) ll_s[(tc + kCellGroups * i) * K + k] = acc[i][j];
    }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  float lb = 0.f, kl = 0.f;
  for (int cl = warp; cl < kCellBlock; cl += kThreads / 32) {
    const long long c = c0 + cl;
    if (c >= C) break;                      // uniform across the warp
    const float* row = ll_s + cl * K;
    float m = -INFINITY;
    for (int k = lane; k < K; k += 32) m = fmaxf(m, row[k] + prior[k]);
    m = warp_max(m);
    float s = 0.f;
    for (int k = lane; k < K; k += 32) s += expf(row[k] + prior[k] - m);
    s = warp_sum(s);
    for (int k = lane; k < K; k += 32) {
      const float l = row[k];
      const float p = expf(l + prior[k] - m) / s;
      id_out[(size_t)c * K + k] = p;
      ll_out[(size_t)c * K + k] = l;
      lb += l * p;
      if (p > 0.f) kl += p * (logf(p) - prior[k]);
    }
  }
  lb = warp_sum(lb);
  kl = warp_sum(kl);
  if (lane == 0) {
    red_s[0][warp] = lb;
    red_s[1][warp] = kl;
  }
  __syncthreads();
  if (tid == 0) {
    float tl = 0.f, tk2 = 0.f;
    for (int i = 0; i < kThreads / 32; ++i) {
      tl += red_s[0][i];
      tk2 += red_s[1][i];
    }
    partials[2 * blockIdx.x] = tl;
    partials[2 * blockIdx.x + 1] = tk2;
  }
}

// SPT: stats columns per thread, >= ceil(Ks / kSGroups).
template <int SPT>
__global__ void __launch_bounds__(kThreads) stats_kernel(
    const int8_t* __restrict__ ad, const int8_t* __restrict__ dp,
    const float* __restrict__ id, float* __restrict__ S,
    const float* __restrict__ partials, float* __restrict__ scal,
    int V, int C, int K, int Ks, int n_partials) {
  extern __shared__ float smem[];
  float* a_s = smem;                               // [kVarBlock][kCellTile]
  float* d_s = a_s + kVarBlock * kCellTile;        // [kVarBlock][kCellTile]
  float* i_s = d_s + kVarBlock * kCellTile;        // [kCellTile][Ks]

  const int tid = threadIdx.x;
  const int ts = tid % kSGroups;
  const int tv = tid / kSGroups;
  const long long v0 = (long long)blockIdx.x * kVarBlock;

  float sa[kVarsPerThread][SPT], sd[kVarsPerThread][SPT];
#pragma unroll
  for (int i = 0; i < kVarsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      sa[i][j] = 0.f;
      sd[i][j] = 0.f;
    }

  for (long long c0 = 0; c0 < C; c0 += kCellTile) {
    for (int idx = tid; idx < kVarBlock * kCellTile; idx += kThreads) {
      const long long v = v0 + idx / kCellTile;
      const long long c = c0 + idx % kCellTile;
      float a = 0.f, d = 0.f;
      if (v < V && c < C) {
        const size_t off = (size_t)v * (size_t)C + (size_t)c;
        a = (float)ad[off];
        d = (float)dp[off];
      }
      a_s[idx] = a;
      d_s[idx] = d;
    }
    for (int idx = tid; idx < kCellTile * Ks; idx += kThreads) {
      const long long c = c0 + idx / Ks;
      // the bf16 rounding of the id that feeds S (pallas_em.py:72)
      i_s[idx] = (c < C)
          ? __bfloat162float(__float2bfloat16(id[(size_t)c * K + idx % Ks]))
          : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int cc = 0; cc < kCellTile; ++cc) {
      float a[kVarsPerThread], d[kVarsPerThread];
#pragma unroll
      for (int i = 0; i < kVarsPerThread; ++i) {
        a[i] = a_s[(tv + kVarGroups * i) * kCellTile + cc];
        d[i] = d_s[(tv + kVarGroups * i) * kCellTile + cc];
      }
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const int k = ts + kSGroups * j;
        const float p = (k < Ks) ? i_s[cc * Ks + k] : 0.f;
#pragma unroll
        for (int i = 0; i < kVarsPerThread; ++i) {
          sa[i][j] = fmaf(a[i], p, sa[i][j]);
          sd[i][j] = fmaf(d[i], p, sd[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kVarsPerThread; ++i) {
    const long long v = v0 + tv + kVarGroups * i;
    if (v >= V) continue;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int k = ts + kSGroups * j;
      if (k < Ks) {
        S[(size_t)v * 2 * Ks + k] = sa[i][j];
        S[(size_t)v * 2 * Ks + Ks + k] = sd[i][j];
      }
    }
  }

  if (blockIdx.x == 0 && tid == 0) {
    float lb = 0.f, kl = 0.f;
    for (int b = 0; b < n_partials; ++b) {
      lb += partials[2 * b];
      kl += partials[2 * b + 1];
    }
    scal[0] = lb;
    scal[1] = kl;
  }
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Per-thread column counts that are instantiated; a request rounds up.
constexpr int kPerThread[] = {1, 2, 3, 4, 6, 9, 12, 16};

int round_per_thread(int n) {
  for (int p : kPerThread)
    if (p >= n) return p;
  return -1;
}

template <int P>
void estep_launch(int grid, size_t smem, cudaStream_t s, const int8_t* ad,
                  const int8_t* dp, const __nv_bfloat16* w,
                  const float* prior, float* id, float* ll, float* part,
                  int V, int C, int K, cudaError_t* err) {
  *err = allow_smem(estep_kernel<P>, smem);
  if (*err != cudaSuccess) return;
  estep_kernel<P><<<grid, kThreads, smem, s>>>(ad, dp, w, prior, id, ll,
                                                part, V, C, K);
}

template <int P>
void stats_launch(int grid, size_t smem, cudaStream_t s, const int8_t* ad,
                  const int8_t* dp, const float* id, float* S,
                  const float* part, float* scal, int V, int C, int K,
                  int Ks, int n_part, cudaError_t* err) {
  *err = allow_smem(stats_kernel<P>, smem);
  if (*err != cudaSuccess) return;
  stats_kernel<P><<<grid, kThreads, smem, s>>>(ad, dp, id, S, part, scal,
                                                V, C, K, Ks, n_part);
}

}  // namespace

extern "C" {

int vireo_fused_estep_cell_block() { return kCellBlock; }

int vireo_fused_estep_max_k() { return kMaxK; }

const char* vireo_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// ad, dp: (V, C) int8, row-major. w: (V, 2K) bf16, row-major.
// prior: (K,) float32. S: (V, 2Ks) float32. id, ll: (C, K) float32.
// partials: (ceil(C / 64), 2) float32 scratch. scal: (2,) float32.
int vireo_fused_estep_stats(const void* ad, const void* dp, const void* w,
                            const void* prior, void* S, void* id, void* ll,
                            void* partials, void* scal, int V, int C, int K,
                            int Ks, void* stream) {
  if (V <= 0 || C <= 0 || K <= 0 || K > kMaxK || Ks <= 0 || Ks > K)
    return (int)cudaErrorInvalidValue;
  const int pk = round_per_thread((K + kKGroups - 1) / kKGroups);
  const int ps = round_per_thread((Ks + kSGroups - 1) / kSGroups);
  if (pk < 0 || ps < 0) return (int)cudaErrorInvalidValue;

  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* a8 = (const int8_t*)ad;
  const int8_t* d8 = (const int8_t*)dp;
  const int grid_a = (C + kCellBlock - 1) / kCellBlock;
  const int grid_b = (V + kVarBlock - 1) / kVarBlock;
  size_t smem_main = (size_t)(2 * kVarTile * kCellBlock + kVarTile * 2 * K)
                     * sizeof(float);
  size_t smem_epi = (size_t)kCellBlock * K * sizeof(float);
  const size_t smem_a = smem_main > smem_epi ? smem_main : smem_epi;
  const size_t smem_b = (size_t)(2 * kVarBlock * kCellTile + kCellTile * Ks)
                        * sizeof(float);

  cudaError_t err = cudaSuccess;
#define VIREO_ESTEP(P)                                                     \
  case P:                                                                  \
    estep_launch<P>(grid_a, smem_a, s, a8, d8, (const __nv_bfloat16*)w,    \
                    (const float*)prior, (float*)id, (float*)ll,           \
                    (float*)partials, V, C, K, &err);                      \
    break;
  switch (pk) {
    VIREO_ESTEP(1) VIREO_ESTEP(2) VIREO_ESTEP(3) VIREO_ESTEP(4)
    VIREO_ESTEP(6) VIREO_ESTEP(9) VIREO_ESTEP(12) VIREO_ESTEP(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef VIREO_ESTEP
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

#define VIREO_STATS(P)                                                     \
  case P:                                                                  \
    stats_launch<P>(grid_b, smem_b, s, a8, d8, (const float*)id,           \
                    (float*)S, (const float*)partials, (float*)scal, V, C, \
                    K, Ks, grid_a, &err);                                  \
    break;
  switch (ps) {
    VIREO_STATS(1) VIREO_STATS(2) VIREO_STATS(3) VIREO_STATS(4)
    VIREO_STATS(6) VIREO_STATS(9) VIREO_STATS(12) VIREO_STATS(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef VIREO_STATS
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
