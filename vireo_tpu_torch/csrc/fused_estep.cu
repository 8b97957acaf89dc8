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
// Precision is the TPU kernel's: W and the id that feeds S are rounded
// to bf16 (pallas_em.py:72 and :116), the counts (0..127) are exact in
// bf16, and bf16 x bf16 products are summed in float32, so the tensor
// cores form exactly the products of the TPU kernel and of the plain
// version, in another order.
//
// What bounds it on an H100. At the doublet shape (V = 30000,
// C = 100000, K = 136, Ks = 16) the E-step is 1.6 TFLOP and the
// statistics 0.2 TFLOP; the counts are 6 GB, so two reads of them take
// about 3.6 ms at 3.35 TB/s, and that is the floor of this two-pass
// design. The first design ran both contractions on the CUDA cores at
// about 15 TFLOP/s (117 ms). Both now run on the tensor cores (wgmma,
// hopper_gemm.cuh), fed by rings of shared-memory stages (the weights
// by TMA, the counts by cp.async):
//
//   estep_kernel: one block per 128 cells (64 a warpgroup), looping over
//     column tiles of K (at most 256 columns, so any K up to kMaxK is
//     taken) and, for each, over V in k-blocks of 64 variants. AD^T is
//     M-major in memory (cells contiguous), so A is built in registers
//     from the (64 variants x 128 cells) count tile staged in shared
//     memory (`hopper::mmajor_frag`, which K3 shares): a warp's fragment
//     rows g and g + 8 are its cells 2g and 2g + 1, so each bf16 pair is
//     two bytes of one cell column. B is
//     W^T, which the wrapper writes K-major, (2, K, ldv) bf16. Each tile
//     of loglik goes to ll_out; after the last
//     tile the block reads its rows back and runs the softmax, one warp
//     per cell, writing id, loglik, bf16(id[:, :Ks]) transposed into the
//     (Ks, ldc) scratch that is the statistics' B, and one
//     (lb_p, kl_id) partial per block.
//   hopper::rows_kernel with the int8 codec: S = [AD; DP] bf16(id), one
//     block per 128 variants, all cells in k-blocks of 64; AD rows are
//     K-major, so each A register is two adjacent cells of one row.
//   sum_partials: one thread sums the partials in block order.
//
// The Pallas design forms loglik and S from one (V, 128) panel resident
// in 100 MB of VMEM; a single pass here would need S summed across cell
// blocks, by atomics (which change from run to run) or by one (V, 2Ks)
// buffer per block, so K1 keeps two passes over the counts.
//
// No atomics, so the results do not change from run to run. Count rows
// may have any length and alignment (hopper_gemm.cuh); ragged V, C, K
// and Ks are covered by TMA's zero fill of the B boxes past their
// tensor maps' logical sizes and masked at the stores.
//
// Interface: a plain C entry point, loaded with ctypes. It launches on
// the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for shapes it does not
// take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

using namespace hopper;

// The most assignment columns K the wrapper sends here (mirrored by
// vireo_tpu_torch/ops/fused_em.py::MAX_K). The kernel tiles K and keeps
// nothing K-sized in registers or shared memory, so it does not set the
// bound: the outputs do. id and loglik are (C, K) float32 in device
// memory, 2 x 4 x C x K bytes = 0.82 GB at C = 100000 and K = 1024, and
// the counts are read once per column tile (four times at K = 1024).
// n_donor <= 44 gives K = n + C(n, 2) <= 990.
constexpr int kMaxK = 1024;

constexpr int kCellBlock = kBlockRows;  // cells an E-step block
constexpr int kVarK = kKBlock;          // variants an E-step k-block

template <int BN_>
struct EstepShape {
  static constexpr int BN = BN_;
  static constexpr int A_PITCH = kCellBlock + 16;
  static constexpr int B_BYTES = 2 * kVarK * BN * 2;
  static constexpr int A_BYTES = 2 * kVarK * A_PITCH;
  static constexpr int STAGE = B_BYTES + A_BYTES;
  static constexpr int STAGES = ring_depth(STAGE);
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + kSmemAlign;
  static_assert(STAGES >= 2, "a ring needs two stages");
  static_assert(STAGE % kSmemAlign == 0, "stages keep the alignment");
};

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

template <int BN>
__global__ void __launch_bounds__(kBlockThreads, 1) estep_kernel(
    const uint8_t* __restrict__ ad, const uint8_t* __restrict__ dp, int V,
    int C, const __grid_constant__ CUtensorMap wt_map,
    const float* __restrict__ prior, int K, int Ks,
    float* __restrict__ id_out, float* __restrict__ ll_out,
    __nv_bfloat16* __restrict__ id_t, long long ldc,
    float* __restrict__ partials) {
  using S = EstepShape<BN>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  __shared__ float red_s[2][kBlockThreads / 32];
  __shared__ uint64_t b_full[S::STAGES];

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const long long c0 = (long long)blockIdx.x * kCellBlock;
  const int nkb = (V + kVarK - 1) / kVarK;
  const int total = nkb * ((K + S::BN - 1) / S::BN);

  auto stage = [&](int i) { return smem + (size_t)i * S::STAGE; };
  // W^T by TMA (one thread), the counts by every thread's cp.async
  auto load = [&](int f) {
    uint8_t* st = stage(f % S::STAGES);
    const int v0 = (f % nkb) * kVarK;
    if (tid == 0)
      load_b<2, S::BN, kVarK>(st, &wt_map, &b_full[f % S::STAGES],
                              (f / nkb) * S::BN, v0);
    load_byte_rows<kVarK, kCellBlock>(st + S::B_BYTES, ad, v0, V, C, c0);
    load_byte_rows<kVarK, kCellBlock>(st + S::B_BYTES + kVarK * S::A_PITCH,
                                      dp, v0, V, C, c0);
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  if (tid == 0)
    for (int i = 0; i < S::STAGES; ++i) mbar_init(&b_full[i]);
  __syncthreads();
#pragma unroll
  for (int f = 0; f < S::STAGES - 1; ++f) {
    if (f < total) load(f);
    cp_async_commit();
  }

  // this warp's 16 cells; fragment row g is cell cb + 2g, row g + 8 is
  // cell cb + 2g + 1
  const int cb = wg * 64 + warp * 16 + 2 * g;

  for (int f = 0; f < total; ++f) {
    cp_async_wait<S::STAGES - 2>();
    __syncthreads();
    mbar_wait(&b_full[f % S::STAGES], (f / S::STAGES) & 1);

    const uint8_t* st = stage(f % S::STAGES);
    const long long v0 = (long long)(f % nkb) * kVarK;
    uint32_t frag[2][kVarK / 16][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const uint8_t* src = m ? dp : ad;
      const uint8_t* base = st + S::B_BYTES + m * kVarK * S::A_PITCH;
#pragma unroll
      for (int s = 0; s < kVarK / 16; ++s) {
        const uint8_t* p[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // variants 16s + 2c, +1, +8, +9 of the k-block
          const int r = 16 * s + 2 * c + (q & 1) + 8 * (q >> 1);
          p[q] = byte_row(base + r * S::A_PITCH, src, v0 + r, C, c0) + cb;
        }
        mmajor_frag<Int8>(frag[m][s], p);
      }
    }

    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kVarK / 16; ++s)
#pragma unroll
      for (int m = 0; m < 2; ++m)
        wgmma_rs<BN>(acc, frag[m][s], b_desc<BN, kVarK>(st, m, s), 1);
    wgmma_commit();
    // the slot of k-block f - 1, which every warpgroup has finished
    if (f + S::STAGES - 1 < total) load(f + S::STAGES - 1);
    cp_async_commit();
    wgmma_wait_all();
    fence_regs(acc);

    if (f % nkb == nkb - 1) {  // the column tile is done: store it
      const int k0 = (f / nkb) * S::BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const long long cell = c0 + cb + ((i >> 1) & 1);
        const int k = k0 + 8 * (i >> 2) + 2 * c + (i & 1);
        if (cell < C && k < K) ll_out[cell * K + k] = acc[i];
        acc[i] = 0.f;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the block's loglik rows are written

  float lb = 0.f, kl = 0.f;
  for (int cl = tid / 32; cl < kCellBlock; cl += kBlockThreads / 32) {
    const long long cell = c0 + cl;
    if (cell >= C) break;                   // uniform across the warp
    const float* row = ll_out + cell * K;
    float mx = -INFINITY;
    for (int k = lane; k < K; k += 32) mx = fmaxf(mx, row[k] + prior[k]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int k = lane; k < K; k += 32) sum += expf(row[k] + prior[k] - mx);
    sum = warp_sum(sum);
    for (int k = lane; k < K; k += 32) {
      const float l = row[k];
      const float p = expf(l + prior[k] - mx) / sum;
      id_out[cell * K + k] = p;
      // the bf16 rounding of the id that feeds S (pallas_em.py:72)
      if (k < Ks) id_t[k * ldc + cell] = __float2bfloat16(p);
      lb += l * p;
      if (p > 0.f) kl += p * (logf(p) - prior[k]);
    }
  }
  lb = warp_sum(lb);
  kl = warp_sum(kl);
  if (lane == 0) {
    red_s[0][tid / 32] = lb;
    red_s[1][tid / 32] = kl;
  }
  __syncthreads();
  if (tid == 0) {
    float tl = 0.f, tk = 0.f;
    for (int i = 0; i < kBlockThreads / 32; ++i) {
      tl += red_s[0][i];
      tk += red_s[1][i];
    }
    partials[2 * blockIdx.x] = tl;
    partials[2 * blockIdx.x + 1] = tk;
  }
}

// lb_p and kl_id: the per-block partials summed in block order.
__global__ void sum_partials(const float* __restrict__ partials, int n,
                             float* __restrict__ scal) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  float lb = 0.f, kl = 0.f;
  for (int b = 0; b < n; ++b) {
    lb += partials[2 * b];
    kl += partials[2 * b + 1];
  }
  scal[0] = lb;
  scal[1] = kl;
}

template <int BN>
cudaError_t launch_estep(int grid, cudaStream_t s, const uint8_t* ad,
                         const uint8_t* dp, int V, int C, const void* wt,
                         long long ldv, const float* prior, int K, int Ks,
                         float* id, float* ll, void* id_t, long long ldc,
                         float* partials) {
  using Sh = EstepShape<BN>;
  auto kernel = estep_kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap wt_map;
  if (!encode_b(&wt_map, wt, 2, K, V, ldv, Sh::BN))
    return cudaErrorInvalidValue;
  kernel<<<grid, kBlockThreads, Sh::SMEM, s>>>(
      ad, dp, V, C, wt_map, prior, K, Ks, id, ll, (__nv_bfloat16*)id_t, ldc,
      partials);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int vireo_fused_estep_cell_block() { return kCellBlock; }

int vireo_fused_estep_max_k() { return kMaxK; }

const char* vireo_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// ad, dp: (V, C) int8, row-major. wt: (2, K, ldv) bf16, W^T ([Wa | Wd]
// rounded to bf16, transposed), variants contiguous. prior: (K,)
// float32. S: (V, 2Ks) float32. id, ll: (C, K) float32. id_t: (Ks, ldc)
// bf16 scratch. ldv >= V and ldc >= C are multiples of 8 (TMA's 16-byte
// row stride); nothing past V or C in a row is read. partials:
// (ceil(C / 128), 2) float32 scratch. scal: (2,) float32.
int vireo_fused_estep_stats(const void* ad, const void* dp, const void* wt,
                            const void* prior, void* S, void* id, void* ll,
                            void* id_t, void* partials, void* scal, int V,
                            int C, int K, int Ks, int ldv, int ldc,
                            void* stream) {
  if (V <= 0 || C <= 0 || K <= 0 || K > kMaxK || Ks <= 0 || Ks > K ||
      V > 0x7FFFFFFF - kVarK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* a8 = (const uint8_t*)ad;
  const uint8_t* d8 = (const uint8_t*)dp;
  const int grid = (C + kCellBlock - 1) / kCellBlock;

  cudaError_t err = cudaErrorInvalidValue;
  switch (hopper::pick_tile(K, 256)) {
#define VIREO_ESTEP(BN)                                                    \
  case BN:                                                                 \
    err = launch_estep<BN>(grid, s, a8, d8, V, C, wt, ldv,                 \
                           (const float*)prior, K, Ks, (float*)id,         \
                           (float*)ll, id_t, ldc, (float*)partials);       \
    break;
    VIREO_ESTEP(16) VIREO_ESTEP(32) VIREO_ESTEP(64) VIREO_ESTEP(96)
    VIREO_ESTEP(128) VIREO_ESTEP(160) VIREO_ESTEP(192) VIREO_ESTEP(224)
    VIREO_ESTEP(256)
#undef VIREO_ESTEP
  }
  if (err != cudaSuccess) return (int)err;

  err = hopper::launch_rows_any<hopper::Int8, 1>(
      a8, d8, C, V, id_t, ldc, C, (float*)S, (float*)S + Ks, 2LL * Ks, Ks,
      s);
  if (err != cudaSuccess) return (int)err;

  sum_partials<<<1, 32, 0, s>>>((const float*)partials, grid, (float*)scal);
  return (int)cudaGetLastError();
}

}  // extern "C"
