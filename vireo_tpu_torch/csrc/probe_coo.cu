// The COO probes of benchmarks/coo_pallas_probe.py on Hopper: kernels C
// and D.
//
// Kernel C, `coo_gather<Layout>`, replaces `_gather_kernel` (:57,
// pl.pallas_call in `probe_gather` at :78) and `_lane_gather_kernel`
// (:182, pl.pallas_call in `probe_lane_gather` at :204): the K = 16 sums
// out[k] = sum_m val_m W[idx_m, k], with W read as (C, K) rows (layout
// `rows`, P1) or as its transpose (K, C) (layout `cols`, P3). On the TPU
// both kept the whole of W in VMEM. W at the main pool's C = 100000 is
// 6.4 MB, which no block's 227 KB of shared memory holds, so:
//
//   - where C K 4 bytes fit a block's shared memory (C <= 3616 on an
//     H100), every block copies W there once and gathers from it;
//   - otherwise W's rows are read through L2 (50 MB, which holds W), a
//     row as four 16-byte loads in layout `rows`, and in layout `cols` as
//     16 values C apart, one load each: the cost P3 asks about.
//
// What bounds C on an H100: the bytes of idx and val (8 a nonzero, 33.6
// MB at 4,194,304 nonzeros) and of W once, 40 MB, 0.012 ms at 3.35 TB/s;
// but each nonzero also reads a random 64-byte row of W, 268 MB from L2
// in all, which is what the design cannot avoid. Each thread walks the
// nonzeros with a grid stride (neighbouring threads on neighbouring
// nonzeros, so idx and val are read coalesced), keeps its K sums in
// registers, and each block sums its threads' in a fixed order (a
// shuffle tree in each warp, then the warps in order) into one row of a
// (blocks, K) buffer.
//
// Kernel D, `coo_scatter`, replaces `_scatter_kernel` (:99, pl.pallas_call
// in `probe_scatter` at :123): out[r_m, c_m] += v_m into one 8 x 128
// float32 tile. Each block zeroes its own tile in shared memory, adds its
// nonzeros into it with shared-memory atomicAdd (which the TPU could not
// do: "Cannot store scalars to VMEM"), and writes it to one row of a
// (blocks, 1024) buffer. What bounds it: the bytes of r, c and v, 12 a
// nonzero, 50 MB at 4,194,304 nonzeros, 0.015 ms at 3.35 TB/s.
//
// A second pass (`sum_rows_kernel`) adds the blocks' rows in block order,
// so C and D give the same sums from run to run on one card: the grid is
// fixed by the card's SM count and the number of nonzeros. Within a block
// D's atomics add in no fixed order (a tile bin's sum is one of its
// orders; chip_smoke.py bounds it by Higham's bound). Out-of-range
// indices add nothing.
//
// Interface: plain C entry points, loaded with ctypes. Each launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError()
// (or cudaErrorInvalidValue for what it does not take).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kK = 16;             // columns of W
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;    // blocks a multiprocessor, unstaged
constexpr int kTileRows = 8, kTileCols = 128;
constexpr int kTile = kTileRows * kTileCols;
constexpr int kRedBytes = kWarps * kK * 4;  // the block sum's static smem

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, attr, dev) != cudaSuccess)
    return 0;
  return v;
}

// Does W (n_cell x K float32) fit a block's shared memory?
bool gather_staged(long long n_cell) {
  const long long optin =
      device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  return n_cell > 0 && n_cell * kK * 4 + kRedBytes <= optin;
}

// Blocks of a COO pass: one a multiprocessor when W is staged (its
// shared memory holds one), else kBlocksPerSm; never more than the
// nonzeros need.
long long coo_grid(long long nnz, bool staged) {
  const long long sms = device_attr(cudaDevAttrMultiProcessorCount);
  const long long full = sms * (staged ? 1 : kBlocksPerSm);
  const long long need = (nnz + kThreads - 1) / kThreads;
  return need < full ? need : full;
}

template <bool kCols, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    coo_gather_kernel(const int* __restrict__ idx,
                      const float* __restrict__ val,
                      const float* __restrict__ w, long long nnz, int C,
                      float* __restrict__ partials) {
  extern __shared__ float4 w_smem[];
  __shared__ float red[kWarps * kK];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if constexpr (kStaged) {
    const float4* src = reinterpret_cast<const float4*>(w);
    for (int i = tid; i < C * (kK / 4); i += kThreads) w_smem[i] = src[i];
    __syncthreads();
  }
  const float* ws = reinterpret_cast<const float*>(w_smem);
  float acc[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) acc[k] = 0.f;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long m = (long long)blockIdx.x * kThreads + tid; m < nnz;
       m += stride) {
    const int j = idx[m];
    const float v = val[m];
    if ((unsigned)j >= (unsigned)C) continue;
    if constexpr (!kCols) {
#pragma unroll
      for (int q = 0; q < kK / 4; ++q) {
        const float4 x =
            kStaged ? w_smem[(long long)j * (kK / 4) + q]
                    : __ldg(reinterpret_cast<const float4*>(w) +
                            (long long)j * (kK / 4) + q);
        acc[4 * q] = fmaf(v, x.x, acc[4 * q]);
        acc[4 * q + 1] = fmaf(v, x.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(v, x.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(v, x.w, acc[4 * q + 3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        const long long at = (long long)k * C + j;
        acc[k] = fmaf(v, kStaged ? ws[at] : __ldg(w + at), acc[k]);
      }
    }
  }
  // the block's sums in a fixed order: a shuffle tree a warp, then the
  // warps in order
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    float s = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xFFFFFFFFu, s, off);
    if (lane == 0) red[warp * kK + k] = s;
  }
  __syncthreads();
  if (tid < kK) {
    float s = 0.f;
    for (int i = 0; i < kWarps; ++i) s += red[i * kK + tid];
    partials[(long long)blockIdx.x * kK + tid] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
    coo_scatter_kernel(const int* __restrict__ r, const int* __restrict__ c,
                       const float* __restrict__ v, long long nnz,
                       float* __restrict__ partials) {
  __shared__ float tile[kTile];
  const int tid = threadIdx.x;
  for (int i = tid; i < kTile; i += kThreads) tile[i] = 0.f;
  __syncthreads();
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long m = (long long)blockIdx.x * kThreads + tid; m < nnz;
       m += stride) {
    const int ri = r[m], ci = c[m];
    if ((unsigned)ri < (unsigned)kTileRows &&
        (unsigned)ci < (unsigned)kTileCols)
      atomicAdd(&tile[ri * kTileCols + ci], v[m]);
  }
  __syncthreads();
  for (int i = tid; i < kTile; i += kThreads)
    partials[(long long)blockIdx.x * kTile + i] = tile[i];
}

// out[j] = sum over b of part[b, j], b in order.
__global__ void sum_rows_kernel(const float* __restrict__ part, int rows,
                                int width, float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= width) return;
  float s = 0.f;
  for (int b = 0; b < rows; ++b) s += part[(long long)b * width + j];
  out[j] = s;
}

cudaError_t sum_rows(const float* part, int rows, int width, float* out,
                     cudaStream_t s) {
  sum_rows_kernel<<<(width + 255) / 256, 256, 0, s>>>(part, rows, width,
                                                      out);
  return cudaGetLastError();
}

template <bool kCols, bool kStaged>
cudaError_t launch_gather(const int* idx, const float* val, const float* w,
                          long long nnz, int C, float* partials, int blocks,
                          cudaStream_t s) {
  auto kernel = coo_gather_kernel<kCols, kStaged>;
  const size_t smem = kStaged ? (size_t)C * kK * 4 : 0;
  if (kStaged) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, kThreads, smem, s>>>(idx, val, w, nnz, C, partials);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* vireo_probe_coo_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// 1 where coo_gather stages W of n_cell rows in shared memory, else 0.
int vireo_probe_coo_gather_staged(long long n_cell) {
  return gather_staged(n_cell) ? 1 : 0;
}

// The blocks of kernel C (staged 1 or 0) or D (staged 0), and so the
// rows of its partial sums, for nnz nonzeros.
long long vireo_probe_coo_blocks(long long nnz, int staged) {
  return coo_grid(nnz, staged != 0);
}

// idx: nnz int32 < C; val: nnz float32; w: (C, 16) float32 (cols 0) or
// its transpose (16, C) (cols 1), 16-byte aligned; partials: (blocks, 16)
// float32 scratch, blocks = vireo_probe_coo_blocks(nnz, staged(C));
// out: 16 float32.
int vireo_probe_coo_gather(const void* idx, const void* val, const void* w,
                           long long nnz, int C, int cols, void* partials,
                           long long blocks, void* out, void* stream) {
  const bool staged = gather_staged(C);
  cudaStream_t s = (cudaStream_t)stream;
  if (nnz <= 0 || C <= 0 || ((uintptr_t)w & 15) ||
      blocks != coo_grid(nnz, staged) || blocks <= 0 || blocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int* i = (const int*)idx;
  const float *v = (const float*)val, *wf = (const float*)w;
  float* part = (float*)partials;
  cudaError_t err;
  if (cols)
    err = staged ? launch_gather<true, true>(i, v, wf, nnz, C, part,
                                             (int)blocks, s)
                 : launch_gather<true, false>(i, v, wf, nnz, C, part,
                                              (int)blocks, s);
  else
    err = staged ? launch_gather<false, true>(i, v, wf, nnz, C, part,
                                              (int)blocks, s)
                 : launch_gather<false, false>(i, v, wf, nnz, C, part,
                                               (int)blocks, s);
  if (err != cudaSuccess) return (int)err;
  return (int)sum_rows(part, (int)blocks, kK, (float*)out, s);
}

// r, c: nnz int32 (r < 8, c < 128); v: nnz float32; partials: (blocks,
// 1024) float32 scratch, blocks = vireo_probe_coo_blocks(nnz, 0); out:
// the (8, 128) float32 tile.
int vireo_probe_coo_scatter(const void* r, const void* c, const void* v,
                            long long nnz, void* partials, long long blocks,
                            void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nnz <= 0 || blocks != coo_grid(nnz, false) || blocks <= 0 ||
      blocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  coo_scatter_kernel<<<(int)blocks, kThreads, 0, s>>>(
      (const int*)r, (const int*)c, (const float*)v, nnz, (float*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)sum_rows((const float*)partials, (int)blocks, kTile,
                       (float*)out, s);
}

}  // extern "C"
