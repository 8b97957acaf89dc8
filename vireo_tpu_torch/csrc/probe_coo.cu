// The COO probes of benchmarks/coo_pallas_probe.py on Hopper: kernels C
// and D.
//
// Kernel C, `coo_gather_kernel<Stage>`, replaces `_gather_kernel` (:57,
// pl.pallas_call in `probe_gather` at :78) and `_lane_gather_kernel`
// (:182, pl.pallas_call in `probe_lane_gather` at :204): the K = 16 sums
// out[k] = sum_m val_m W[idx_m, k], with W read as (C, K) rows (layout
// `rows`, P1) or as its transpose (K, C) (layout `cols`, P3). On the TPU
// both kept the whole of W in VMEM. W at the main pool's C = 100000 is
// 6.4 MB, which no block's 227 KB of shared memory holds, so:
//
//   - where C K 4 bytes fit a block's shared memory (C <= 3600 on an
//     H100), one block of 1024 threads an SM copies W there once (a
//     `cols` W transposed on the way) and gathers from it;
//   - otherwise W's rows are read through L2 (50 MB, which holds W); a
//     `cols` W is first transposed into a (C, K) scratch by one coalesced
//     pass (`transpose_kernel`, 6.4 MB read and written at C = 100000),
//     so both layouts gather rows.
//
// What bounds C on an H100: the bytes of idx and val (8 a nonzero, 33.6
// MB at 4,194,304 nonzeros) and of W once, 40 MB, 0.012 ms at 3.35 TB/s;
// but each nonzero also reads a random 64-byte row of W, 268 MB from L2
// in all, which is what the design cannot avoid, so it keeps many row
// reads in flight. Four lanes take one nonzero, each a float4 of its W
// row, and each thread keeps 4 sums. A warp takes 64 consecutive
// nonzeros a step: each quad of lanes 8 of them, whose idx and val it
// reads as 16-byte vectors (four nonzeros a load); all 8 row reads are
// issued before any FMA. Warps walk the steps with a grid stride.
//
// Sums in a fixed order, no atomics: each thread's FMAs over its
// nonzeros in order, a 3-level shuffle tree over the 8 quads of a warp,
// the warps of a block in order into one row of a (blocks, K) buffer,
// and `sum_rows_kernel` adds the blocks' rows in block order. So C
// gives the same sums from run to run on one card: the grid is fixed by
// the card's SMs, the occupancy and the number of nonzeros.
// `vireo_probe_coo_gather_shape` reports the grid and the tree's depth.
//
// Kernel D, `coo_scatter`, replaces `_scatter_kernel` (:99, pl.pallas_call
// in `probe_scatter` at :123): out[r_m, c_m] += v_m into one 8 x 128
// float32 tile. Each block zeroes its own tile in shared memory, adds its
// nonzeros into it with shared-memory atomicAdd (which the TPU could not
// do: "Cannot store scalars to VMEM"), and writes it to one row of a
// (blocks, 1024) buffer, which `sum_rows_kernel` adds in block order.
// Within a block D's atomics add in no fixed order (a tile bin's sum is
// one of its orders; chip_smoke.py bounds it by Higham's bound). What
// bounds it: the bytes of r, c and v, 12 a nonzero, 50 MB at 4,194,304
// nonzeros, 0.015 ms at 3.35 TB/s.
//
// Out-of-range indices add nothing.
//
// Interface: plain C entry points, loaded with ctypes. Each launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError()
// (or cudaErrorInvalidValue for what it does not take).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kK = 16;              // columns of W
constexpr int kGatherThreads = 512;  // a block of C, W through L2
constexpr int kStagedThreads = 1024; // a block of C, W in shared memory
constexpr int kLanes = kK / 4;       // lanes a nonzero, a float4 each
constexpr int kPerQuad = 8;          // nonzeros a quad of lanes in flight
constexpr int kWarpStep = 32 / kLanes * kPerQuad;  // nonzeros a warp step
constexpr int kShuffleLevels = 3;    // over the 8 quads of a warp
constexpr int kRedBytes = kStagedThreads / 32 * kK * 4;  // the block sum

constexpr int kThreads = 512;      // a block of D
constexpr int kBlocksPerSm = 4;    // blocks of D a multiprocessor
constexpr int kTileRows = 8, kTileCols = 128;
constexpr int kTile = kTileRows * kTileCols;

enum Stage { kNone = 0, kRows = 1, kCols = 2 };  // how C stages W

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

// Blocks of D: kBlocksPerSm a multiprocessor, never more than the
// nonzeros need.
long long scatter_grid(long long nnz) {
  const long long sms = device_attr(cudaDevAttrMultiProcessorCount);
  const long long full = sms * kBlocksPerSm;
  const long long need = (nnz + kThreads - 1) / kThreads;
  return need < full ? need : full;
}

template <int kStage>
constexpr int kThreadsOf = kStage == kNone ? kGatherThreads : kStagedThreads;

template <int kStage>
__global__ void __launch_bounds__(kThreadsOf<kStage>,
                                  kStage == kNone ? 2 : 1)
    coo_gather_kernel(const int* __restrict__ idx,
                      const float* __restrict__ val,
                      const float* __restrict__ w, long long nnz, int C,
                      float* __restrict__ partials) {
  constexpr int T = kThreadsOf<kStage>;
  constexpr int kWarps = T / 32;
  extern __shared__ float4 w_smem[];
  __shared__ float red[kWarps][kK];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int quad = lane / kLanes, sub = lane % kLanes;
  if constexpr (kStage == kRows) {
    const float4* src = reinterpret_cast<const float4*>(w);
    for (int i = tid; i < C * kLanes; i += T) w_smem[i] = src[i];
  } else if constexpr (kStage == kCols) {
    // W^T (K, C) -> rows: neighbouring threads read neighbouring cells
    for (int i = tid; i < C * kLanes; i += T) {
      const int j = i % C, q = i / C;
      const float* col = w + (long long)4 * q * C + j;
      w_smem[j * kLanes + q] =
          make_float4(col[0], col[C], col[2 * C], col[3 * C]);
    }
  }
  if constexpr (kStage != kNone) __syncthreads();
  const float4* rows =
      kStage == kNone ? reinterpret_cast<const float4*>(w) : w_smem;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const long long steps = (nnz + kWarpStep - 1) / kWarpStep;
  for (long long st = (long long)blockIdx.x * kWarps + warp; st < steps;
       st += (long long)gridDim.x * kWarps) {
    const long long m0 = st * kWarpStep + quad * kPerQuad;
    int j[kPerQuad];
    float v[kPerQuad];
    if (m0 + kPerQuad <= nnz) {
      const int4 i0 = __ldg(reinterpret_cast<const int4*>(idx + m0));
      const int4 i1 = __ldg(reinterpret_cast<const int4*>(idx + m0) + 1);
      const float4 v0 = __ldg(reinterpret_cast<const float4*>(val + m0));
      const float4 v1 = __ldg(reinterpret_cast<const float4*>(val + m0) + 1);
      j[0] = i0.x, j[1] = i0.y, j[2] = i0.z, j[3] = i0.w;
      j[4] = i1.x, j[5] = i1.y, j[6] = i1.z, j[7] = i1.w;
      v[0] = v0.x, v[1] = v0.y, v[2] = v0.z, v[3] = v0.w;
      v[4] = v1.x, v[5] = v1.y, v[6] = v1.z, v[7] = v1.w;
    } else {
#pragma unroll
      for (int e = 0; e < kPerQuad; ++e) {
        const bool in = m0 + e < nnz;
        j[e] = in ? idx[m0 + e] : -1;
        v[e] = in ? val[m0 + e] : 0.f;
      }
    }
    // every row read first, then the FMAs
    float4 x[kPerQuad];
#pragma unroll
    for (int e = 0; e < kPerQuad; ++e) {
      const long long at = (long long)j[e] * kLanes + sub;
      x[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      if ((unsigned)j[e] < (unsigned)C)
        x[e] = kStage == kNone ? __ldg(rows + at) : rows[at];
    }
#pragma unroll
    for (int e = 0; e < kPerQuad; ++e)
      if ((unsigned)j[e] < (unsigned)C) {
        acc[0] = fmaf(v[e], x[e].x, acc[0]);
        acc[1] = fmaf(v[e], x[e].y, acc[1]);
        acc[2] = fmaf(v[e], x[e].z, acc[2]);
        acc[3] = fmaf(v[e], x[e].w, acc[3]);
      }
  }
  // the block's sums in a fixed order: a shuffle tree over the quads of
  // a warp (lanes 0-3 keep columns 4 sub .. 4 sub + 3), then the warps
  // in order
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float s = acc[k];
#pragma unroll
    for (int off = 16; off >= kLanes; off >>= 1)
      s += __shfl_down_sync(0xFFFFFFFFu, s, off);
    if (lane < kLanes) red[warp][4 * sub + k] = s;
  }
  __syncthreads();
  if (tid < kK) {
    float s = 0.f;
    for (int i = 0; i < kWarps; ++i) s += red[i][tid];
    partials[(long long)blockIdx.x * kK + tid] = s;
  }
}

// W^T (K, C) -> W (C, K): thread j writes row j as four float4 stores,
// each of K values read with neighbouring threads on neighbouring cells.
__global__ void transpose_kernel(const float* __restrict__ wt, int C,
                                 float4* __restrict__ w) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= C) return;
#pragma unroll
  for (int q = 0; q < kLanes; ++q) {
    const float* col = wt + (long long)4 * q * C + j;
    w[(long long)j * kLanes + q] =
        make_float4(col[0], col[C], col[2 * C], col[3 * C]);
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

template <int kStage>
size_t gather_smem(int C) {
  return kStage == kNone ? 0 : (size_t)C * kK * 4;
}

template <int kStage>
cudaError_t gather_attributes(int C) {
  if (kStage == kNone) return cudaSuccess;
  return cudaFuncSetAttribute(coo_gather_kernel<kStage>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)gather_smem<kStage>(C));
}

// C's grid for nnz nonzeros over n_cell cells: out[0] 1 where W is
// staged, out[1] threads a block, out[2] blocks an SM (the occupancy
// API), out[3] blocks, out[4] the most nonzeros one thread chains, out[5]
// the shuffle tree's levels, out[6] warps a block, out[7] W-row loads a
// thread has in flight. False where the occupancy query fails.
template <int kStage>
bool gather_shape(long long nnz, int n_cell, long long* out) {
  constexpr int T = kThreadsOf<kStage>;
  int per_sm = 0;
  if (gather_attributes<kStage>(n_cell) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, coo_gather_kernel<kStage>, T,
          gather_smem<kStage>(n_cell)) != cudaSuccess ||
      per_sm <= 0)
    return false;
  const long long steps = (nnz + kWarpStep - 1) / kWarpStep;
  const long long need = (steps + T / 32 - 1) / (T / 32);
  const long long full =
      (long long)device_attr(cudaDevAttrMultiProcessorCount) * per_sm;
  const long long blocks = need < full ? need : full;
  const long long warps = blocks * (T / 32);
  out[0] = kStage != kNone;
  out[1] = T;
  out[2] = per_sm;
  out[3] = blocks;
  out[4] = kPerQuad * ((steps + warps - 1) / warps);
  out[5] = kShuffleLevels;
  out[6] = T / 32;
  out[7] = kPerQuad;
  return blocks > 0;
}

bool gather_shape_any(long long nnz, int n_cell, int cols, long long* out) {
  if (!gather_staged(n_cell)) return gather_shape<kNone>(nnz, n_cell, out);
  return cols ? gather_shape<kCols>(nnz, n_cell, out)
              : gather_shape<kRows>(nnz, n_cell, out);
}

template <int kStage>
cudaError_t launch_gather(const int* idx, const float* val, const float* w,
                          long long nnz, int C, float* partials, int blocks,
                          cudaStream_t s) {
  constexpr int T = kThreadsOf<kStage>;
  cudaError_t err = gather_attributes<kStage>(C);
  if (err != cudaSuccess) return err;
  coo_gather_kernel<kStage><<<blocks, T, gather_smem<kStage>(C), s>>>(
      idx, val, w, nnz, C, partials);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* vireo_probe_coo_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Kernel C's shape for nnz nonzeros over n_cell cells in layout `cols`
// (0 rows, 1 cols), into out[8] (see gather_shape). Returns 0, or
// cudaErrorInvalidValue.
int vireo_probe_coo_gather_shape(long long nnz, int n_cell, int cols,
                                 long long* out) {
  if (nnz <= 0 || n_cell <= 0 || !gather_shape_any(nnz, n_cell, cols, out))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The blocks of kernel D, and so the rows of its partial sums, for nnz
// nonzeros.
long long vireo_probe_coo_scatter_blocks(long long nnz) {
  return scatter_grid(nnz);
}

// idx: nnz int32 < C; val: nnz float32; both 16-byte aligned. w: (C, 16)
// float32 (cols 0) or its transpose (16, C) (cols 1), 16-byte aligned.
// staged and blocks: from the shape (out[0], out[3]; any count of blocks
// gives the sums, that one their order; a W that does not fit shared
// memory fails the launch). scratch: (C, 16) float32 where cols and W is
// not staged, else unused. partials: (blocks, 16) float32; out: 16
// float32.
int vireo_probe_coo_gather(const void* idx, const void* val, const void* w,
                           long long nnz, int C, int cols, int staged,
                           void* scratch, void* partials, long long blocks,
                           void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nnz <= 0 || C <= 0 || ((uintptr_t)w & 15) || ((uintptr_t)idx & 15) ||
      ((uintptr_t)val & 15) || blocks <= 0 || blocks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int* i = (const int*)idx;
  const float *v = (const float*)val, *wf = (const float*)w;
  float* part = (float*)partials;
  cudaError_t err;
  if (staged)
    err = cols ? launch_gather<kCols>(i, v, wf, nnz, C, part, (int)blocks, s)
               : launch_gather<kRows>(i, v, wf, nnz, C, part, (int)blocks, s);
  else {
    if (cols) {
      if (scratch == nullptr || ((uintptr_t)scratch & 15))
        return (int)cudaErrorInvalidValue;
      transpose_kernel<<<(C + 255) / 256, 256, 0, s>>>(wf, C,
                                                       (float4*)scratch);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      wf = (const float*)scratch;
    }
    err = launch_gather<kNone>(i, v, wf, nnz, C, part, (int)blocks, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)sum_rows(part, (int)blocks, kK, (float*)out, s);
}

// r, c: nnz int32 (r < 8, c < 128); v: nnz float32; partials: (blocks,
// 1024) float32 scratch, blocks = vireo_probe_coo_scatter_blocks(nnz);
// out: the (8, 128) float32 tile.
int vireo_probe_coo_scatter(const void* r, const void* c, const void* v,
                            long long nnz, void* partials, long long blocks,
                            void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nnz <= 0 || blocks != scatter_grid(nnz) || blocks <= 0 ||
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
