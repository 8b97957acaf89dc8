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
// Kernel D, `coo_scatter_kernel`, replaces `_scatter_kernel` (:99,
// pl.pallas_call in `probe_scatter` at :123): out[r_m, c_m] += v_m into
// one 8 x 128 float32 tile, in one launch and in one fixed order, with no
// atomics on the tile. The JAX kernel adds the nonzeros one by one in
// grid order; 132 SMs cannot, so D fixes another order, stated here and
// emulated on the host by probes/coo_pallas_probe.py::coo_scatter_in_order:
//
//   The plan (`vireo_probe_coo_scatter_shape`; its host copy is
//   coo_pallas_probe.scatter_plan) gives warp w (w = 32 block + warp of
//   `blocks` x 32) the nonzeros [w P, min(w P + P, nnz)), P = `per_warp`
//   a multiple of 4. A warp walks its range in steps of 128: in step s
//   lane l holds nonzeros w P + 128 s + 4 l + e, e = 0..3. For e = 0..3
//   in turn (a round), the lanes whose nonzero lands in the same bin form
//   a group; the group's lowest lane adds the group's values in lane
//   order (its own, then each higher lane's) and adds that sum into its
//   warp's own tile in shared memory. A bin of the block's row is 0 + its
//   32 warps' entries in warp order; the rows of each `group` consecutive
//   blocks are added in block order (from 0) into a group row, and out is
//   0 + the `groups` group rows in group order. Each add is one float32
//   add rounded to nearest, so the plan fixes every bit of out; a term
//   passes through at most depth = 31 + 4 steps + 32 + group + groups
//   adds (`steps` = ceil(P / 128)), which bounds the error: gamma_depth
//   sum|terms| a bin (Higham).
//
// A round finds its groups cheaply: each lane writes its lane number into
// a byte tag of its bin (a 1 KB tag array a warp) and reads it back; only
// where a lane reads another's (about one round in three on random bins)
// does one ballot a shared bin find that bin's lanes, whose values go to
// the lowest by shuffles. (__match_any_sync on every round, or ten
// ballots on the key's bits, give the same groups and took longer.)
//
// The second pass is folded in: each block writes its row into scratch
// and takes a ticket of its group (atom.inc, release and acquire at the
// card's scope); the group's last block to arrive adds the group's rows
// into its group row and takes a ticket of the grid, and the last of
// those writes out. Who adds depends on timing; what is added and in
// which order does not. atom.inc wraps each ticket back to 0, so the
// wrapper zeroes the tickets once and keeps them. Groups of
// ceil(sqrt(blocks)) keep each fold at ~12 rows (48 KB from L2) where one
// block folding 132 rows would read 540 KB alone.
//
// What bounds D: the bytes of r, c and v, 12 a nonzero, 50.3 MB at
// 4,194,304 nonzeros, 0.0150 ms at 3.35 TB/s. One block of 1024 threads
// an SM (32 tiles of 4 KB and 32 tag arrays of 1 KB: 160 KB of shared
// memory), each warp a range read as 16-byte vectors, two steps loaded
// ahead of the one it adds: 32 x 2 x 1.5 KB = 96 KB in flight an SM,
// above the ~25 KB that 3.35 TB/s over 132 SMs needs at ~1 us of latency
// (Little's law). The two folds after the last block's range, each a
// ticket and a read of ~12 rows from L2, are latency the bytes do not
// hide.
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

constexpr int kTileRows = 8, kTileCols = 128;
constexpr int kTile = kTileRows * kTileCols;
constexpr int kScatterThreads = kTile;  // a block of D: thread j, bin j
constexpr int kScatterWarps = kScatterThreads / 32;
constexpr int kVec = 4;                 // nonzeros a lane a step
constexpr int kScatterStep = 32 * kVec; // nonzeros a warp a step
// a tile (float) and a tag array (byte) a warp
constexpr int kScatterSmem = kScatterWarps * kTile * 5;

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

// Kernel D's plan for nnz nonzeros on `sms` SMs (the host's copy is
// coo_pallas_probe.scatter_plan): out[0] blocks, out[1] threads a block,
// out[2] warps a block, out[3] per_warp (the nonzeros a warp, a multiple
// of kVec, at least one step), out[4] kVec, out[5] steps a warp, out[6]
// blocks a group (ceil(sqrt(blocks))), out[7] groups, out[8] the depth
// of the sums' tree.
bool scatter_plan(long long nnz, long long sms, long long* out) {
  if (nnz <= 0 || sms <= 0) return false;
  const long long slots = sms * kScatterWarps;
  long long per = (nnz + slots - 1) / slots;
  per = (per + kVec - 1) / kVec * kVec;
  if (per < kScatterStep) per = kScatterStep;
  const long long span = (long long)kScatterWarps * per;
  const long long blocks = (nnz + span - 1) / span;
  long long group = 1;
  while (group * group < blocks) ++group;
  const long long groups = (blocks + group - 1) / group;
  const long long steps = (per + kScatterStep - 1) / kScatterStep;
  out[0] = blocks;
  out[1] = kScatterThreads;
  out[2] = kScatterWarps;
  out[3] = per;
  out[4] = kVec;
  out[5] = steps;
  out[6] = group;
  out[7] = groups;
  out[8] = 31 + kVec * steps + kScatterWarps + group + groups;
  return true;
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

// One step's nonzeros of a lane: a 16-byte vector of r, c and v each
// where all four lie in the warp's range, else one by one; a slot past
// the range has r = -1 (out of the tile: it adds nothing).
struct Slot {
  int r[kVec], c[kVec];
  float v[kVec];
};

__device__ __forceinline__ void load_slot(const int* __restrict__ r,
                                          const int* __restrict__ c,
                                          const float* __restrict__ v,
                                          long long m, long long end,
                                          Slot& s) {
  if (m + kVec <= end) {
    const int4 a = __ldcs(reinterpret_cast<const int4*>(r + m));
    const int4 b = __ldcs(reinterpret_cast<const int4*>(c + m));
    const float4 x = __ldcs(reinterpret_cast<const float4*>(v + m));
    s.r[0] = a.x, s.r[1] = a.y, s.r[2] = a.z, s.r[3] = a.w;
    s.c[0] = b.x, s.c[1] = b.y, s.c[2] = b.z, s.c[3] = b.w;
    s.v[0] = x.x, s.v[1] = x.y, s.v[2] = x.z, s.v[3] = x.w;
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const bool in = m + e < end;
      s.r[e] = in ? r[m + e] : -1;
      s.c[e] = in ? c[m + e] : 0;
      s.v[e] = in ? v[m + e] : 0.f;
    }
  }
}

// One nonzero a lane into the warp's tile, in lane order. Each lane in
// the tile writes its lane number into its bin's tag; a lane that reads
// back another's shares its bin ("lost"). Where no lane lost (about two
// rounds in three on random bins), every lane adds its value into its
// own bin. Else, for each bin that a lane lost, one ballot finds the
// bin's lanes; the lowest adds the others' values in lane order, and only
// it adds into the tile. A lane out of the tile adds nothing.
__device__ __forceinline__ void add_in_lane_order(float* tile,
                                                  unsigned char* tag, int ri,
                                                  int ci, float vi,
                                                  int lane) {
  const bool in = (unsigned)ri < (unsigned)kTileRows &&
                  (unsigned)ci < (unsigned)kTileCols;
  const int key = in ? ri * kTileCols + ci : 0;
  if (in) tag[key] = (unsigned char)lane;
  __syncwarp();
  unsigned lost = __ballot_sync(0xFFFFFFFFu, in && tag[key] != lane);
  float s = vi;
  bool add = in;
  while (lost) {
    const int bin = __shfl_sync(0xFFFFFFFFu, key, __ffs(lost) - 1);
    const unsigned group = __ballot_sync(0xFFFFFFFFu, in && key == bin);
    const int lead = __ffs(group) - 1;
    for (unsigned rest = group & (group - 1); rest; rest &= rest - 1) {
      const float x = __shfl_sync(0xFFFFFFFFu, vi, __ffs(rest) - 1);
      if (lane == lead) s += x;
    }
    if ((group >> lane & 1u) && lane != lead) add = false;
    lost &= ~group;
  }
  if (add) tile[key] += s;
  __syncwarp();
}

// True in the block that arrives last of `n` at `ticket`, which it leaves
// at 0 (atom.inc wraps); the rows written before the call by every block
// that arrived are visible to it (release and acquire at the card's
// scope, the barrier carrying the block's other threads' writes).
__device__ __forceinline__ bool last_to_arrive(unsigned* ticket,
                                               unsigned n) {
  static __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
                 : "=r"(old)
                 : "l"(ticket), "r"(n - 1)
                 : "memory");
    last = old == n - 1;
  }
  __syncthreads();
  return last;
}

// 0 + rows row0 .. row0 + n - 1 of bin tid in order, read from L2 sixteen
// at a time.
__device__ __forceinline__ float fold_rows(const float* rows, long long row0,
                                           int n, int tid) {
  float acc = 0.f;
  for (int b0 = 0; b0 < n; b0 += 16) {
    float x[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      x[i] = b0 + i < n ? __ldcg(rows + (row0 + b0 + i) * kTile + tid) : 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (b0 + i < n) acc += x[i];
  }
  return acc;
}

// rows: (blocks + groups, kTile) float32 scratch, a row a block, then a
// row a group; tickets: groups + 1 counters, 0 before the launch and
// after it. Dynamic shared memory: kScatterSmem.
__global__ void __launch_bounds__(kScatterThreads, 1)
    coo_scatter_kernel(const int* __restrict__ r, const int* __restrict__ c,
                       const float* __restrict__ v, long long nnz,
                       long long per_warp, int group, int groups,
                       float* __restrict__ rows, unsigned* tickets,
                       float* __restrict__ out) {
  extern __shared__ float4 tiles4[];
  float* tiles = reinterpret_cast<float*>(tiles4);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float* tile = tiles + warp * kTile;
  unsigned char* tag =
      reinterpret_cast<unsigned char*>(tiles + kScatterWarps * kTile) +
      warp * kTile;
  for (int i = lane; i < kTile / 4; i += 32)
    tiles4[warp * (kTile / 4) + i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();

  // the warp's range, two steps loaded ahead of the one it adds
  const long long w0 =
      ((long long)blockIdx.x * kScatterWarps + warp) * per_warp;
  const long long w1 = w0 + per_warp < nnz ? w0 + per_warp : nnz;
  const long long steps =
      w0 < w1 ? (w1 - w0 + kScatterStep - 1) / kScatterStep : 0;
  const long long m0 = w0 + kVec * lane;
  Slot cur, next, after;
  if (steps > 0) load_slot(r, c, v, m0, w1, cur);
  if (steps > 1) load_slot(r, c, v, m0 + kScatterStep, w1, next);
  for (long long st = 0; st < steps; ++st) {
    if (st + 2 < steps)
      load_slot(r, c, v, m0 + (st + 2) * kScatterStep, w1, after);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      add_in_lane_order(tile, tag, cur.r[e], cur.c[e], cur.v[e], lane);
    cur = next;
    next = after;
  }
  __syncthreads();

  // the block's row: bin tid, its warps in order
  float p = 0.f;
#pragma unroll 8
  for (int w = 0; w < kScatterWarps; ++w) p += tiles[w * kTile + tid];
  rows[(long long)blockIdx.x * kTile + tid] = p;

  const int g = blockIdx.x / group, first = g * group;
  const int n = min(group, (int)gridDim.x - first);
  if (!last_to_arrive(tickets + g, n)) return;
  rows[((long long)gridDim.x + g) * kTile + tid] =
      fold_rows(rows, first, n, tid);
  if (!last_to_arrive(tickets + groups, groups)) return;
  out[tid] = fold_rows(rows, gridDim.x, groups, tid);
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

// D's shared memory above 48 KB, asked once for each card.
cudaError_t scatter_attributes() {
  constexpr int kCards = 64;
  static bool done[kCards];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kCards && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(coo_scatter_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kScatterSmem);
  if (err == cudaSuccess && dev < kCards) done[dev] = true;
  return err;
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

// Kernel D's plan for nnz nonzeros on the current card, into out[9]
// (see scatter_plan). Returns 0, or cudaErrorInvalidValue.
int vireo_probe_coo_scatter_shape(long long nnz, long long* out) {
  const long long sms = device_attr(cudaDevAttrMultiProcessorCount);
  return scatter_plan(nnz, sms, out) ? 0 : (int)cudaErrorInvalidValue;
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

// r, c: nnz int32 (r < 8, c < 128; others add nothing); v: nnz float32;
// all three 16-byte aligned. blocks, per_warp, group: a plan's (out[0],
// out[3], out[6]; any plan that covers nnz gives the sums, that one their
// order). rows: (rows_cap, 1024) float32 scratch, at least blocks +
// ceil(blocks / group) rows; tickets: tickets_cap unsigned counters, at
// least ceil(blocks / group) + 1, zero before the first launch (each
// launch leaves them zero). Launches on one stream may share the scratch;
// launches that may overlap need their own. out: the (8, 128) float32
// tile.
int vireo_probe_coo_scatter(const void* r, const void* c, const void* v,
                            long long nnz, long long blocks,
                            long long per_warp, long long group, void* rows,
                            long long rows_cap, void* tickets,
                            long long tickets_cap, void* out,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nnz <= 0 || blocks <= 0 || blocks > INT_MAX || per_warp <= 0 ||
      per_warp % kVec || group <= 0 || group > blocks ||
      blocks * kScatterWarps * per_warp < nnz || ((uintptr_t)r & 15) ||
      ((uintptr_t)c & 15) || ((uintptr_t)v & 15))
    return (int)cudaErrorInvalidValue;
  const long long groups = (blocks + group - 1) / group;
  if (blocks + groups > rows_cap || groups + 1 > tickets_cap ||
      rows == nullptr || tickets == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = scatter_attributes();
  if (err != cudaSuccess) return (int)err;
  coo_scatter_kernel<<<(int)blocks, kScatterThreads, kScatterSmem, s>>>(
      (const int*)r, (const int*)c, (const float*)v, nnz, per_warp,
      (int)group, (int)groups, (float*)rows, (unsigned*)tickets,
      (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
