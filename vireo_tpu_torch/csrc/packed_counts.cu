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
// K3 on the tensor cores: out = AD^T Wa + DP^T Wd, cells are M and the
// variants are contracted. What bounds it on an H100, at the warm
// restarts' shape (V = 30000, C = 100000, N = 320): the wrapper splits
// Wa and Wd into three bf16 terms each, as for K2, written K-major as
// B = (6, N, ldv) bf16, ldv = V rounded up to a multiple of 8 (115 MB at
// N = 320), so the tensor work is 3 x 2 x 2V x C x N = 11.5 TFLOP,
// 11.65 ms at 989 TFLOP/s, against 3.2 GB of inputs and output (0.96 ms
// at 3.35 TB/s): it is bound by operations. The counts are row-major
// with the cells contiguous, so A = counts^T is M-major; as in K1's
// E-step, A is built in registers from a staged tile of 64 variants x
// the block's bytes (`hopper::mmajor_frag` with the nibble codec): a
// warp's fragment rows g and g + 8 are cells 2j and 2j + 1, the low and
// high nibble of one byte j, and each register pairs one nibble of two
// variant rows, so two staged bytes give two A registers. Each k-block
// of 64 variants is summed in fresh accumulators (24 MMAs: 4 k16 steps
// x 2 matrices x 3 terms) and added to float32 sums on the CUDA cores,
// since the tensor cores truncate into their accumulators at every k16
// step (kRowsMaxTile in hopper_gemm.cuh). Stores go straight to cell
// order; cell C of an odd C (the padding nibble) is not stored.
//
// What limits the design is B's traffic. Every block streams the whole
// of its column tile of B, 6 x V x BN x 2 bytes, through its ring, so
// B's bytes in all are (C / cells a block) x 6 x V x N x 2: 90 GB at
// warm with 128-cell blocks, twice K2's 45 GB, from L2 (the blocks in
// flight walk the variants in step). So a block owns 256 cells, two
// m64 tiles a warpgroup, which halves that to 45 GB (23 MB a block at
// 64 columns): the cheapest of the cuts, as it needs neither a cluster
// with TMA multicast nor the counts converted into shared memory for
// the transposed product. Its price is registers: two accumulator sets
// (the k-block's and the float32 sums) of BN / 2 floats for each tile,
// 2 x 2 x 32 at BN = 64, and the two tiles' A fragments, 2 x 32; so
// the widest tile is kLoglikMaxTile = 64 columns. Shared memory: a
// stage of B at 64 columns is 6 x 64 x 64 x 2 = 48 KB and the counts
// 2 x 64 x (128 + 16) = 18 KB, so three stages fit. The tiles' MMAs are
// committed as two groups: tile 1's fragments are built while tile 0's
// MMAs run, and tile 0's sums are added while tile 1's run. Keeping a
// group in flight across k-blocks as well (the next k-block's tile 0
// built while tile 1 runs), which leaves one stage of the ring filling
// instead of two, was slower on an H100 at every shape (PERF.md). The
// 128-cell design (one tile a warpgroup, up to 80 columns, as K2) was
// within ~5% of this one either way: faster at N = 16, slower at warm.
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

using namespace hopper;

constexpr int kLoglikMaxTile = 64;  // widest column tile
constexpr int kLoglikTiles = 2;     // m64 tiles of cells a warpgroup
constexpr int kWeightPlanes = 6;    // three terms each of Wa^T and Wd^T

// K3's block: kLoglikTiles m64 tiles of cells a warpgroup (256 cells a
// block), BN columns, k-blocks of 64 variants.
template <int BN_>
struct LoglikShape {
  static constexpr int BN = BN_;
  static constexpr int BK = kKBlock;                  // variants a k-block
  static constexpr int CELLS = kBlockRows * kLoglikTiles;  // cells a block
  static constexpr int BYTES = CELLS / 2;             // packed bytes a row
  static constexpr int A_PITCH = BYTES + 16;
  static constexpr int B_BYTES = kWeightPlanes * BK * BN * 2;
  static constexpr int A_BYTES = 2 * BK * A_PITCH;
  static constexpr int STAGE = B_BYTES + A_BYTES;
  static constexpr int STAGES = ring_depth(STAGE);
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + kSmemAlign;
  static_assert(STAGES >= 2, "a ring needs two stages");
  static_assert(STAGE % kSmemAlign == 0, "stages keep the alignment");
};

template <int BN>
__global__ void __launch_bounds__(kBlockThreads, 1)
    loglik_kernel(const uint8_t* __restrict__ ad,
                  const uint8_t* __restrict__ dp, long long row_bytes,
                  int V, long long C,
                  const __grid_constant__ CUtensorMap b_map,
                  float* __restrict__ out, int N, int n_tiles) {
  using S = LoglikShape<BN>;
  constexpr int MT = kLoglikTiles;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  __shared__ uint64_t b_full[S::STAGES];
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const long long j0 = (long long)(blockIdx.x / n_tiles) * S::BYTES;
  const int n0 = (blockIdx.x % n_tiles) * S::BN;
  const int nkb = (V + S::BK - 1) / S::BK;

  auto stage = [&](int i) { return smem + (size_t)i * S::STAGE; };
  // B by TMA (one thread), the counts by every thread's cp.async
  auto load = [&](int t) {
    uint8_t* st = stage(t % S::STAGES);
    const long long v0 = (long long)t * S::BK;
    if (tid == 0)
      load_b<kWeightPlanes, S::BN, S::BK>(st, &b_map, &b_full[t % S::STAGES],
                                          n0, (int)v0);
    load_byte_rows<S::BK, S::BYTES>(st + S::B_BYTES, ad, v0, V, row_bytes,
                                    j0);
    load_byte_rows<S::BK, S::BYTES>(st + S::B_BYTES + S::BK * S::A_PITCH, dp,
                                    v0, V, row_bytes, j0);
  };

  // part: one k-block's sums, formed by the tensor cores; acc: the sums
  // over all k-blocks, added to in float32 on the CUDA cores
  float acc[MT][BN / 2], part[MT][BN / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mt][i] = part[mt][i] = 0.f;

  if (tid == 0)
    for (int i = 0; i < S::STAGES; ++i) mbar_init(&b_full[i]);
  __syncthreads();
#pragma unroll
  for (int t = 0; t < S::STAGES - 1; ++t) {
    if (t < nkb) load(t);
    cp_async_commit();
  }

  // the byte, within the block's, that holds this thread's two cells of
  // tile mt (fragment rows g and g + 8: cells 2j and 2j + 1)
  auto cell_byte = [&](int mt) { return (wg * MT + mt) * 32 + warp * 8 + g; };

  for (int t = 0; t < nkb; ++t) {
    cp_async_wait<S::STAGES - 2>();
    __syncthreads();
    mbar_wait(&b_full[t % S::STAGES], (t / S::STAGES) & 1);

    const uint8_t* st = stage(t % S::STAGES);
    const long long v0 = (long long)t * S::BK;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t frag[2][S::BK / 16][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint8_t* src = m ? dp : ad;
        const uint8_t* base = st + S::B_BYTES + m * S::BK * S::A_PITCH;
#pragma unroll
        for (int s = 0; s < S::BK / 16; ++s) {
          const uint8_t* p[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            // variants 16s + 2c, +1, +8, +9 of the k-block
            const int r = 16 * s + 2 * c + (q & 1) + 8 * (q >> 1);
            p[q] = byte_row(base + r * S::A_PITCH, src, v0 + r, row_bytes,
                            j0) +
                   cell_byte(mt);
          }
          mmajor_frag<Nibbles>(frag[m][s], p);
        }
      }
      fence_regs(part[mt]);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < S::BK / 16; ++s)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            const int more = s > 0 || m > 0 || p > 0;  // the first sets part
            wgmma_rs<BN>(part[mt], frag[m][s],
                         b_desc<BN, S::BK>(st, 3 * m + p, s), more);
          }
      wgmma_commit();
    }
    // the slot of k-block t - 1, which every warpgroup has finished
    if (t + S::STAGES - 1 < nkb) load(t + S::STAGES - 1);
    cp_async_commit();
    // each tile's sums are added once its group is done, the last tile's
    // MMAs still running while the others' are added
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt + 1 < MT)
        wgmma_wait<MT - 1>();
      else
        wgmma_wait<0>();
      fence_regs(part[mt]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mt][i] += part[mt][i];
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const long long cell = 2 * (j0 + cell_byte(mt));
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const long long cl = cell + ((i >> 1) & 1);
      const int n = n0 + 8 * (i >> 2) + 2 * c + (i & 1);
      if (cl < C && n < N) out[cl * N + n] = acc[mt][i];
    }
  }
}

// b: (6, N, ldv) bf16, the variants of each row contiguous (see
// hopper::encode_b).
template <int BN>
cudaError_t launch_loglik(const uint8_t* ad, const uint8_t* dp, int V,
                          long long C, const void* b, long long ldv,
                          float* out, int N, cudaStream_t s) {
  using Sh = LoglikShape<BN>;
  auto kernel = loglik_kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::SMEM);
  if (err != cudaSuccess) return err;
  const long long row_bytes = (C + 1) / 2;
  const long long n_tiles = (N + Sh::BN - 1) / Sh::BN;
  const long long blocks = n_tiles * ((row_bytes + Sh::BYTES - 1) / Sh::BYTES);
  CUtensorMap b_map;
  if (blocks <= 0 || blocks > INT_MAX || V > INT_MAX - Sh::BK ||
      !encode_b(&b_map, b, kWeightPlanes, N, V, ldv, Sh::BN))
    return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kBlockThreads, Sh::SMEM, s>>>(
      ad, dp, row_bytes, V, C, b_map, out, N, (int)n_tiles);
  return cudaGetLastError();
}

// Dispatch on the tile pick_tile gives for the block's cells.
cudaError_t launch_loglik_any(const uint8_t* ad, const uint8_t* dp, int V,
                              long long C, const void* b, long long ldv,
                              float* out, int N, cudaStream_t s) {
  switch (pick_tile(N, kLoglikMaxTile, 16)) {
#define VIREO_LOGLIK(BN)                                                   \
  case BN:                                                                 \
    return launch_loglik<BN>(ad, dp, V, C, b, ldv, out, N, s);
    VIREO_LOGLIK(16) VIREO_LOGLIK(32) VIREO_LOGLIK(48) VIREO_LOGLIK(64)
#undef VIREO_LOGLIK
  }
  return cudaErrorInvalidValue;
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

// ad_p, dp_p: (V, ceil(C / 2)) uint8. b6: (6, N, ldv) bf16, the three
// terms of Wa^T, then of Wd^T, variants contiguous, ldv >= V a multiple
// of 8. out: (C, N) float32, cell order.
int vireo_packed_cell_loglik(const void* ad_p, const void* dp_p,
                             const void* b6, void* out, int V, int C, int N,
                             int ldv, void* stream) {
  if (V <= 0 || C <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  return (int)launch_loglik_any((const uint8_t*)ad_p, (const uint8_t*)dp_p,
                                V, C, b6, ldv, (float*)out, N,
                                (cudaStream_t)stream);
}

}  // extern "C"
