// The dense rung's two contractions over int8 counts: K0.
//
// Replaces the XLA dots of vireo_tpu/ops/counts.py::DenseCounts (no
// Pallas kernel there): for int8 counts `_operand` (:71-76) casts AD and
// DP to bf16 inside the dot, which XLA fuses into the matmul's read, so
// each count byte is read once a contraction:
//
//   suff_stats  (:78):  S1 = AD W,  SS = DP W            (V, N) each
//   cell_loglik (:87):  out = AD^T Wa + DP^T Wd          (C, N)
//
// AD and DP are (V, C) int8 counts in [0, 127], row-major with the cells
// contiguous. A row's cells need not start on any boundary and rows may
// lie `pitch` bytes apart with pitch > C: a cell range of a wider
// matrix (DenseCounts.cell_slice) runs in place, and nothing past a
// row's C bytes is read. The weights are float32; the wrapper
// (vireo_tpu_torch/ops/counts.py) splits them into three bf16 terms,
// W = hi + mid + lo exactly (ops/packed.py::split_bf16x3), written
// K-major as B: (3, N, ldw) for suff_stats, (6, N, ldv) for cell_loglik.
// A count (< 128) times a bf16 term is exact in float32, so the kernels
// form the products the plain version sums, and each 64-deep k-block is
// summed in fresh accumulators and added to float32 sums on the CUDA
// cores (the tensor cores truncate at every k16 step: one sum there erred
// by 153 at N = 320 where this errs by 1.2, PERF.md, K2).
//
// What bounds it on an H100, at the main pool's shape (V = 30000,
// C = 100000): the counts are 6.0 GB, 1.79 ms at 3.35 TB/s, and each
// contraction is 3 x 2 x 2 V C N flops on the tensor cores, 11.65 ms at
// 989 TFLOP/s at N = 320 (the warm restarts: 20 x 16 columns), 0.58 ms
// at N = 16 (the refit). So the warm restarts are bound by operations,
// the refit by bytes. The design is K2's and K3's, with the int8 codec:
//
//   suff_stats: `hopper::rows_kernel<Int8, 3>` (hopper_gemm.cuh), K2's
//     kernel: a block owns 128 variants x at most 80 columns, walks the
//     cells in k-blocks of 64 (64 count bytes a row against K2's 32
//     packed ones) through a ring of four stages (A 2 x 128 x 80 B,
//     B 3 x 64 x 80 x 2 B = 50 KB a stage), each count pair one A
//     register, S1 and SS sharing each B tile.
//   cell_loglik: `hopper::loglik_kernel<Int8, kDenseLoglikTiles>`, K3's
//     kernel: cells as M, A built in registers from a staged tile of 64
//     variants x the block's cells (`mmajor_frag`), each register two
//     count bytes of one cell column. An int8 tile of cells takes twice
//     the shared memory of K3's packed one: at 64 columns a stage of two
//     tiles a warpgroup (256 cells, K3's shape) is 48 KB of B and
//     2 x 64 x 272 B = 34 KB of counts, 82 KB, so only two stages fit;
//     one tile a warpgroup (128 cells) keeps K3's three stages of 66 KB
//     and its registers, at the price of twice the blocks, each
//     streaming its column tile of B (90 GB from L2 at warm against
//     K3's 45 GB). Timed in turns on an H100 at the main pool's shape,
//     one tile was a few percent faster at N = 320 and two tiles about a
//     fifth faster at N = 16; over a run of the main pool (20 launches
//     at N = 320, about as many at N = 16) they come out about even, and
//     one tile keeps K3's ring depth, so this file takes one tile.
//
// No atomics: each output element is summed by one warpgroup in a fixed
// order, so results do not change between runs.
//
// Interface: plain C entry points, loaded with ctypes. Each launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError()
// (or cudaErrorInvalidValue for shapes it does not take).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

// cell_loglik's m64 tiles of cells a warpgroup (128 cells a block), as
// the file note says.
constexpr int kDenseLoglikTiles = 1;

}  // namespace

extern "C" {

const char* vireo_dense_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// ad, dp: V rows of C int8 counts, `pitch` >= C bytes apart. w3:
// (3, N, ldw) bf16, the three terms of W^T, cells contiguous, ldw >= C a
// multiple of 8. s1, ss: (V, N) float32.
int vireo_dense_suff_stats(const void* ad, const void* dp, const void* w3,
                           void* s1, void* ss, int V, int C, int N, int ldw,
                           long long pitch, void* stream) {
  if (V <= 0 || C <= 0 || N <= 0 || pitch < C)
    return (int)cudaErrorInvalidValue;
  return (int)hopper::launch_rows_any<hopper::Int8, 3, true>(
      (const uint8_t*)ad, (const uint8_t*)dp, pitch, V, w3, ldw, C,
      (float*)s1, (float*)ss, N, N, (cudaStream_t)stream);
}

// ad, dp: as above. b6: (6, N, ldv) bf16, the three terms of Wa^T, then
// of Wd^T, variants contiguous, ldv >= V a multiple of 8. out: (C, N)
// float32.
int vireo_dense_cell_loglik(const void* ad, const void* dp, const void* b6,
                            void* out, int V, int C, int N, int ldv,
                            long long pitch, void* stream) {
  if (V <= 0 || C <= 0 || N <= 0 || pitch < C)
    return (int)cudaErrorInvalidValue;
  return (int)hopper::launch_loglik_any<hopper::Int8, kDenseLoglikTiles,
                                        true>(
      (const uint8_t*)ad, (const uint8_t*)dp, pitch, V, C, b6, ldv,
      (float*)out, N, (cudaStream_t)stream);
}

}  // extern "C"
