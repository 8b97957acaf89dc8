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
// The kernel is `hopper::loglik_kernel` (hopper_gemm.cuh) with the
// nibble codec and kLoglikTiles tiles; K0 (dense_counts.cu) runs the
// same kernel on int8 rows.
//
// No atomics: each output element belongs to one thread of one block and
// is summed in a fixed order, so results do not change between runs.
//
// Interface: plain C entry points, loaded with ctypes. Each launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError()
// (or cudaErrorInvalidValue for shapes it does not take).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

// K3's block: two m64 tiles of cells a warpgroup (256 cells a block),
// as the file note says.
constexpr int kLoglikTiles = 2;

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
  return (int)hopper::launch_loglik_any<hopper::Nibbles, kLoglikTiles>(
      (const uint8_t*)ad_p, (const uint8_t*)dp_p, ((long long)C + 1) / 2, V,
      C, b6, ldv, (float*)out, N, (cudaStream_t)stream);
}

}  // extern "C"
