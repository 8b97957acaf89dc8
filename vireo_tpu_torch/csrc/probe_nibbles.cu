// The nibble probes of benchmarks/ on Hopper: kernels A and B.
//
// Kernel A, `nibble_unpack<Variant>`, replaces the three bodies that
// benchmarks/unpack_probe.py launches through `run` (pl.pallas_call at
// unpack_probe.py:27): `k_int8_ops` (:43), `k_int32_ops` (:49) and
// `k_bitcast_int4` (:55). Each turns a byte of two 4-bit counts into two
// bf16 planes, lo = p & 15 and hi = p >> 4, by another instruction
// sequence:
//
//   kInt8Ops   the & and >> on the bytes themselves, four at a time in a
//              32-bit register (the byte lanes a TPU's int8 ops work on),
//              then one int -> bf16 conversion a value;
//   kInt32Ops  each byte widened to a 32-bit int first, then & and >>
//              and the same conversion;
//   kBitcast   bit reinterpretation: the nibble is put into the mantissa
//              of bf16 128.0 and 128 is subtracted (one fma.rn.bf16x2 for
//              two values): `hopper::bf16_pair`, the sequence K2 and K3
//              build their A fragments with, so this variant times it.
//
// What bounds A on an H100: bytes. It reads R C bytes and writes 4 R C
// (two bf16 planes), 7.5 GB at the main pool's packed AD (30000 x 50000
// bytes), 2.24 ms at 3.35 TB/s; a few integer operations a byte are far
// below the CUDA cores' rate. So each thread reads 8 bytes with one load
// and writes each plane's 8 values with one 16-byte store, and the three
// variants differ only in the registers between.
//
// Kernel B, `packed_mm<Codec>`, replaces the packed matmul of
// benchmarks/int4_micro.py (`packed_mm`, pl.pallas_call at :85, body
// `_packed_mm_kernel` :66-78) and the variants of
// benchmarks/pack_kernel_tune.py (`build`, pl.pallas_call at :87; bodies
// `make_kernel(unpack_base)`, `make_kernel(unpack_f32)` and
// `nounpack_kernel`): S = lo(P) We + hi(P) Wo for packed bytes P
// (V, ceil(C / 2)) in K2's layout (ops/packed.py) and one bf16 term of
// W, float32 sums. It is K2's design with one count matrix:
// `hopper::rows_kernel` with MATS = 1 and one plane of B (W^T, cells
// contiguous, by TMA), each A register built from the staged bytes by one
// `Codec::pair`, each 64-deep k-block summed on the tensor cores and
// added in float32 on the CUDA cores. So the codecs time exactly the part
// of K2's k-block loop that builds A:
//
//   nibble_int    hopper::Nibbles, K2's own codec: & and >> on the byte,
//                 then bf16_pair (the TPU's `unpack_base`);
//   nibble_float  one widening conversion of the signed byte to float,
//                 256 added where it is negative, hi = floor(q / 16),
//                 lo = q - 16 hi, one conversion of the pair to bf16x2
//                 (`unpack_f32`);
//   raw_byte      no unpack (`nounpack`): each signed byte is one k value,
//                 times We only, over C / 2 k values. Wrong values, the
//                 same bytes read and half the MMAs: the control that
//                 separates the unpack from the memory traffic. Bytes span
//                 -128..127, so Int8's codec (values below 128) does not
//                 serve; each is converted exactly through float.
//
// What bounds B on an H100: bytes. At 30000 x 100000 @ 100000 x 16 it
// reads 1.5 GB of packed counts (0.449 ms at 3.35 TB/s) for 9.6e10 flop
// (0.097 ms at 989 TFLOP/s of dense bf16). A block owns 128 variants and
// all 16 columns, so each k-block is only four m64n16k16 MMAs a
// warpgroup: the fixed cost of a k-block (the block barrier, the
// barrier wait on B, the fragment build, the float32 adds) is what the
// design exposes, as in K2 at N = 16 (PERF.md). With one matrix a stage
// is 8 KB (nibbles) or 12 KB (raw bytes), four stages in flight.
//
// Interface: plain C entry points, loaded with ctypes. Each launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError()
// (or cudaErrorInvalidValue for shapes it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

using hopper::bf16_pair;

constexpr int kUnpackThreads = 256;
constexpr int kUnpackBytes = 8;  // bytes a thread

enum Unpack { kInt8Ops = 0, kInt32Ops = 1, kBitcast = 2 };

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two small ints as a bf16 pair by conversion, a in the low half.
__device__ __forceinline__ uint32_t cvt_pair(int a, int b) {
  return bits(__halves2bfloat162(__int2bfloat16_rn(a), __int2bfloat16_rn(b)));
}

// The four bytes of w as the lo pairs (bytes 0, 1 and 2, 3) and the hi
// pairs of the two planes.
template <int V>
__device__ __forceinline__ void unpack4(uint32_t w, uint32_t& lo01,
                                        uint32_t& lo23, uint32_t& hi01,
                                        uint32_t& hi23) {
  if constexpr (V == kInt8Ops) {
    const uint32_t l = w & 0x0F0F0F0Fu;         // every byte's low nibble
    const uint32_t h = (w >> 4) & 0x0F0F0F0Fu;  // every byte's high nibble
    lo01 = cvt_pair(l & 0xFF, (l >> 8) & 0xFF);
    lo23 = cvt_pair((l >> 16) & 0xFF, l >> 24);
    hi01 = cvt_pair(h & 0xFF, (h >> 8) & 0xFF);
    hi23 = cvt_pair((h >> 16) & 0xFF, h >> 24);
  } else if constexpr (V == kInt32Ops) {
    int q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = (int)(int8_t)(w >> (8 * i));
    lo01 = cvt_pair(q[0] & 15, q[1] & 15);
    lo23 = cvt_pair(q[2] & 15, q[3] & 15);
    hi01 = cvt_pair((q[0] >> 4) & 15, (q[1] >> 4) & 15);
    hi23 = cvt_pair((q[2] >> 4) & 15, (q[3] >> 4) & 15);
  } else {
    uint32_t b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = (w >> (8 * i)) & 0xFFu;
    lo01 = bf16_pair(b[0] & 0xFu, b[1] & 0xFu);
    lo23 = bf16_pair(b[2] & 0xFu, b[3] & 0xFu);
    hi01 = bf16_pair(b[0] >> 4, b[1] >> 4);
    hi23 = bf16_pair(b[2] >> 4, b[3] >> 4);
  }
}

// p: n bytes, 8-byte aligned; lo, hi: n bf16 each, 16-byte aligned.
template <int V>
__global__ void __launch_bounds__(kUnpackThreads)
    nibble_unpack_kernel(const uint8_t* __restrict__ p, long long n,
                         uint16_t* __restrict__ lo,
                         uint16_t* __restrict__ hi) {
  const long long b0 =
      ((long long)blockIdx.x * kUnpackThreads + threadIdx.x) * kUnpackBytes;
  if (b0 + kUnpackBytes <= n) {
    const uint2 w = *reinterpret_cast<const uint2*>(p + b0);
    uint4 l, h;
    unpack4<V>(w.x, l.x, l.y, h.x, h.y);
    unpack4<V>(w.y, l.z, l.w, h.z, h.w);
    *reinterpret_cast<uint4*>(lo + b0) = l;
    *reinterpret_cast<uint4*>(hi + b0) = h;
  } else {
    // the ragged end, a byte at a time, by the same sequence
    for (long long j = b0; j < n; ++j) {
      uint32_t l, l23, h, h23;
      unpack4<V>(p[j], l, l23, h, h23);
      lo[j] = (uint16_t)l;
      hi[j] = (uint16_t)h;
    }
  }
}

template <int V>
cudaError_t launch_unpack(const uint8_t* p, long long n, uint16_t* lo,
                          uint16_t* hi, cudaStream_t s) {
  const long long per_block = (long long)kUnpackThreads * kUnpackBytes;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  nibble_unpack_kernel<V><<<(unsigned)blocks, kUnpackThreads, 0, s>>>(
      p, n, lo, hi);
  return cudaGetLastError();
}

// Kernel B's codecs beside hopper::Nibbles (see the file note).
struct NibbleFloat {
  static constexpr int kCellsPerByte = 2;
  __device__ static __forceinline__ uint32_t pair(const uint8_t* row,
                                                  int cell) {
    float q = (float)(int8_t)row[cell >> 1];
    q = q < 0.f ? q + 256.f : q;
    const float h = floorf(q * 0.0625f);
    return bits(__floats2bfloat162_rn(fmaf(-16.f, h, q), h));
  }
};

struct RawByte {
  static constexpr int kCellsPerByte = 1;
  __device__ static __forceinline__ uint32_t pair(const uint8_t* row,
                                                  int k) {
    return bits(__floats2bfloat162_rn((float)(int8_t)row[k],
                                      (float)(int8_t)row[k + 1]));
  }
};

enum Codec { kNibbleInt = 0, kNibbleFloat = 1, kRawByte = 2 };

constexpr int kMmTile = 16;  // columns a block: N = K = 16 in one tile

template <class C>
cudaError_t launch_mm(const uint8_t* p, long long row_bytes, int V,
                      const void* b, long long ld, long long k_len,
                      float* out, int N, cudaStream_t s) {
  return hopper::launch_rows<C, 1, kMmTile, 1>(p, nullptr, row_bytes, V, b,
                                               ld, k_len, out, nullptr, N, N,
                                               s);
}

}  // namespace

extern "C" {

const char* vireo_probe_nibbles_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// p: n bytes; lo, hi: n bf16 each. variant: 0 int8 ops, 1 int32 ops,
// 2 bitcast.
int vireo_probe_nibble_unpack(const void* p, long long n, void* lo, void* hi,
                              int variant, void* stream) {
  const uint8_t* src = (const uint8_t*)p;
  uint16_t *l = (uint16_t*)lo, *h = (uint16_t*)hi;
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || ((uintptr_t)p & 7) || ((uintptr_t)lo & 15) ||
      ((uintptr_t)hi & 15))
    return (int)cudaErrorInvalidValue;
  switch (variant) {
    case kInt8Ops: return (int)launch_unpack<kInt8Ops>(src, n, l, h, s);
    case kInt32Ops: return (int)launch_unpack<kInt32Ops>(src, n, l, h, s);
    case kBitcast: return (int)launch_unpack<kBitcast>(src, n, l, h, s);
  }
  return (int)cudaErrorInvalidValue;
}

// p: (V, row_bytes) bytes. b: (1, N, ld) bf16, B^T with the k values
// contiguous: for the nibble codecs the interleaved weights (k = cell,
// We at even cells, Wo at odd), k_len = 2 row_bytes; for raw_byte We^T,
// k_len = row_bytes. ld >= k_len a multiple of 8. out: (V, N) float32.
int vireo_probe_packed_mm(const void* p, long long row_bytes, int V,
                          const void* b, long long ld, long long k_len,
                          void* out, int N, int codec, void* stream) {
  const uint8_t* a = (const uint8_t*)p;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (V <= 0 || N <= 0 || row_bytes <= 0) return (int)cudaErrorInvalidValue;
  switch (codec) {
    case kNibbleInt:
      return (int)launch_mm<hopper::Nibbles>(a, row_bytes, V, b, ld, k_len,
                                             o, N, s);
    case kNibbleFloat:
      return (int)launch_mm<NibbleFloat>(a, row_bytes, V, b, ld, k_len, o,
                                         N, s);
    case kRawByte:
      return (int)launch_mm<RawByte>(a, row_bytes, V, b, ld, k_len, o, N,
                                     s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
