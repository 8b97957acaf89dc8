// Building blocks shared by the tensor-core kernels K1 (fused_estep.cu),
// K2 and K3 (packed_counts.cu), and the probes' kernel B
// (probe_nibbles.cu), on Hopper (sm_90a):
//
// - a ring of shared-memory stages filled by bulk tensor copies (TMA)
//   for B, with one mbarrier a stage, and by 16-byte cp.async copies for
//   A;
// - warpgroup MMA (`wgmma.mma_async`, m64nNk16, bf16 in, float32
//   accumulators) with A in registers and B in shared memory, read
//   through a matrix descriptor;
// - A fragments built in registers from count bytes, K-major (`pair`:
//   K2, K1's statistics) or M-major (`mmajor_frag`: K1's E-step, K3);
// - `rows_kernel`, the contraction OUT_m = A_m . sum_p B_p for the two
//   count matrices m = AD, DP held as byte rows (packed nibbles for K2,
//   int8 for K1's statistics), which is both K2 and the second kernel
//   of K1;
// - for the packed-matmul probe (kernel B, probe_nibbles.cu): a 2-D
//   tensor map over a byte matrix, barriers that count several
//   arrivals, and 2-D bulk tensor copies.
//
// Operand layouts. B is K-major in device memory: planes x rows (the
// output columns n) x ld (the contracted axis k), bf16, with ld a
// multiple of 8 (TMA takes row strides of whole 16-byte units). Its
// tensor map has B's logical sizes, and TMA fills what a box reads
// outside them with zeros: the columns past N of the last column tile
// and the k values past the contracted length of the last k-block. So
// the tiling stays inside the kernels, B needs no padding in device
// memory and no masking. A stage holds 64 k
// values of B, copied by TMA as boxes of BN rows x 128 bytes with the
// 128-byte swizzle, so each B row is one 128-byte row of wgmma's swizzle
// atom (8 rows x 128 bytes, 1024-byte aligned; the 16-byte chunk kc of
// row r sits at chunk kc ^ r), which spreads the rows an MMA reads over
// all shared-memory banks (the no-swizzle layout measured 5% slower for
// K2 at N = 320 and 15-18% slower for K1 at K = 136 and 300 on an
// H100). With B copied by every thread's cp.async instead of TMA, K2
// took 30 ms at N = 320 against 21.6 ms now: one thread's bulk copies
// move the weights faster than 256 threads' 16-byte ones.
//
// A is built in registers from count bytes staged in shared memory.
// Count rows are stored unpadded, so a row's first byte need not be
// 16-byte aligned (packed rows hold ceil(C / 2) bytes, int8 rows C).
// Each row of a stage is copied as the aligned 16-byte chunks that
// cover the bytes it needs, into a row of pitch NBYTES + 16 where the
// first needed byte sits at (its address & 15); the fragment loaders
// read single bytes from there. Only chunks holding at least one byte
// of the row are copied; such a chunk never crosses a page, so it never
// faults. Bytes outside a row's range (the next row's, or stale bytes
// of an earlier stage) are finite after conversion and meet B's zero
// fill, or land in output rows that are not stored.
//
// Results do not change from run to run: no atomics, and every output
// element is summed by one warpgroup in a fixed order.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// A stage holds 64 k values of B: one 128-byte row of a swizzle atom.
constexpr int kKBlock = 64;             // contracted depth of a stage
constexpr int kMaxStages = 4;           // ring depth, at most
constexpr int kSmemAlign = 1024;        // a swizzle atom's alignment
constexpr int kSmemBudget = 224 * 1024; // bytes of ring a block may use
constexpr int kBlockThreads = 256;      // two warpgroups
constexpr int kBlockRows = 128;         // 64 rows a warpgroup

// rows_kernel's widest column tile. The tensor cores add each k16 step
// into their float32 accumulators with truncation, not rounding to
// nearest, so the error of a sum grows by about one ulp a step: over
// C / 16 steps, 4.0e-4 of |S| for 100000 dense cells on an H100 against
// 7.8e-7 for cuBLAS's float32 sums (PERF.md). So rows_kernel sums each
// k-block of 64 cells in fresh accumulators and adds those to float32
// sums on the CUDA cores, rounding to nearest. That takes two
// accumulator sets for each of the two count matrices, 2 x 2 x 40
// floats a thread at 80 columns, which leaves registers for the A
// fragments.
constexpr int kRowsMaxTile = 80;

// The deepest ring of stages of `stage` bytes that fits the budget.
constexpr int ring_depth(int stage) {
  return kSmemBudget / stage < kMaxStages ? kSmemBudget / stage
                                          : kMaxStages;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One mbarrier a stage tracks B's bulk copies (TMA): one arrival, by the
// thread that starts them, and the bytes they bring.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits for the completion of the barrier's phase of parity `phase`. A
// wait that outlasts any copy by orders of magnitude traps, so a fault
// ends the kernel with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  const uint32_t addr = smem_addr(bar);
  for (long long spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(phase)
        : "memory");
    if (done) return;
    if (spins > (1LL << 26)) __trap();
  }
}

// A box of the 3D tensor map at k x, row y, plane z, into shared memory,
// reported to `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y,
                                         int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"((uint64_t)map), "r"(smem_addr(bar)), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// A barrier that `count` plain arrivals complete (kernel B's "empty"
// barriers: one arrival by each consumer warp).
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival where `pred` holds, by a predicated instruction, not a
// branch: a branch on the lane between warpgroup MMAs makes the compiler
// serialise them.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          smem_addr(bar)),
      "r"((int)pred)
      : "memory");
}

// A box of a 2D tensor map at column x, row y, into shared memory,
// reported to `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"((uint64_t)map), "r"(smem_addr(bar)), "r"(x), "r"(y)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of the warpgroup's committed MMA groups are
// still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous MMAs.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, float32) = A (64 x 16, bf16 registers) B (16 x N, bf16
// in shared memory) + (scale_d ? D : 0). Register i of D holds row
// g + 8 ((i >> 1) & 1) and
// column 8 (i >> 2) + 2 c + (i & 1) of the warp's 16 rows, g = lane / 4,
// c = lane % 4; A's registers hold (row g, k 2c..2c+1), (g + 8, same),
// (g, 2c+8..2c+9), (g + 8, same) as bf16 pairs, the lower k in the low
// half. One specialisation for each tile width the kernels use.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d);

#define HOPPER_D8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : HOPPER_D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24),
        HOPPER_D8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24),
        HOPPER_D8(32), HOPPER_D8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24),
        HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<160>(float (&d)[80],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24),
        HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56),
        HOPPER_D8(64), HOPPER_D8(72)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24),
        HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56),
        HOPPER_D8(64), HOPPER_D8(72), HOPPER_D8(80), HOPPER_D8(88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<224>(float (&d)[112],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111"
      "}, {%112, %113, %114, %115}, %116, p, 1, 1, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24),
        HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56),
        HOPPER_D8(64), HOPPER_D8(72), HOPPER_D8(80), HOPPER_D8(88),
        HOPPER_D8(96), HOPPER_D8(104)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24),
        HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56),
        HOPPER_D8(64), HOPPER_D8(72), HOPPER_D8(80), HOPPER_D8(88),
        HOPPER_D8(96), HOPPER_D8(104), HOPPER_D8(112),
        HOPPER_D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

#undef HOPPER_D8

// Two small non-negative integers (< 128) as an exact bf16 pair: 0x43xx
// is 128 + xx for xx < 128, and subtracting 128 is exact.
__device__ __forceinline__ uint32_t bf16_pair(uint32_t lo, uint32_t hi) {
  const uint32_t x = lo | (hi << 16) | 0x43004300u;
  const uint32_t one = 0x3F803F80u, minus128 = 0xC300C300u;
  uint32_t y;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(y)
      : "r"(x), "r"(one), "r"(minus128));
  return y;
}

// Packed nibbles (K2, K3): byte j of a row holds cells 2j (low nibble)
// and 2j + 1 (high nibble).
struct Nibbles {
  static constexpr int kCellsPerByte = 2;
  // K-major: one byte is one A register's k pair.
  __device__ static __forceinline__ uint32_t pair(const uint8_t* row,
                                                  int cell) {
    const uint32_t b = row[cell >> 1];
    return bf16_pair(b & 0xFu, b >> 4);
  }
  // M-major: the cells of byte a[0] of one k row and b[0] of the next
  // as two k pairs, of the even cell and of the odd cell.
  __device__ static __forceinline__ void cell_pairs(const uint8_t* a,
                                                    const uint8_t* b,
                                                    uint32_t& even,
                                                    uint32_t& odd) {
    const uint32_t u = (uint32_t)a[0] | ((uint32_t)b[0] << 16);
    even = bf16_pair(u & 0xFu, (u >> 16) & 0xFu);
    odd = bf16_pair((u >> 4) & 0xFu, u >> 20);
  }
};

// int8 counts in [0, 127] (K1): one cell a byte.
struct Int8 {
  static constexpr int kCellsPerByte = 1;
  __device__ static __forceinline__ uint32_t pair(const uint8_t* row,
                                                  int cell) {
    return bf16_pair(row[cell], row[cell + 1]);
  }
  // M-major: cells a[0], a[1] of one k row and b[0], b[1] of the next.
  __device__ static __forceinline__ void cell_pairs(const uint8_t* a,
                                                    const uint8_t* b,
                                                    uint32_t& even,
                                                    uint32_t& odd) {
    even = bf16_pair(a[0], b[0]);
    odd = bf16_pair(a[1], b[1]);
  }
};

// The A fragment of one k16 step when A is M-major (K1's E-step, K3):
// the counts are rows of k values (variants) with the M rows (cells)
// contiguous, staged in shared memory. A warp's fragment rows g and
// g + 8 are two adjacent cells, 2i and 2i + 1, held by one byte (packed)
// or two (int8), so each register pairs the same cell of two k rows.
// rows[q] points, in the staged row of k value 2c + (q & 1) + 8 (q >> 1)
// of the step, at the byte that holds the thread's cells.
template <class Codec>
__device__ __forceinline__ void mmajor_frag(uint32_t (&a)[4],
                                            const uint8_t* const (&rows)[4]) {
  Codec::cell_pairs(rows[0], rows[1], a[0], a[1]);
  Codec::cell_pairs(rows[2], rows[3], a[2], a[3]);
}

// Copies bytes [j0, j0 + NBYTES) of rows row0 .. row0 + ROWS - 1 of a
// (n_rows, row_bytes) byte matrix into shared rows of pitch NBYTES + 16,
// as the file note says. Returns nothing; the caller commits.
template <int ROWS, int NBYTES>
__device__ __forceinline__ void load_byte_rows(uint8_t* dst,
                                               const uint8_t* src,
                                               long long row0,
                                               long long n_rows,
                                               long long row_bytes,
                                               long long j0) {
  constexpr int kChunks = NBYTES / 16 + 1;
  constexpr int kPitch = NBYTES + 16;
  const long long j1 = (j0 + NBYTES < row_bytes) ? j0 + NBYTES : row_bytes;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kBlockThreads) {
    const int r = i / kChunks, q = i % kChunks;
    const long long row = row0 + r;
    if (row >= n_rows || j0 >= j1) continue;
    const uintptr_t start = (uintptr_t)(src + row * row_bytes + j0);
    const uintptr_t end = (uintptr_t)(src + row * row_bytes + j1);
    const uintptr_t chunk = (start & ~(uintptr_t)15) + 16 * q;
    if (chunk >= end) continue;
    cp_async16(dst + r * kPitch + 16 * q, (const void*)chunk);
  }
}

// The first needed byte of a row that load_byte_rows copied into the
// shared row `slot`: the low 4 bits of its address, which 32-bit
// arithmetic gives as well as 64-bit.
__device__ __forceinline__ const uint8_t* byte_row(const uint8_t* slot,
                                                   const uint8_t* src,
                                                   long long row,
                                                   long long row_bytes,
                                                   long long j0) {
  const uint32_t low = (uint32_t)(uintptr_t)src +
                       (uint32_t)row * (uint32_t)row_bytes + (uint32_t)j0;
  return slot + (low & 15);
}

// The dynamic shared memory of a block, from its first 1024-byte
// boundary (the launch adds kSmemAlign bytes for this).
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((kSmemAlign - (smem_addr(raw) & (kSmemAlign - 1))) &
                (kSmemAlign - 1));
}

// B's tensor map: `planes` bf16 matrices of `rows` x `k_len`, rows `ld`
// elements apart, read in boxes of BN rows x 64 k values of one plane
// with the 128-byte swizzle, so TMA writes each box in the layout the
// descriptors below read: row n at byte 128 n, its 16-byte chunk kc at
// chunk kc ^ (n % 8). Box elements outside the logical sizes read as 0
// (FLOAT_OOB_FILL_NONE), and the mbarrier still counts the whole box.
// Host side; false if the encoder is missing or refuses the map.
typedef CUresult (*TensorMapEncoder)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, or nullptr where it is missing.
inline TensorMapEncoder tensor_map_encoder() {
  static TensorMapEncoder encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess || fn == nullptr)
      return nullptr;
    encode = (TensorMapEncoder)fn;
  }
  return encode;
}

inline bool encode_b(CUtensorMap* map, const void* b, int planes,
                     long long rows, long long k_len, long long ld,
                     int box_rows) {
  const TensorMapEncoder encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  if (ld % 8 != 0 || ld < k_len) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)k_len, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2,
                                 (cuuint64_t)(ld * rows * 2)};
  const cuuint32_t box[3] = {(cuuint32_t)kKBlock, (cuuint32_t)box_rows, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, (void*)b, dims,
                strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of a (rows, row_bytes) byte matrix, row_bytes a multiple
// of 16 (TMA's row stride) and `a` 16-byte aligned, read in boxes of
// box_rows rows x 128 bytes with the 128-byte swizzle: row r of a box at
// byte 128 r, its 16-byte chunk q at chunk q ^ (r % 8). Bytes outside
// the matrix read as 0. Host side; false if the encoder is missing or
// refuses the map.
inline bool encode_bytes(CUtensorMap* map, const void* a, long long rows,
                         long long row_bytes, int box_rows) {
  const TensorMapEncoder encode = tensor_map_encoder();
  if (encode == nullptr || row_bytes % 16 != 0 || ((uintptr_t)a & 15))
    return false;
  const cuuint64_t dims[2] = {(cuuint64_t)row_bytes, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {128, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, (void*)a, dims,
                strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Starts the bulk copies of B rows n0 .. n0 + BN - 1 of each of PLANES
// planes, k values k0 .. k0 + 63, into a stage (plane p at byte
// p BK BN 2), reported to `bar`. One thread calls it.
template <int PLANES, int BN, int BK>
__device__ __forceinline__ void load_b(uint8_t* dst, const CUtensorMap* map,
                                       uint64_t* bar, int n0, int k0) {
  static_assert(BK == kKBlock, "a box row is one 128-byte swizzle row");
  mbar_expect_tx(bar, PLANES * BK * BN * 2);
#pragma unroll
  for (int p = 0; p < PLANES; ++p)
    tma_load(dst + p * (BK * BN * 2), map, bar, k0, n0, p);
}

// Descriptor of B's k16 step s of plane p in a stage: it starts 32
// bytes further along the atoms' rows each step, with 1024 bytes between
// groups of 8 rows (the stride byte offset) and layout type 1 (128-byte
// swizzle; the leading byte offset is unused).
template <int BN, int BK>
__device__ __forceinline__ uint64_t b_desc(const uint8_t* stage, int p,
                                           int s) {
  const uint8_t* plane = stage + p * (BK * BN * 2) + 32 * s;
  return (uint64_t)((smem_addr(plane) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// ---------------------------------------------------------------------
// rows_kernel: OUT_m[v, n] = sum_k A_m[v, k] sum_p B_p[n, k] for the two
// count matrices m (A_0 = AD, A_1 = DP), rows v of V, columns n of N.
//
// A block owns 128 rows (64 a warpgroup) and one tile of BN columns of
// both outputs, and walks the whole contracted axis in k-blocks of
// kKBlock cells through a ring of at most kMaxStages stages (all but one
// in flight); the copies of k-block t + STAGES - 1 are started while the
// MMAs of k-block t run. The blocks of one row
// range and different column tiles are adjacent in the grid; all blocks
// start at k = 0 and move at one pace, so the blocks in flight read the
// same B rows and B's traffic comes from L2.
template <class Codec, int PLANES, int BN_>
struct RowsShape {
  static constexpr int BN = BN_;
  static constexpr int BK = kKBlock;  // cells a k-block
  static constexpr int BKB = BK / Codec::kCellsPerByte;  // bytes a k-block
  static constexpr int A_PITCH = BKB + 16;
  static constexpr int B_BYTES = PLANES * BK * BN * 2;
  static constexpr int A_BYTES = 2 * kBlockRows * A_PITCH;
  static constexpr int STAGE = B_BYTES + A_BYTES;
  static constexpr int STAGES = ring_depth(STAGE);
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + kSmemAlign;
  static_assert(STAGES >= 2, "a ring needs two stages");
  static_assert(STAGE % kSmemAlign == 0, "stages keep the alignment");
};

template <class Codec, int PLANES, int BN>
__global__ void __launch_bounds__(kBlockThreads, 1)
    rows_kernel(const uint8_t* __restrict__ a0,
                const uint8_t* __restrict__ a1, long long row_bytes,
                int n_rows, const __grid_constant__ CUtensorMap b_map,
                long long k_len, float* __restrict__ out0,
                float* __restrict__ out1, long long ld_out, int N,
                int n_tiles) {
  using S = RowsShape<Codec, PLANES, BN>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  __shared__ uint64_t b_full[S::STAGES];
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const long long row0 = (long long)(blockIdx.x / n_tiles) * kBlockRows;
  const int n0 = (blockIdx.x % n_tiles) * S::BN;
  const int nkb = (int)((k_len + S::BK - 1) / S::BK);

  auto stage = [&](int i) { return smem + (size_t)i * S::STAGE; };
  // B by TMA (one thread), A by every thread's cp.async
  auto load = [&](int t) {
    uint8_t* st = stage(t % S::STAGES);
    if (tid == 0)
      load_b<PLANES, S::BN, S::BK>(st, &b_map, &b_full[t % S::STAGES], n0,
                                   t * S::BK);
    const long long j0 = (long long)t * S::BKB;
    load_byte_rows<kBlockRows, S::BKB>(st + S::B_BYTES, a0, row0, n_rows,
                                       row_bytes, j0);
    load_byte_rows<kBlockRows, S::BKB>(
        st + S::B_BYTES + kBlockRows * S::A_PITCH, a1, row0, n_rows,
        row_bytes, j0);
  };

  // part: one k-block's sums, formed by the tensor cores; acc: the sums
  // over all k-blocks, added to in float32 on the CUDA cores (see
  // kRowsMaxTile)
  float acc[2][BN / 2], part[2][BN / 2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[m][i] = part[m][i] = 0.f;

  if (tid == 0)
    for (int i = 0; i < S::STAGES; ++i) mbar_init(&b_full[i]);
  __syncthreads();
#pragma unroll
  for (int t = 0; t < S::STAGES - 1; ++t) {
    if (t < nkb) load(t);
    cp_async_commit();
  }

  // this thread's fragment rows within the block
  const int r_lo = wg * 64 + warp * 16 + g;
  const int r_hi = r_lo + 8;

  for (int t = 0; t < nkb; ++t) {
    cp_async_wait<S::STAGES - 2>();
    __syncthreads();
    mbar_wait(&b_full[t % S::STAGES], (t / S::STAGES) & 1);

    const uint8_t* st = stage(t % S::STAGES);
    const long long j0 = (long long)t * S::BKB;
    uint32_t frag[2][S::BK / 16][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const uint8_t* a = m ? a1 : a0;
      const uint8_t* base = st + S::B_BYTES + m * kBlockRows * S::A_PITCH;
      const uint8_t* lo = byte_row(base + r_lo * S::A_PITCH, a,
                                   row0 + r_lo, row_bytes, j0);
      const uint8_t* hi = byte_row(base + r_hi * S::A_PITCH, a,
                                   row0 + r_hi, row_bytes, j0);
#pragma unroll
      for (int s = 0; s < S::BK / 16; ++s) {
        frag[m][s][0] = Codec::pair(lo, 16 * s + 2 * c);
        frag[m][s][1] = Codec::pair(hi, 16 * s + 2 * c);
        frag[m][s][2] = Codec::pair(lo, 16 * s + 2 * c + 8);
        frag[m][s][3] = Codec::pair(hi, 16 * s + 2 * c + 8);
      }
    }

    fence_regs(part[0]);
    fence_regs(part[1]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < S::BK / 16; ++s)
#pragma unroll
      for (int p = 0; p < PLANES; ++p) {
        const uint64_t desc = b_desc<BN, S::BK>(st, p, s);
        const int more = s > 0 || p > 0;  // the first MMA starts part at 0
        wgmma_rs<BN>(part[0], frag[0][s], desc, more);
        wgmma_rs<BN>(part[1], frag[1][s], desc, more);
      }
    wgmma_commit();
    // the slot of k-block t - 1, which every warpgroup has finished
    if (t + S::STAGES - 1 < nkb) load(t + S::STAGES - 1);
    cp_async_commit();
    wgmma_wait_all();
    fence_regs(part[0]);
    fence_regs(part[1]);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[m][i] += part[m][i];
  }
  cp_async_wait<0>();

#pragma unroll
  for (int m = 0; m < 2; ++m) {
    float* out = m ? out1 : out0;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const long long v = row0 + (((i >> 1) & 1) ? r_hi : r_lo);
      const long long n = n0 + 8 * (i >> 2) + 2 * c + (i & 1);
      if (v < n_rows && n < N) out[v * ld_out + n] = acc[m][i];
    }
  }
}

// Column tile width: 16 for N <= 16, else as few tiles of at most
// max_bn columns as cover N, balanced, in multiples of `unit`.
inline int pick_tile(int N, int max_bn, int unit = 32) {
  if (N <= 16) return 16;
  const int chunks = (N + unit - 1) / unit;
  const int max_chunks = max_bn / unit;
  const int tiles = (chunks + max_chunks - 1) / max_chunks;
  return unit * ((chunks + tiles - 1) / tiles);
}

// b: PLANES x N x ld bf16, B's k values k_len of each row (see encode_b).
template <class Codec, int PLANES, int BN>
cudaError_t launch_rows(const uint8_t* a0, const uint8_t* a1,
                        long long row_bytes, int n_rows, const void* b,
                        long long ld, long long k_len, float* out0,
                        float* out1, long long ld_out, int N,
                        cudaStream_t s) {
  using Sh = RowsShape<Codec, PLANES, BN>;
  auto kernel = rows_kernel<Codec, PLANES, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::SMEM);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (N + Sh::BN - 1) / Sh::BN;
  const long long blocks =
      n_tiles * ((n_rows + kBlockRows - 1) / kBlockRows);
  CUtensorMap b_map;
  if (blocks <= 0 || blocks > 0x7FFFFFFF || k_len <= 0 ||
      k_len > 0x7FFFFFFF - Sh::BK ||
      !encode_b(&b_map, b, PLANES, N, k_len, ld, Sh::BN))
    return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kBlockThreads, Sh::SMEM, s>>>(
      a0, a1, row_bytes, n_rows, b_map, k_len, out0, out1, ld_out, N,
      (int)n_tiles);
  return cudaGetLastError();
}

// Dispatch on the tile pick_tile(N, kRowsMaxTile, 16) gives.
template <class Codec, int PLANES>
cudaError_t launch_rows_any(const uint8_t* a0, const uint8_t* a1,
                            long long row_bytes, int n_rows, const void* b,
                            long long ld, long long k_len, float* out0,
                            float* out1, long long ld_out, int N,
                            cudaStream_t s) {
  switch (pick_tile(N, kRowsMaxTile, 16)) {
#define HOPPER_ROWS(BN)                                                   \
  case BN:                                                                \
    return launch_rows<Codec, PLANES, BN>(a0, a1, row_bytes, n_rows, b,   \
                                          ld, k_len, out0, out1, ld_out,  \
                                          N, s);
    HOPPER_ROWS(16) HOPPER_ROWS(32) HOPPER_ROWS(48) HOPPER_ROWS(64)
    HOPPER_ROWS(80)
  }
#undef HOPPER_ROWS
  return cudaErrorInvalidValue;
}

}  // namespace hopper
