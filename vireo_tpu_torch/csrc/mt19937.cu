// numpy's legacy MT19937 `rand()` stream made on the card, bit for bit.
//
// Replaces no TPU kernel: the JAX package regenerates the stream with
// XLA ops from host-captured lane states (vireo_tpu/ops/mt19937.py).
// The port first did the same with torch ops: the host advanced numpy's
// generator through every double it owed to capture those states, then
// ~10 launches a twist round made the words.
// Here one launch makes the whole stream from the generator's current
// state and returns the state a plain `rand(n)` leaves.
//
// The words of MT19937 form one sequence x[j], the generator's 624 keys
// being x[0..623], with
//
//   x[j] = x[j-227] ^ twist(x[j-624], x[j-623])         (j >= 624)
//
// and numpy's `rand()` at position p takes the words x[p], x[p+1], ...
// two a double: ((temper(a) >> 5) 2^26 + (temper(b) >> 6)) / 2^53.
//
// What bounds it on an H100: the stores, 8 bytes a double (1.2 GB for
// the 152M doubles of pool16's 50 restarts, 0.36 ms at 3.35 TB/s); and
// the chain. No word of x[j..j+226] needs another of them, but each
// needs words made just before, so the sequence is made in steps of
// kStep = 226 words (kPairs = 113 doubles): one block, each of 113
// threads making two consecutive words from a ring of the last 1024
// words in shared memory, then one barrier. A step's reads reach back
// 624 words and its writes 226 ahead, so 1024 words hold both and a
// single barrier a step orders them. The chain is the ~1.35M steps of a
// 152M-double stream, each a barrier, shared loads and a dozen integer
// operations long, some 400x the stores' bound. Each step is laid out
// to keep the chain short:
//
//   - the three old words a word needs, x[j-624..j-622], were made two
//     steps or more before, so they are loaded before the barrier that
//     ends the step ahead; after it only x[j-227] and x[j-226], made in
//     the step just ended, are waited for;
//   - while those loads are in flight the thread tempers the two words
//     it made in the step before and stores their double, so a step
//     stores 113 consecutive doubles and the stores leave the chain.
//
// Measured on an H100 (60.8M doubles): 118 ns a step; the same with
// neither load nor store moved 128; with no stores at all 78. Warps
// that only store, a step behind the chain warps behind the same
// barrier or batches behind them through named barriers, were no
// faster (126, 224): what a stored double costs is the latency of its
// temper, conversion and store, wherever it runs.
//
// An odd start position p0 is handled by making x[624] ahead of the
// steps: the steps then start at x[625], and each double's two words
// come from one thread. The doubles whose words lie in the keys (and
// x[624]) are stored before the steps.
//
// The end state: numpy twists whole 624-word rounds, so after the last
// word x[e] its keys are round r = e / 624, x[624 r .. 624 r + 623], at
// position e - 624 r + 1 (624 when e ends a round). The steps run on to
// the end of that round (`stream_steps` counts them) and the round's
// words are copied from the ring into keys_out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 624;
constexpr int kM = 397;
constexpr int kStep = 226;
constexpr int kPairs = kStep / 2;
constexpr int kThreads = 128;
constexpr unsigned kRing = 1024;
constexpr unsigned kMask = kRing - 1;

static_assert(kStep <= kN - kM, "a step's words would read each other");
static_assert(kN + kStep <= (int)kRing, "a step overwrites words it reads");
static_assert(kPairs <= kThreads, "a thread makes one pair");

__device__ __forceinline__ uint32_t twist(uint32_t cur, uint32_t nxt,
                                          uint32_t far) {
  const uint32_t y = (cur & 0x80000000u) | (nxt & 0x7fffffffu);
  return far ^ (y >> 1) ^ ((0u - (y & 1u)) & 0x9908b0dfu);
}

__device__ __forceinline__ uint32_t temper(uint32_t y) {
  y ^= y >> 11;
  y ^= (y << 7) & 0x9d2c5680u;
  y ^= (y << 15) & 0xefc60000u;
  return y ^ (y >> 18);
}

// numpy's random_double from two raw words: exact in uint64, exact in
// the conversion (below 2^53) and in the scaling by 2^-53.
__device__ __forceinline__ double to_double(uint32_t a, uint32_t b) {
  const uint64_t m = ((uint64_t)(temper(a) >> 5) << 26) | (temper(b) >> 6);
  return (double)m * (1.0 / 9007199254740992.0);
}

__global__ void __launch_bounds__(kThreads, 1)
    mt_stream_kernel(const uint32_t* __restrict__ keys,
                     double* __restrict__ out, uint32_t* __restrict__ keys_out,
                     long long n, int p0, long long steps,
                     long long round_base) {
  __shared__ uint32_t ring[kRing];
  const int t = threadIdx.x;
  for (int i = t; i < kN; i += kThreads) ring[i] = keys[i];
  __syncthreads();
  const int g0 = kN + (p0 & 1);
  if (t == 0 && g0 > kN) ring[kN] = twist(ring[0], ring[1], ring[kM]);
  __syncthreads();
  const long long head = min(n, (long long)((g0 - p0) / 2));
  for (int d = t; d < head; d += kThreads)
    out[d] = to_double(ring[p0 + 2 * d], ring[p0 + 2 * d + 1]);

  // thread t makes x[j], x[j + 1] each step; d is the double of the two
  // it made the step before
  unsigned j = g0 + 2 * t;
  long long d = head + t - kPairs;
  uint32_t x0 = ring[(j - kN) & kMask], x1 = ring[(j - kN + 1) & kMask],
           x2 = ring[(j - kN + 2) & kMask];
  uint32_t w0 = 0, w1 = 0;
  for (long long s = 0; s < steps; ++s) {
    if (t < kPairs) {
      const uint32_t f0 = ring[(j - (kN - kM)) & kMask];
      const uint32_t f1 = ring[(j - (kN - kM) + 1) & kMask];
      if (s > 0 && d < n) out[d] = to_double(w0, w1);
      w0 = twist(x0, x1, f0);
      w1 = twist(x1, x2, f1);
      ring[j & kMask] = w0;
      ring[(j + 1) & kMask] = w1;
      j += kStep;
      x0 = ring[(j - kN) & kMask];
      x1 = ring[(j - kN + 1) & kMask];
      x2 = ring[(j - kN + 2) & kMask];
    }
    d += kPairs;
    __syncthreads();
  }
  if (t < kPairs && steps > 0 && d < n) out[d] = to_double(w0, w1);
  for (int i = t; i < kN; i += kThreads)
    keys_out[i] = ring[(unsigned)(round_base + i) & kMask];
}

// The steps from x[624 + (p0 & 1)] through the end of round
// `round_base` / 624, the one that holds the last drawn word x[p0 + 2n - 1]
// (none when that word is a key).
long long stream_steps(long long n, int p0, long long* round_base) {
  const long long rounds = (p0 + 2 * n - 1) / kN;
  *round_base = kN * rounds;
  if (rounds == 0) return 0;
  const long long words = kN * (rounds + 1) - (kN + (p0 & 1));
  return (words + kStep - 1) / kStep;
}

}  // namespace

extern "C" {

const char* vireo_mt19937_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// keys: the generator's 624 keys (uint32), at position p0 in [0, 624].
// out: n float64, 8-byte aligned: the n doubles `rand(n)` returns.
// keys_out: 624 uint32, the keys numpy holds after that draw. steps_out,
// unless null: the steps the launch makes. One block on the stream.
int vireo_mt19937_stream(const void* keys, void* out, void* keys_out,
                         long long n, int p0, long long* steps_out,
                         void* stream) {
  if (n <= 0 || p0 < 0 || p0 > kN || ((uintptr_t)out & 7) ||
      ((uintptr_t)keys & 3) || ((uintptr_t)keys_out & 3))
    return (int)cudaErrorInvalidValue;
  long long round_base;
  const long long steps = stream_steps(n, p0, &round_base);
  if (steps_out) *steps_out = steps;
  mt_stream_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)keys, (double*)out, (uint32_t*)keys_out, n, p0, steps,
      round_base);
  return (int)cudaGetLastError();
}

}  // extern "C"
