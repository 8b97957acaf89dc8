"""numpy's legacy MT19937 stream regenerated on the device (counterpart of
vireo_tpu/ops/mt19937.py).

Seeded runs draw their warm-restart inits from numpy's global MT19937
stream, in the reference's order. Assembled on the host, those draws are
60.8M doubles for 20 restarts of the 30k x 100k x 16 pool and 152M for
the CLI's 50, uploaded as a float array. Here the card makes them:

- `take_state` uploads the generator's 624 keys and `kernel_stream`
  makes the whole stream in one launch of csrc/mt19937.cu (`LAUNCHES`
  counts them, `STEPS` their steps), then sets the host generator where
  a plain `rng.rand(n_total)` leaves it. The host draws nothing.
- Keys on the CPU run the kernel's plain version, which the tests hold
  the kernel against: `device_stream` regenerates the stream as one
  lane from the keys, tempering the rest of the pool, then twisting and
  tempering round after round (`_words`); the twist's in-place
  dependencies split into four vectorised sub-steps (new[i] needs
  new[i-227] for i >= 227, and new[0] at i = 623). The end state is the
  keys the plain `_twist` rounds reach.
- Word pairs become doubles by numpy's exact transform
  ``((a >> 5) * 2^26 + (b >> 6)) / 2^53``, in float64 on the CPU and on
  the card alike: the stream equals `np.random.rand` bit for bit.
  `device_stream` also forms it in float32, as the JAX package does
  without x64.

The words live in int64 tensors holding values below 2^32: every mask
of the generator has 32 bits, so no operation leaves that range, and a
right shift of a non-negative int64 is the unsigned shift the generator
needs (PyTorch has no unsigned 32-bit shift on the CPU).

`np_pairwise_sum_last` reproduces numpy's pairwise summation order, so
the per-restart normalisations built from the stream equal the host's
bit for bit as well.
"""

import ctypes

import numpy as np
import torch

from ._launch import launch, on_cpu
from ..utils.device import resolve_device

__all__ = ["device_stream", "take_state", "kernel_stream", "stream_walk",
           "np_pairwise_sum_last", "LAUNCHES", "STEPS"]

_N = 624
_M = 397
_UPPER = 0x80000000
_LOWER = 0x7FFFFFFF
_MAG = 0x9908B0DF

# number of kernel_stream calls that launched the CUDA kernel, and the
# steps of the recurrence those launches made
LAUNCHES = 0
STEPS = 0

_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        from ._build import load_library
        lib = load_library("mt19937")
        ptr, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.vireo_mt19937_stream.argtypes = [ptr, ptr, ptr, ll, ctypes.c_int,
                                             ctypes.POINTER(ll), ptr]
        lib.vireo_mt19937_stream.restype = ctypes.c_int
        lib.vireo_mt19937_error_string.argtypes = [ctypes.c_int]
        lib.vireo_mt19937_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _twist(mt):
    """One MT19937 twist round over (D, 624) words, vectorised: new[i]
    reads old mt[i], mt[i+1] (new only at i = 623) and mt[(i+397) % 624],
    old for i < 227 and new[i-227] after."""
    def tw(cur, nxt, far):
        y = (cur & _UPPER) | (nxt & _LOWER)
        return far ^ (y >> 1) ^ ((y & 1) * _MAG)

    nA = tw(mt[:, 0:227], mt[:, 1:228], mt[:, _M:_N])
    nB1 = tw(mt[:, 227:454], mt[:, 228:455], nA)
    nB2 = tw(mt[:, 454:623], mt[:, 455:624], nB1[:, 0:169])
    nlast = tw(mt[:, 623:624], nA[:, 0:1], nB1[:, 169:170])
    return torch.cat([nA, nB1, nB2, nlast], dim=1)


def _temper(y):
    y = y ^ (y >> 11)
    y = y ^ ((y << 7) & 0x9D2C5680)
    y = y ^ ((y << 15) & 0xEFC60000)
    return y ^ (y >> 18)


def _words(states, p0, c_blocks):
    """The tempered word stream of each lane: (D, 624 * c_blocks)."""
    D = states.shape[0]
    n = _N * c_blocks
    out = torch.empty((D, n), dtype=torch.int64, device=states.device)
    head = _N - p0                          # the rest of the captured pool
    out[:, :head] = _temper(states[:, p0:])
    mt = states
    for lo in range(head, n, _N):
        mt = _twist(mt)
        m = min(_N, n - lo)
        out[:, lo:lo + m] = _temper(mt[:, :m])
    return out


def device_stream(plan, dtype=torch.float64):
    """The `rand()` doubles of `plan` as one (n_total,) tensor on the
    device of its states ((D, 624) int64 words, each lane's generator
    keys), from in-pool word `p0` of every lane, `c_blocks` twist rounds
    a lane, `n_total` doubles kept. float64 equals numpy's stream bit
    for bit; float32 forms the same transform in float32, as the JAX
    package does without x64 (one rounding, deterministic)."""
    w = _words(plan["states"], plan["p0"], plan["c_blocks"])
    a = (w[:, 0::2] >> 5).to(dtype)
    b = (w[:, 1::2] >> 6).to(dtype)
    del w
    vals = (a * 67108864.0 + b) / 9007199254740992.0
    return vals.reshape(-1)[:plan["n_total"]]


def take_state(n_total, rng=None, device=None):
    """The kernel's plan: the host generator's 624 keys on `device` (as
    int32 bits), its position `p0` and `n_total`. The generator does not
    move; `kernel_stream` moves it."""
    if rng is None:
        rng = np.random
    name, keys, pos, _, _ = rng.get_state()
    assert name == "MT19937", "legacy MT19937 stream required"
    assert int(n_total) > 0
    keys = np.ascontiguousarray(keys, np.uint32).view(np.int32)
    return {"keys": torch.from_numpy(keys).to(resolve_device(device)),
            "p0": int(pos), "n_total": int(n_total)}


def stream_walk(n_total, p0):
    """Where `n_total` draws from position `p0` end: `rounds`, the twist
    round that holds the last word (0: the keys themselves), and `pos`,
    the generator's position in it after (624 when the last word ends
    it)."""
    last = p0 + 2 * n_total - 1
    rounds = last // _N
    return {"rounds": rounds, "pos": last - _N * rounds + 1}


def _kernel_stream_reference(keys, p0, n_total, rounds):
    """The kernel's plain version: one lane of `device_stream` from the
    keys, and the keys `rounds` twist rounds on."""
    words = keys.to(torch.int64) & 0xFFFFFFFF
    vals = device_stream({"states": words[None], "p0": p0,
                          "c_blocks": -(-2 * n_total // _N),
                          "n_total": n_total})
    mt = words[None]
    for _ in range(rounds):
        mt = _twist(mt)
    return vals, mt[0]


def kernel_stream(plan, rng=None):
    """The `rand()` doubles of a `take_state` plan as one (n_total,)
    float64 tensor, equal to `rng.rand(n_total)` bit for bit, with `rng`
    then set where that draw leaves it (its Gaussian cache kept). Keys on
    a card launch csrc/mt19937.cu, keys on the CPU run the plain version;
    either way the end state is read back to the host."""
    global LAUNCHES, STEPS
    if rng is None:
        rng = np.random
    keys, p0, n = plan["keys"], plan["p0"], plan["n_total"]
    walk = stream_walk(n, p0)
    if on_cpu("kernel_stream", keys):
        vals, end = _kernel_stream_reference(keys, p0, n, walk["rounds"])
    else:
        lib = _library()
        vals = torch.empty((n,), dtype=torch.float64, device=keys.device)
        end = torch.empty((_N,), dtype=torch.int32, device=keys.device)
        steps = ctypes.c_longlong()
        launch("kernel_stream", lib.vireo_mt19937_stream,
               (keys.data_ptr(), vals.data_ptr(), end.data_ptr(), n, p0,
                ctypes.byref(steps)), keys.device,
               lib.vireo_mt19937_error_string)
        LAUNCHES += 1
        STEPS += steps.value
    name, _, _, has_gauss, gauss = rng.get_state()
    rng.set_state((name, end.cpu().numpy().astype(np.uint32), walk["pos"],
                   has_gauss, gauss))
    return vals


def np_pairwise_sum_last(x):
    """Sum over the last axis in numpy's pairwise order for n <= 128
    (loops_utils.h pairwise_sum): sequential below 8, else 8 accumulators
    stepped by 8 and combined as ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)),
    then the tail in sequence. Equals `np.sum(x, -1)` bit for bit at the
    extents the inits use; works on numpy arrays and torch tensors."""
    K = x.shape[-1]
    if K < 8:
        s = x[..., 0]
        for k in range(1, K):
            s = s + x[..., k]
        return s
    r = [x[..., j] for j in range(8)]
    i = 8
    while i + 8 <= K:
        for j in range(8):
            r[j] = r[j] + x[..., i + j]
        i += 8
    s = (((r[0] + r[1]) + (r[2] + r[3]))
         + ((r[4] + r[5]) + (r[6] + r[7])))
    while i < K:
        s = s + x[..., i]
        i += 1
    return s
