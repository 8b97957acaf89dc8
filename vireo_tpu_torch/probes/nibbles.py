"""Kernels A and B of the nibble probes (csrc/probe_nibbles.cu), with
their plain versions.

- A, `nibble_unpack(p, variant)`: bytes of two 4-bit counts -> the bf16
  planes (p & 15, p >> 4), by one of three instruction sequences
  (`VARIANTS`; benchmarks/unpack_probe.py's `k_int8_ops`,
  `k_int32_ops` and `k_bitcast_int4`).
- B, `packed_mm(p, we, wo, codec)`: S = lo(P) We + hi(P) Wo for packed
  bytes P (V, ceil(C / 2)) in K2's layout (ops/packed.py) and weights
  We, Wo (ceil(C / 2), N) of the even and odd cells, by one of three
  codecs (`CODECS`): K2's integer unpack (benchmarks/int4_micro.py's
  `packed_mm`, pack_kernel_tune.py's `base`), float algebra (`f32unpack`)
  or none (`nounpack`: bf16(p) We, the signed bytes as k values, wo
  unused: wrong values, the same bytes read).

For tensors on a card each launches its kernel or raises; B takes one
bf16 term of the weights, as the TPU's default precision does, so the
wrapper rounds float32 weights to bf16. For tensors on the CPU each runs
its plain version, A in bf16 (exact), B in float64. `LAUNCHES` counts
each kernel's launches by variant and codec (`nibble_unpack_int8`, ...,
`packed_mm_raw_byte`).

Kernel B's host side lives here, where the CPU tests reach it:
`mm_plan` cuts the rows into 256-row blocks and the bytes into stages of
128 and slices of whole stages, and picks the persistent grid;
`mm_weights` writes Bᵀ in the kernel's k order (`k_order`); `pad_rows`
pads rows to the 16-byte multiple TMA needs (a copy of P, only when the
row length is not one already).
"""

import ctypes
import functools

import torch

from ..ops._build import load_library
from ..ops._launch import launch, on_cpu
from ..utils.device import default_dtype

__all__ = ["VARIANTS", "CODECS", "LAUNCHES", "TILE", "nibble_unpack",
           "nibble_unpack_reference", "packed_mm", "packed_mm_reference",
           "k_order", "mm_plan", "mm_weights", "pad_rows", "mm_shape",
           "card_plan", "packed_mm_control"]

# kernel A's instruction sequences and kernel B's codecs, in the order of
# their numbers in probe_nibbles.cu
VARIANTS = ("int8", "int32", "bitcast")
CODECS = ("nibble_int", "nibble_float", "raw_byte")

# launches of each kernel, by variant and codec
LAUNCHES = dict.fromkeys(["nibble_unpack_" + v for v in VARIANTS]
                         + ["packed_mm_" + c for c in CODECS], 0)

# kernel B's unit: 256 variants x 16 columns, fed in stages of 128 bytes
# of each row (256 cells, or 128 k values for raw_byte). It has no other
# tile.
TILE = (256, 128)
_MM_ROWS, _STAGE_BYTES, _N_TILE = TILE[0], TILE[1], 16

# rows of one unpacked float block of B's plain version
_ROWS = 4096

_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        lib = load_library("probe_nibbles")
        ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.vireo_probe_nibble_unpack.argtypes = [ptr, ll, ptr, ptr, i, ptr]
        lib.vireo_probe_nibble_unpack.restype = i
        lib.vireo_probe_packed_mm.argtypes = [ptr, ll, i, ptr, i, i, i, i,
                                              i, ptr, ptr, i, ptr]
        lib.vireo_probe_packed_mm.restype = i
        lib.vireo_probe_packed_mm_control.argtypes = [ptr, ll, i, ptr, i, i,
                                                      i, i, i, ptr, i, ptr]
        lib.vireo_probe_packed_mm_control.restype = i
        lib.vireo_probe_packed_mm_shape.argtypes = [
            i, ctypes.POINTER(ctypes.c_int)]
        lib.vireo_probe_packed_mm_shape.restype = i
        lib.vireo_probe_nibbles_error_string.argtypes = [i]
        lib.vireo_probe_nibbles_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _bytes(name, p):
    """p as uint8 (int8 bytes are reinterpreted, as the JAX probes store
    uint8 patterns in int8)."""
    if p.dtype == torch.int8:
        return p.view(torch.uint8)
    if p.dtype != torch.uint8:
        raise TypeError("%s reads uint8 or int8 bytes, got %s"
                        % (name, p.dtype))
    return p


def nibble_unpack_reference(p):
    """Plain version of kernel A: (p & 15, p >> 4) as bf16."""
    q = _bytes("nibble_unpack", p)
    return (q & 15).to(torch.bfloat16), (q >> 4).to(torch.bfloat16)


def nibble_unpack(p, variant="int8"):
    """Kernel A: the (lo, hi) bf16 planes of bytes p, of p's shape, by
    the instruction sequence `variant`. CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise."""
    if variant not in VARIANTS:
        raise ValueError("nibble_unpack variant %r is not one of %s"
                         % (variant, VARIANTS))
    q = _bytes("nibble_unpack", p)
    if on_cpu("nibble_unpack", q):
        return nibble_unpack_reference(q)
    if q.numel() == 0:
        raise ValueError("nibble_unpack: no bytes")
    q = q.contiguous()
    if q.data_ptr() % 8:        # the kernel reads 8 bytes at a time
        q = q.clone()
    lo = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    hi = torch.empty_like(lo)
    lib = _library()
    launch("nibble_unpack", lib.vireo_probe_nibble_unpack,
           (q.data_ptr(), q.numel(), lo.data_ptr(), hi.data_ptr(),
            VARIANTS.index(variant)), q.device,
           lib.vireo_probe_nibbles_error_string)
    LAUNCHES["nibble_unpack_" + variant] += 1
    return lo, hi


def _check_mm(p, we, wo, codec):
    if codec not in CODECS:
        raise ValueError("packed_mm codec %r is not one of %s"
                         % (codec, CODECS))
    q = _bytes("packed_mm", p)
    if q.dim() != 2 or 0 in q.shape:
        raise ValueError("packed_mm: bytes of shape %s, not (V, Cb)"
                         % (tuple(q.shape),))
    weights = (we,) if codec == "raw_byte" else (we, wo)
    for w in weights:
        if w.dim() != 2 or w.shape != (q.shape[1], we.shape[1]):
            raise ValueError("packed_mm: weights of shape %s, not (%d, N)"
                             % (tuple(w.shape), q.shape[1]))
        if w.device != q.device:
            raise ValueError("packed_mm: operands on %s and %s"
                             % (q.device, w.device))
        if not w.is_floating_point():
            raise TypeError("packed_mm takes float weights, got %s"
                            % w.dtype)
    return q


def packed_mm_reference(p, we, wo=None, codec="nibble_int", dtype=None):
    """Plain version of kernel B in `dtype` (the device's working type by
    default): (p & 15) We + (p >> 4) Wo for the nibble codecs, and
    p (as signed bytes) We for raw_byte, a block of rows at a time."""
    q = _check_mm(p, we, wo, codec)
    dtype = dtype or default_dtype(q.device)
    V = q.shape[0]
    we = we.to(dtype)
    wo = None if codec == "raw_byte" else wo.to(dtype)
    out = torch.empty((V, we.shape[1]), dtype=dtype, device=q.device)
    for r0 in range(0, V, _ROWS):
        rows, res = q[r0:r0 + _ROWS], out[r0:r0 + _ROWS]
        if codec == "raw_byte":
            torch.matmul(rows.view(torch.int8).to(dtype), we, out=res)
        else:
            torch.matmul((rows & 15).to(dtype), we, out=res)
            res.addmm_((rows >> 4).to(dtype), wo)
    return out


def _cells_per_byte(codec):
    return 1 if codec == "raw_byte" else 2


def k_order(codec):
    """Kernel B's k order within a stage: entry L is the k value (cell,
    or byte for raw_byte) of the stage that the kernel's A fragments put
    at k L. L = 16 s + 8 h + 2 c + e (k16 step s, register half h, lane
    column c, element e) holds (KS / 4) c + 4 s + 2 h + e: lane column c
    builds its pairs from bytes 32 c .. 32 c + 31 of each row, pair
    2 s + h in step s."""
    ks = _STAGE_BYTES * _cells_per_byte(codec)
    L = torch.arange(ks)
    s, h, c, e = L // 16, (L // 8) % 2, (L // 2) % 4, L % 2
    return (ks // 4) * c + 4 * s + 2 * h + e


_ORDERS = {}


def _k_order_on(codec, device):
    """k_order on `device`, made once."""
    key = (codec, str(device))
    if key not in _ORDERS:
        _ORDERS[key] = k_order(codec).to(device)
    return _ORDERS[key]


def _ceil(a, b):
    return -(-a // b)


def mm_plan(V, row_bytes, N, codec, sms, blocks_per_sm):
    """Kernel B's plan for a (V, row_bytes) byte matrix against N
    columns on `sms` SMs holding `blocks_per_sm` blocks each: stages of
    128 bytes, slices of `slice_stages` whole stages, the units (256-row
    blocks x 16-column tiles x slices) and the persistent grid.

    The slices are those that minimise the stages the busiest block
    walks plus the scratch the slices add (each slice's (V, N) float32
    sums, written and read again), counted in stages of a block.
    `bounds` are the slices' k ranges, which tile [0, row_bytes x cells
    a byte) on stage boundaries. Made once for each set of arguments."""
    return dict(_mm_plan(V, row_bytes, N, codec, sms, blocks_per_sm))


@functools.lru_cache(maxsize=64)
def _mm_plan(V, row_bytes, N, codec, sms, blocks_per_sm):
    if min(V, row_bytes, N, sms, blocks_per_sm) <= 0:
        raise ValueError("packed_mm plan: V %d, row bytes %d, N %d, %d SMs "
                         "x %d blocks" % (V, row_bytes, N, sms,
                                          blocks_per_sm))
    stages = _ceil(row_bytes, _STAGE_BYTES)
    tiles = _ceil(V, _MM_ROWS) * _ceil(N, _N_TILE)
    slots = sms * blocks_per_sm
    stage_a = _MM_ROWS * _STAGE_BYTES
    best = None
    for n in range(1, stages + 1):
        per = _ceil(stages, n)
        if _ceil(stages, per) != n:     # the same slices as a smaller n
            continue
        rounds = _ceil(tiles * n, slots)
        cost = rounds * per + 8.0 * n * V * N / (slots * stage_a)
        if best is None or cost < best[0]:
            best = (cost, n, per, rounds)
    _, n, per, rounds = best
    ks = _STAGE_BYTES * _cells_per_byte(codec)
    k_len = row_bytes * _cells_per_byte(codec)
    units = tiles * n
    grid = min(units, slots)
    return dict(stage_k=ks, stages=stages, slice_stages=per, n_slices=n,
                bounds=[(i * per * ks, min((i + 1) * per * ks, k_len))
                        for i in range(n)],
                units=units, grid=grid, rounds=rounds, waves=units / grid)


def pad_rows(p, *weights):
    """p (V, Cb) with its rows padded by zero bytes to a multiple of 16
    (TMA's row stride), and each weight (Cb, N) by zero rows to match;
    the same tensors where Cb is a multiple of 16 already. The padding
    costs a copy of p."""
    cb = p.shape[1]
    pad = _ceil(cb, 16) * 16 - cb
    if not pad:
        return (p,) + weights
    padded = torch.zeros((p.shape[0], cb + pad), dtype=p.dtype,
                         device=p.device)
    padded[:, :cb] = p
    return (padded,) + tuple(
        None if w is None else torch.cat([w, w.new_zeros((pad, w.shape[1]))])
        for w in weights)


def mm_weights(we, wo, codec, stages):
    """Bᵀ for kernel B: (N, stages x KS) bf16, We at the even cells and
    Wo at the odd (We alone, a byte a k value, for raw_byte), zero past
    the contracted length, each stage's k values in `k_order`."""
    ks = _STAGE_BYTES * _cells_per_byte(codec)
    cb, N = we.shape
    b = torch.zeros((N, stages * ks), dtype=torch.bfloat16, device=we.device)
    if codec == "raw_byte":
        b[:, :cb] = we.t()
    else:
        b[:, 0:2 * cb:2] = we.t()
        b[:, 1:2 * cb:2] = wo.t()
    order = _k_order_on(codec, we.device)
    return b.view(N, stages, ks)[:, :, order].reshape(N, stages * ks)


_SHAPES = {}


def mm_shape(codec):
    """Kernel B's shape on the current card, from the library: k values
    and bytes a stage, stages in the ring, threads a block and blocks an
    SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    if codec not in _SHAPES:
        out = (ctypes.c_int * 5)()
        err = _library().vireo_probe_packed_mm_shape(CODECS.index(codec),
                                                     out)
        if err or out[4] <= 0:
            raise RuntimeError("packed_mm: no shape for codec %s (error %d, "
                               "%d blocks an SM)" % (codec, err, out[4]))
        _SHAPES[codec] = dict(stage_k=out[0], ring=out[1],
                              stage_bytes=out[2], threads=out[3],
                              blocks_per_sm=out[4])
    return _SHAPES[codec]


def card_plan(V, row_bytes, N, codec, device):
    """mm_plan on the card's SMs and kernel B's blocks an SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return mm_plan(V, row_bytes, N, codec, sms,
                   mm_shape(codec)["blocks_per_sm"])


def _mm_operands(p, we, wo, codec):
    """Kernel B's operands on the card: the (padded, 16-byte aligned)
    bytes, Bᵀ in the kernel's order, the plan, the (slices, V, N)
    scratch, and the C entry point's plan arguments."""
    q, we, wo = pad_rows(p.contiguous(), we, wo)
    if q.data_ptr() % 16:        # TMA reads from 16-byte aligned rows
        q = q.clone()
    V, row_bytes = q.shape
    N = we.shape[1]
    plan = card_plan(V, row_bytes, N, codec, q.device)
    b = mm_weights(we, wo, codec, plan["stages"])
    part = torch.empty((plan["n_slices"], V, N), dtype=torch.float32,
                       device=q.device)
    args = (q.data_ptr(), row_bytes, V, b.data_ptr(), N, plan["stages"],
            plan["slice_stages"], plan["n_slices"], plan["grid"],
            part.data_ptr())
    return q, b, part, plan, args


def packed_mm(p, we, wo=None, codec="nibble_int"):
    """Kernel B: (V, N) float32 sums of packed bytes p (V, Cb) against
    We, Wo (Cb, N), by `codec` (wo unused for raw_byte). CPU tensors run
    the plain version in float64; CUDA tensors launch the kernel on the
    weights rounded to bf16, or raise."""
    q = _check_mm(p, we, wo, codec)
    if on_cpu("packed_mm", q):
        return packed_mm_reference(q, we, wo, codec)
    q, b, part, plan, args = _mm_operands(q, we, wo, codec)
    out = torch.empty((q.shape[0], we.shape[1]), dtype=torch.float32,
                      device=q.device)
    lib = _library()
    launch("packed_mm", lib.vireo_probe_packed_mm,
           args + (out.data_ptr(), CODECS.index(codec)), q.device,
           lib.vireo_probe_nibbles_error_string)
    LAUNCHES["packed_mm_" + codec] += 1
    return out


def packed_mm_control(p, we, wo=None, codec="nibble_int"):
    """Kernel B's control on a card: the same ring, copies and fragment
    build with the MMAs left out. It computes nothing of use and counts
    no launch; chip_smoke.py times it beside the kernel."""
    q = _check_mm(p, we, wo, codec)
    if on_cpu("packed_mm_control", q):
        raise ValueError("packed_mm_control runs only on a card")
    q, b, part, plan, args = _mm_operands(q, we, wo, codec)
    lib = _library()
    launch("packed_mm_control", lib.vireo_probe_packed_mm_control,
           args + (CODECS.index(codec),), q.device,
           lib.vireo_probe_nibbles_error_string)
    return part
