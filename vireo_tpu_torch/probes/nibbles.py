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
"""

import ctypes

import torch

from ..ops._build import load_library
from ..ops._launch import launch, on_cpu
from ..utils.device import default_dtype

__all__ = ["VARIANTS", "CODECS", "LAUNCHES", "TILE", "nibble_unpack",
           "nibble_unpack_reference", "packed_mm", "packed_mm_reference"]

# kernel A's instruction sequences and kernel B's codecs, in the order of
# their numbers in probe_nibbles.cu
VARIANTS = ("int8", "int32", "bitcast")
CODECS = ("nibble_int", "nibble_float", "raw_byte")

# launches of each kernel, by variant and codec
LAUNCHES = dict.fromkeys(["nibble_unpack_" + v for v in VARIANTS]
                         + ["packed_mm_" + c for c in CODECS], 0)

# kernel B's block: 128 variants x k-blocks of 64 k values (cells, or
# bytes for raw_byte) x 16 columns. It has no other tile.
TILE = (128, 64)

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
        lib.vireo_probe_packed_mm.argtypes = [ptr, ll, i, ptr, ll, ll, ptr,
                                              i, i, ptr]
        lib.vireo_probe_packed_mm.restype = i
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


def packed_mm(p, we, wo=None, codec="nibble_int"):
    """Kernel B: (V, N) float32 sums of packed bytes p (V, Cb) against
    We, Wo (Cb, N), by `codec` (wo unused for raw_byte). CPU tensors run
    the plain version in float64; CUDA tensors launch the kernel on the
    weights rounded to bf16, or raise."""
    q = _check_mm(p, we, wo, codec)
    if on_cpu("packed_mm", q):
        return packed_mm_reference(q, we, wo, codec)
    V, Cb = q.shape
    N = we.shape[1]
    q = q.contiguous()
    # B^T, k values contiguous: cells (We at even cells, Wo at odd) for
    # the nibble codecs, bytes for raw_byte; rows padded to 16 bytes
    k_len = Cb if codec == "raw_byte" else 2 * Cb
    b = torch.zeros((1, N, -(-k_len // 8) * 8), dtype=torch.bfloat16,
                    device=q.device)
    if codec == "raw_byte":
        b[0, :, :Cb] = we.t()
    else:
        b[0, :, 0:k_len:2] = we.t()
        b[0, :, 1:k_len:2] = wo.t()
    out = torch.empty((V, N), dtype=torch.float32, device=q.device)
    lib = _library()
    launch("packed_mm", lib.vireo_probe_packed_mm,
           (q.data_ptr(), Cb, V, b.data_ptr(), b.shape[2], k_len,
            out.data_ptr(), N, CODECS.index(codec)), q.device,
           lib.vireo_probe_nibbles_error_string)
    LAUNCHES["packed_mm_" + codec] += 1
    return out
