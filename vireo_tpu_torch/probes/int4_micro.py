"""The packed-matmul probe (benchmarks/int4_micro.py, P6) on the port:
what binds the dense contraction at K = 16, memory or the MMAs, and what
4-bit packed counts (two a byte) give on the card.

Timed at the main pool's contraction, (30k x 100k) @ (100k x 16):

- the dense products, forward and transposed, as `torch.matmul` (JAX's
  XLA dots, `mm_loop`): on int8 counts, converted to bf16 in every call
  as `mm_loop`'s body converts them (PyTorch has no int8 x bf16 product,
  so this line pays the conversion's pass over memory), and on bf16
  counts (2 bytes a count). The JAX probe's reading: bf16 at about twice
  the int8 time means memory binds, equal times mean the MMAs do;
- kernel B (`nibbles.packed_mm`: a TMA producer warp, two wgmma
  consumer warpgroups, split-k over a persistent grid, one bf16 term of
  W) on the packed counts, 1.5 GB.

JAX chains its products in a `fori_loop` with a tiny dependence so that
XLA hoists nothing; PyTorch runs eagerly and hoists nothing, so each
line is MB_ITERS calls between two CUDA events. The JAX script's block
sweep (`int4_micro.py:172-180`) never passes its blocks to the kernel
and stops after one; kernel B has one tile (`nibbles.TILE`), timed
once.

    MB_VARS=.. MB_CELLS=.. MB_K=.. MB_ITERS=.. MB_DTYPES=0|1 \\
        python -m vireo_tpu_torch.probes.int4_micro
"""

import os

import numpy as np
import torch

from ..ops.packed import pack_nibbles
from ..utils.device import default_dtype, resolve_device
from . import device_label, ms_per_call
from .nibbles import TILE, packed_mm

__all__ = ["settings", "make_pool", "split_weights",
           "dense_reference", "mm_ms", "from_jax_packed", "main"]

# rows of one converted block of dense_reference
_ROWS = 2048


def settings():
    """The JAX script's environment variables, with its defaults."""
    env = os.environ
    return dict(V=int(env.get("MB_VARS", 30_000)),
                C=int(env.get("MB_CELLS", 100_000)),
                K=int(env.get("MB_K", 16)),
                ITERS=int(env.get("MB_ITERS", 30)),
                DTYPES=env.get("MB_DTYPES", "1") == "1")


def make_pool(V, C, K, device, seed=0):
    """int8 counts in [0, 12] (V, C), float32 weights W (C, K) and Wa
    (V, K) of a standard normal, drawn on the device (the JAX script draws
    the same distributions with jax.random)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    x8 = torch.randint(0, 13, (V, C), generator=g, dtype=torch.int8,
                       device=device)
    w = torch.randn((C, K), generator=g, device=device)
    wa = torch.randn((V, K), generator=g, device=device)
    return x8, w, wa


def split_weights(w):
    """W (C, K) -> (We, Wo), the rows of the even and odd cells, each
    ceil(C / 2) rows (Wo's last row zero for an odd C)."""
    we = w[0::2]
    wo = torch.zeros_like(we)
    wo[:w.shape[0] // 2] = w[1::2]
    return we.contiguous(), wo


def dense_reference(x8, w, dtype=None):
    """x8 @ bf16(W) in `dtype` (the device's working type by default), a
    block of rows at a time: the JAX script's check of packed_mm against
    the int8 path."""
    dtype = dtype or default_dtype(x8.device)
    wb = w.to(torch.bfloat16).to(dtype)
    out = torch.empty((x8.shape[0], w.shape[1]), dtype=dtype,
                      device=x8.device)
    for r0 in range(0, x8.shape[0], _ROWS):
        torch.matmul(x8[r0:r0 + _ROWS].to(dtype), wb,
                     out=out[r0:r0 + _ROWS])
    return out


def mm_ms(x, w, n, transposed=False):
    """ms of one dense product x @ W (or x^T @ W) over n calls: bf16
    operands and output, float32 sums inside cuBLAS; int8 x is converted
    to bf16 in each call."""
    wb = w.to(torch.bfloat16)

    def once():
        xb = x if x.dtype == torch.bfloat16 else x.to(torch.bfloat16)
        return torch.matmul(xb.t() if transposed else xb, wb)
    return ms_per_call(once, n, x.device)


def from_jax_packed(p, we, wo, n_var, n_cell, device="cpu"):
    """The JAX probe's operands in the port's layout: its padded int8
    bytes (Vp, Ch) and padded We, Wo (Ch, K), as numpy arrays, -> the
    unpadded uint8 (n_var, ceil(n_cell / 2)) bytes (K2's layout,
    ops/packed.py) and We, Wo (ceil(n_cell / 2), K), as tensors."""
    cb = (n_cell + 1) // 2
    p = np.ascontiguousarray(np.asarray(p)[:n_var, :cb]).view(np.uint8)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (p, np.asarray(we)[:cb], np.asarray(wo)[:cb]))


def main(device=None):
    dev = resolve_device(device)
    s = settings()
    V, C, K, ITERS = s["V"], s["C"], s["K"], s["ITERS"]
    label = device_label(dev)
    x8, w, wa = make_pool(V, C, K, dev)

    if s["DTYPES"]:
        t = mm_ms(x8, w, ITERS)
        tt = mm_ms(x8, wa, ITERS, transposed=True)
        print("int8  fwd %6.2f ms   T %6.2f ms   (per matmul, /%d)  [%s]"
              % (t, tt, ITERS, label), flush=True)
        # bf16 counts (2 B/count): ~2x the int8 product alone means
        # memory binds, ~equal means the MMAs do
        xb = x8.to(torch.bfloat16)
        t = mm_ms(xb, w, ITERS)
        tt = mm_ms(xb, wa, ITERS, transposed=True)
        print("bf16  fwd %6.2f ms   T %6.2f ms  [%s]" % (t, tt, label),
              flush=True)
        del xb

    p = pack_nibbles(x8)
    we, wo = (x.to(torch.bfloat16) for x in split_weights(w))
    ref = dense_reference(x8[:256], w)
    got = packed_mm(p[:256], we, wo)
    err = float((ref - got).abs().max())
    print("packed_mm max err vs int8 path: %.3g  [%s]" % (err, label),
          flush=True)
    t = ms_per_call(lambda: packed_mm(p, we, wo), ITERS, dev)
    print("pack4 fwd %6.2f ms   (tile %dx%d)  [%s]"
          % (t, TILE[0], TILE[1], label), flush=True)
    if dev.type == "cuda":
        print("bytes_in_use %.2f GiB  [%s]"
              % (torch.cuda.memory_allocated(dev) / 2**30, label),
              flush=True)
    else:
        print("bytes_in_use not measured  [%s]" % label, flush=True)
    return err


if __name__ == "__main__":
    main()
