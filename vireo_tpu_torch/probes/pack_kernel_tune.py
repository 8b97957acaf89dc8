"""The packed-matmul tuning probe (benchmarks/pack_kernel_tune.py, P5) on
the port: how much of kernel B's time is the unpack, and which unpack is
cheapest.

Kernel B (`nibbles.packed_mm`) at (30k x 100k) @ (100k x 16) with W
rounded to one bf16 term (the JAX script passes float32 W, which the
TPU's default precision rounds so; so the CPU's plain version computes
what the card does), in the JAX script's three variants (its codecs):

- base (`nibble_int`): K2's own unpack, & and >> on the byte, then the
  bf16 pair built by bit reinterpretation;
- f32u (`nibble_float`): one widening conversion and floor-division
  algebra;
- noup (`raw_byte`): the control. The raw signed bytes times We only
  (wrong values, the same bytes read, half the MMAs): what kernel B costs
  without an unpack.

base and f32u are checked against the int8 path first, to the JAX
script's max error below 1.0. The TPU's (block_v, block_c) sweep sized
VMEM blocks; kernel B's unit is fixed by the card (128 variants, 16
columns, stages of 128 bytes of each row, `nibbles.TILE`: the tensor
cores' m64 tile for each of two warpgroups and one 128-byte swizzle row
of a TMA box), and its k-slices and grid by `nibbles.mm_plan`, so the
sweep has no counterpart here, and there is no tuning knob.

    MB_VARS=.. MB_CELLS=.. MB_K=.. MB_ITERS=.. \\
        python -m vireo_tpu_torch.probes.pack_kernel_tune
"""

import torch

from ..utils.device import resolve_device
from . import device_label, ms_per_call
from ..ops.packed import pack_nibbles
from .int4_micro import dense_reference, make_pool, settings, split_weights
from .nibbles import TILE, packed_mm

__all__ = ["VARIANTS", "main"]

# the JAX script's variant names and kernel B's codecs
VARIANTS = (("base", "nibble_int"), ("f32u", "nibble_float"),
            ("noup", "raw_byte"))


def main(device=None):
    dev = resolve_device(device)
    s = settings()
    x8, w, _ = make_pool(s["V"], s["C"], s["K"], dev)
    p = pack_nibbles(x8)
    we, wo = (x.to(torch.bfloat16) for x in split_weights(w))
    ref = dense_reference(x8, w)
    del x8
    row = ["tile %5dx%-5d:" % TILE]
    times = {}
    for name, codec in VARIANTS:
        if codec != "raw_byte":
            err = float((packed_mm(p, we, wo, codec) - ref).abs().max())
            if not err < 1.0:
                raise AssertionError("%s: max error %g against the int8 "
                                     "path" % (name, err))
        times[name] = ms_per_call(lambda: packed_mm(p, we, wo, codec),
                                  s["ITERS"], dev)
        row.append("%s %6.2f ms" % (name, times[name]))
    print("  ".join(row) + "  [%s]" % device_label(dev), flush=True)
    return times


if __name__ == "__main__":
    main()
