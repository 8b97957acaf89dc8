"""The nibble-unpack probe (benchmarks/unpack_probe.py, P4) on the port:
kernel A (`nibbles.nibble_unpack`) turns each byte of two 4-bit counts
into two bf16 planes by three instruction sequences, each checked
against numpy on the probe's (256, 512) bytes:

- "int8 shift/and" (`k_int8_ops`): & and >> on the bytes, four to a
  32-bit register, then an int -> bf16 conversion;
- "int32 roundtrip" (`k_int32_ops`): each byte widened to 32 bits first;
- "bitcast->bf16 mantissa" (the counterpart of `k_bitcast_int4`, whose
  int4 bitcast splits rows, not columns, and fails in the JAX script):
  the nibble written into the mantissa of bf16 128.0, then 128
  subtracted, as K2 and K3 build their A fragments.

    python -m vireo_tpu_torch.probes.unpack_probe
"""

import numpy as np
import torch

from ..utils.device import resolve_device
from . import device_label
from .nibbles import nibble_unpack

__all__ = ["PROBES", "run", "main"]

# the JAX script's line names and kernel A's variants
PROBES = (("int8 shift/and", "int8"), ("int32 roundtrip", "int32"),
          ("bitcast->bf16 mantissa", "bitcast"))


def run(name, variant, p, label):
    """Unpack p by `variant`, print whether each plane equals numpy's
    (p & 15, p >> 4), and return the planes."""
    lo, hi = nibble_unpack(p, variant)
    pn = p.cpu().numpy().view(np.uint8)
    ok_lo = np.array_equal(lo.float().cpu().numpy(), pn & 15)
    ok_hi = np.array_equal(hi.float().cpu().numpy(), pn >> 4)
    print("%-28s lo_ok=%s hi_ok=%s  [%s]" % (name, ok_lo, ok_hi, label),
          flush=True)
    return lo, hi


def main(device=None):
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    p = torch.from_numpy(rng.randint(0, 256, size=(256, 512))
                         .astype(np.uint8).view(np.int8)).to(dev)
    label = device_label(dev)
    return {variant: run(name, variant, p, label)
            for name, variant in PROBES}


if __name__ == "__main__":
    main()
