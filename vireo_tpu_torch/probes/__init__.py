"""The probes of `benchmarks/` on the port: one module for each JAX
script, each an entry point that prints that script's lines, each line
naming the device it ran on.

    python -m vireo_tpu_torch.probes.unpack_probe      # P4
    python -m vireo_tpu_torch.probes.int4_micro        # P6
    python -m vireo_tpu_torch.probes.pack_kernel_tune  # P5
    python -m vireo_tpu_torch.probes.coo_pallas_probe  # P1-P3

P5 and P6 read MB_VARS, MB_CELLS, MB_K, MB_ITERS (and P6 MB_DTYPES),
P1-P3 PB_NNZ and PB_CELLS, with the JAX scripts' defaults.

They run on the card unless `VIREO_PLATFORM=cpu` or a `device=` argument
asks for the CPU (utils/device.py), where the kernels' plain versions
run instead. The six `pl.pallas_call` sites of the JAX scripts are four
Hopper kernels: A (`nibble_unpack`) and B (`packed_mm`) in
`nibbles.py` (csrc/probe_nibbles.cu), C (`coo_gather`) and D
(`coo_scatter`) in `coo_pallas_probe.py` (csrc/probe_coo.cu).
"""

import time

import torch

__all__ = ["device_label", "ms_per_call"]


def device_label(device):
    """What every probe line says of its device: `cpu`, or the card's
    name and index."""
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    return "%s (%s)" % (torch.cuda.get_device_name(device), device)


def ms_per_call(fn, n, device):
    """Milliseconds a call of fn, over n calls after one warm-up call: by
    CUDA events on a card, by the host clock on the CPU."""
    device = torch.device(device)
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / n

