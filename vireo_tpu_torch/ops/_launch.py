"""The two steps every kernel wrapper of the port shares.

`on_cpu` decides where a call runs: a CPU tensor runs the plain version,
a CUDA tensor the kernel, any other device raises. `launch` calls a
kernel library's C entry point on the device's current stream and raises
on its error code; there is no fallback to the plain version. The
wrapper counts the launch in its own `LAUNCHES` after `launch` returns.
"""

import torch

__all__ = ["on_cpu", "launch"]


def on_cpu(name, t):
    """True for a CPU tensor (the plain version runs), False for a CUDA
    one (the kernel launches); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError("%s runs on CUDA or CPU tensors, not %s"
                         % (name, t.device))
    return False


def launch(name, fn, args, device, error_string):
    """Call the C entry point fn(*args, stream) on the device's current
    stream; raise on a nonzero CUDA error code (error_string names it)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError("%s kernel launch failed: %s (code %d)"
                           % (name, error_string(err).decode(), err))
