"""Device and dtype policy of the port.

- The default device is the first CUDA card when there is one, else
  the CPU.
- The working float type is float32 on CUDA and float64 on the CPU:
  the CPU runs are the parity runs against the JAX package, whose CPU
  suite runs with x64 enabled.
- float32 matrix products run in full float32. PyTorch's CUDA matmul
  already defaults to that, but cuDNN's float32 convolutions default
  to TF32; `pin_matmul_precision` turns TF32 off for both. This is the
  counterpart of `Precision.HIGHEST` in
  `vireo_tpu/ops/counts.py::DenseCounts._precision`. The entry points
  (`engine.wrap.vireo_wrap`, the CLI) call it.
"""

import numpy as np
import torch

__all__ = ["default_device", "resolve_device", "default_dtype",
           "pin_matmul_precision", "numpy_dtype", "sync"]


def default_device():
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def resolve_device(device=None):
    if device is None:
        return default_device()
    return torch.device(device)


def default_dtype(device):
    return torch.float32 if torch.device(device).type == "cuda" \
        else torch.float64


def pin_matmul_precision():
    """Full-float32 products: TF32 off in cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def numpy_dtype(dtype):
    """The numpy float type of a torch float type."""
    return np.dtype(str(dtype).replace("torch.", ""))


def sync(device):
    """Wait for the device's queued work (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
