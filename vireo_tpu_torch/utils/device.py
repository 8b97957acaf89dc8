"""Device and dtype policy of the port.

- The default device is the first CUDA card. `VIREO_PLATFORM=cpu`
  asks for the CPU (the JAX package's variable for the same choice,
  vireo_tpu/utils/platform.py); `cuda` or `gpu`, or no value, asks for
  the card, and then a machine without one raises instead of running
  on the CPU. A `device=` argument wins over both.
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

import os

import numpy as np
import torch

__all__ = ["default_device", "resolve_device", "default_dtype",
           "pin_matmul_precision", "numpy_dtype", "sync"]


def default_device():
    platform = os.environ.get("VIREO_PLATFORM", "").lower()
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("", "cuda", "gpu"):
        raise ValueError("VIREO_PLATFORM=%s: the port runs on cuda (or gpu) "
                         "or cpu" % platform)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available; VIREO_PLATFORM=cpu "
                           "asks for the CPU")
    return torch.device("cuda")


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
