"""vireo-tpu-torch: the PyTorch/CUDA port of vireo-tpu.

A second package beside `vireo_tpu` (the JAX reference). It keeps the
JAX package's module layout and public names, so each module here has a
counterpart of the same path under `vireo_tpu/`. It imports torch,
numpy and scipy only: never jax, and never `vireo_tpu` (whose package
import pulls in jax).

Submodules are imported on use; this file imports nothing heavy.
"""

from .version import __version__

__all__ = ["__version__"]
