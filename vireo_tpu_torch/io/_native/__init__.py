"""The native (C++) VCF / MatrixMarket reader and TSV writer, loaded with
ctypes (counterpart of vireo_tpu/io/_native).

The library is built at first use into `vireo_tpu_torch/_build/`; every
caller tolerates `lib() is None` and falls back to the pure-Python path.
"""

from .build import lib, available, build_error

__all__ = ["lib", "available", "build_error"]
