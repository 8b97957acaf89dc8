"""Build and load the port's CUDA kernels.

Each kernel source `vireo_tpu_torch/csrc/<name>.cu` has a plain C
interface. It is compiled by `nvcc` for Hopper (`sm_90a`) into a shared
library under `vireo_tpu_torch/_build/` (listed in .gitignore) at first
use, named by a hash of the source and the flags, and loaded with
ctypes. Nothing is built when a module is imported; a missing `nvcc` or
a failed build raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "source_path",
           "find_nvcc", "nvcc_command", "library_path", "load_library"]

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOADED = {}


def source_path(name):
    return CSRC_DIR / (name + ".cu")


def find_nvcc():
    """nvcc from $CUDA_HOME, the PATH, or /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on the "
                       "PATH); the CUDA kernels cannot be built")


def nvcc_command(src, out, nvcc="nvcc"):
    return [str(nvcc), *NVCC_FLAGS, "-o", str(out), str(src)]


def library_path(name):
    src = source_path(name)
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / ("lib%s_%s.so" % (name, digest[:16]))


def load_library(name):
    """The ctypes handle of the built kernel library `name`, building it
    first when its hashed file is absent."""
    if name in _LOADED:
        return _LOADED[name]
    out = library_path(name)
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(out.name + ".%d.tmp" % os.getpid())
        cmd = nvcc_command(source_path(name), tmp, nvcc=find_nvcc())
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("building %s failed (%s):\n%s%s"
                               % (name, " ".join(cmd), proc.stdout,
                                  proc.stderr))
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _LOADED[name] = lib
    return lib
