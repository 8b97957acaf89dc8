"""Build and load the port's CUDA kernels.

Each kernel source `vireo_tpu_torch/csrc/<name>.cu` has a plain C
interface. It is compiled by `nvcc` for Hopper (`sm_90a`) into a shared
library under `vireo_tpu_torch/_build/` (listed in .gitignore) at first
use, named by a hash of the source, of the headers it includes from
`csrc/` (`#include "..."`, followed recursively), and of the flags, and
loaded with ctypes. nvcc finds those headers beside the source, so no
include flag is passed. Nothing is built when a module is imported; a
missing `nvcc` or a failed build raises.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "source_path",
           "compiled_files", "find_nvcc", "nvcc_command", "library_path",
           "load_library"]

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOADED = {}
_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_path(name):
    return CSRC_DIR / (name + ".cu")


def compiled_files(name):
    """The source of kernel library `name` and the headers beside it that
    it includes, directly or through another header, in a fixed order."""
    seen, todo = set(), [source_path(name)]
    while todo:
        path = todo.pop()
        if path in seen or not path.is_file():
            continue
        seen.add(path)
        todo += [path.parent / h
                 for h in _LOCAL_INCLUDE.findall(path.read_text())]
    return sorted(seen)


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
    h = hashlib.sha256()
    for path in compiled_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / ("lib%s_%s.so" % (name, h.hexdigest()[:16]))


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

