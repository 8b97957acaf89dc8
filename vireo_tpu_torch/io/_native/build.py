"""Build and load the native VCF / MatrixMarket parser and TSV writer
(counterpart of vireo_tpu/io/_native/build.py).

`vcfio.cpp` is compiled at first use with the system g++ (a plain C ABI,
loaded with ctypes) into `vireo_tpu_torch/_build/` (listed in
.gitignore), named by a hash of the source and of the flags, so an edit
of either builds anew and a checkout never loads a stale library.
`VIREO_NO_NATIVE` (any non-empty value) turns the library off. Without
a toolchain, or when the build fails, `lib()` returns None and the
callers use the pure-Python readers and writer; `build_error()` then
says why. This is host I/O: no device code is involved.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SRC", "BUILD_DIR", "CXX_FLAGS", "library_path", "lib",
           "available", "build_error"]

SRC = Path(__file__).resolve().with_name("vcfio.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_LIBS = ("-lz",)

_lock = threading.Lock()
_state = {"tried": False, "lib": None, "error": None}


class CellVcfView(ctypes.Structure):
    _fields_ = [
        ("n_var", ctypes.c_int64),
        ("n_samp", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("n_tags", ctypes.c_int32),
        ("variants", ctypes.c_char_p),
        ("samples", ctypes.c_char_p),
        ("fixed", ctypes.c_char_p),
        ("comments", ctypes.c_char_p),
        ("indptr", ctypes.POINTER(ctypes.c_int64)),
        ("indices", ctypes.POINTER(ctypes.c_int32)),
        ("values", ctypes.POINTER(ctypes.c_double)),
        ("error", ctypes.c_char_p),
        ("impl", ctypes.c_void_p),
    ]


def library_path():
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS + _LIBS).encode())
    return BUILD_DIR / ("libvcfio_%s.so" % h.hexdigest()[:16])


def _compile(out):
    """g++ the source into `out`; None on success, else the reason."""
    cxx = shutil.which("g++")
    if cxx is None:
        return "g++ not found on the PATH"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + ".%d.tmp" % os.getpid())
    cmd = [cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp), *_LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        return "%s: %s" % (" ".join(cmd), e)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return "%s failed:\n%s%s" % (" ".join(cmd), proc.stdout,
                                     proc.stderr)
    os.replace(tmp, out)        # atomic against concurrent builders
    return None


def _bind(lib):
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.cellvcf_load.restype = ctypes.POINTER(CellVcfView)
    lib.cellvcf_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_char_p, ctypes.c_int]
    lib.cellvcf_free.restype = None
    lib.cellvcf_free.argtypes = [ctypes.POINTER(CellVcfView)]
    lib.mmread_coo.restype = ctypes.c_int64
    lib.mmread_coo.argtypes = [ctypes.c_char_p, i64p, i32p, i32p, f64p]
    lib.mmread_csc.restype = ctypes.c_int64
    lib.mmread_csc.argtypes = [ctypes.c_char_p, i64p, i64p, i32p, f64p]
    lib.write_matrix_tsv.restype = ctypes.c_int64
    lib.write_matrix_tsv.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_char_p, f64p, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_char_p,
                                     ctypes.c_int32]
    return lib


def _load():
    out = library_path()
    if not out.is_file():
        err = _compile(out)
        if err is not None:
            return None, err
    try:
        return _bind(ctypes.CDLL(str(out))), None
    except OSError as e:
        return None, "loading %s: %s" % (out, e)


def lib():
    """The loaded native library, or None when VIREO_NO_NATIVE is set or
    it cannot be built (one attempt per process)."""
    if os.environ.get("VIREO_NO_NATIVE"):
        return None
    if not _state["tried"]:
        with _lock:
            if not _state["tried"]:
                _state["lib"], _state["error"] = _load()
                _state["tried"] = True
    return _state["lib"]


def available():
    return lib() is not None


def build_error():
    """Why `lib()` returns None (None while it has not or it loaded)."""
    if os.environ.get("VIREO_NO_NATIVE"):
        return "VIREO_NO_NATIVE is set"
    return _state["error"]
