"""The COO probe (benchmarks/coo_pallas_probe.py, P1-P3) on the port,
with its kernels C and D (csrc/probe_coo.cu) and their plain versions.

The COO rung's floor is a gather of one W row a nonzero. The JAX probe
asked whether a kernel could beat XLA's gather by reading W from on-chip
memory (P1, P3) or by adding nonzeros into an on-chip tile (P2); on the
TPU all three failed to compile (coo_pallas_probe_result.json). Here:

- C, `coo_gather(idx, val, w, layout)`: the K sums of val_m W[idx_m],
  W as (C, K) rows (`rows`, P1: out (1, K)) or as its transpose (K, C)
  (`cols`, P3: out (K, 1)); W staged in shared memory where it fits
  (C <= 3600 at K = 16 on an H100; a `cols` W transposed on the way),
  read through L2 otherwise (a `cols` W first transposed into a (C, K)
  scratch); four lanes a nonzero, eight nonzeros a quad of lanes in
  flight (`gather_shape` reports the grid and its sums' depth);
- D, `coo_scatter(r, c, v)`: out[r_m, c_m] += v_m into one (8, 128)
  tile (P2), by shared-memory atomics a block;
- `take_sum(idx, val, w)`: the probe's own library baseline
  (`probe_xla_take`), `index_select` and a weighted sum.

For tensors on a card C and D launch their kernels or raise; for tensors
on the CPU they run their plain versions (`index_select` and a weighted
sum; `index_put_(..., accumulate=True)`) in float64. Both kernels sum in
a fixed order (a second pass adds the blocks' partial sums in order);
D's atomics add within a block in no fixed order. `LAUNCHES` counts each
kernel's launches, C's by layout and by where W is read from
(`coo_gather_rows`, `coo_gather_rows_smem`, ...).

    python -m vireo_tpu_torch.probes.coo_pallas_probe   # PB_NNZ, PB_CELLS

prints the JAX script's JSON lines, with each probe's seconds (best of
three calls, each ending in a fetch of the sum, as JAX's `timed`) and ns
a nonzero, and the device every line ran on.
"""

import ctypes
import functools
import json
import os
import time

import numpy as np
import torch

from ..ops._build import load_library
from ..ops._launch import launch, on_cpu
from ..utils.device import default_dtype, resolve_device, sync
from . import device_label

__all__ = ["K", "BLK", "LAYOUTS", "TILE", "LAUNCHES", "coo_gather",
           "coo_gather_reference", "coo_scatter", "coo_scatter_reference",
           "take_sum", "gather_shape", "scatter_blocks",
           "timed", "probe_xla_take",
           "probe_gather", "probe_scatter", "probe_lane_gather", "main"]

K = 16
BLK = 2048          # nonzeros a grid step of the JAX probe: its input shapes
LAYOUTS = ("rows", "cols")
TILE = (8, 128)

# launches of each kernel: C by layout, `_smem` where W is staged in
# shared memory
LAUNCHES = dict.fromkeys(["coo_gather_%s%s" % (layout, smem)
                          for layout in LAYOUTS for smem in ("", "_smem")]
                         + ["coo_scatter"], 0)

_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        lib = load_library("probe_coo")
        ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.vireo_probe_coo_gather_shape.argtypes = [
            ll, i, i, ctypes.POINTER(ll)]
        lib.vireo_probe_coo_gather_shape.restype = i
        lib.vireo_probe_coo_scatter_blocks.argtypes = [ll]
        lib.vireo_probe_coo_scatter_blocks.restype = ll
        lib.vireo_probe_coo_gather.argtypes = [ptr, ptr, ptr, ll, i, i, i,
                                               ptr, ptr, ll, ptr, ptr]
        lib.vireo_probe_coo_gather.restype = i
        lib.vireo_probe_coo_scatter.argtypes = [ptr, ptr, ptr, ll, ptr, ll,
                                                ptr, ptr]
        lib.vireo_probe_coo_scatter.restype = i
        lib.vireo_probe_coo_error_string.argtypes = [i]
        lib.vireo_probe_coo_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _flat(name, x, dtype):
    if x.dtype != dtype:
        raise TypeError("%s takes %s, got %s" % (name, dtype, x.dtype))
    return x.reshape(-1)


def _check_gather(idx, val, w, layout):
    if layout not in LAYOUTS:
        raise ValueError("coo_gather layout %r is not one of %s"
                         % (layout, LAYOUTS))
    idx = _flat("coo_gather", idx, torch.int32)
    if not val.is_floating_point() or val.numel() != idx.numel():
        raise ValueError("coo_gather: %d float values for %d indices"
                         % (val.numel(), idx.numel()))
    if w.dim() != 2 or w.shape[1 if layout == "rows" else 0] != K:
        raise ValueError("coo_gather: W of shape %s, not %s"
                         % (tuple(w.shape),
                            "(C, %d)" % K if layout == "rows"
                            else "(%d, C)" % K))
    if not idx.numel():
        raise ValueError("coo_gather: no nonzeros")
    for x in (val, w):
        if x.device != idx.device:
            raise ValueError("coo_gather: operands on %s and %s"
                             % (idx.device, x.device))
    return idx, val.reshape(-1)


def coo_gather_reference(idx, val, w, layout="rows", dtype=None):
    """Plain version of kernel C in `dtype` (the device's working type by
    default): (1, K) for layout `rows` (w (C, K)), (K, 1) for `cols`
    (w (K, C))."""
    idx, val = _check_gather(idx, val, w, layout)
    dtype = dtype or default_dtype(idx.device)
    val = val.to(dtype)
    if layout == "rows":
        g = w.to(dtype).index_select(0, idx)              # (nnz, K)
        return (g * val[:, None]).sum(0, keepdim=True)
    g = w.to(dtype).index_select(1, idx)                  # (K, nnz)
    return (g * val[None, :]).sum(1, keepdim=True)


# the fields of kernel C's shape, in the C entry point's order
_SHAPE_KEYS = ("staged", "threads", "blocks_per_sm", "blocks",
               "per_thread", "shuffle_levels", "warps", "loads_in_flight")


def gather_shape(nnz, n_cell, layout="rows"):
    """Kernel C's launch on the current card for nnz nonzeros over n_cell
    cells: whether W is staged, threads a block, blocks an SM (the
    occupancy API), blocks, and its sums' tree: the most nonzeros one
    thread chains, the shuffle levels and the warps a block (then the
    blocks, in order), and the W-row loads a thread keeps in flight.
    Asked of the library once for each card and shape."""
    return dict(_gather_shape(int(nnz), int(n_cell), layout,
                              torch.cuda.current_device()))


@functools.lru_cache(maxsize=64)
def _gather_shape(nnz, n_cell, layout, device):
    out = (ctypes.c_longlong * len(_SHAPE_KEYS))()
    with torch.cuda.device(device):
        err = _library().vireo_probe_coo_gather_shape(
            nnz, n_cell, int(layout == "cols"), out)
    if err:
        raise RuntimeError("coo_gather: no launch shape for %d nonzeros "
                           "over %d cells (error %d)" % (nnz, n_cell, err))
    return dict(zip(_SHAPE_KEYS, out))


def scatter_blocks(nnz):
    """Kernel D's blocks, and so the rows of its partial sums."""
    return int(_library().vireo_probe_coo_scatter_blocks(int(nnz)))


def _aligned(x):
    """x contiguous at a 16-byte boundary (the kernels read 16-byte
    vectors)."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def coo_gather(idx, val, w, layout="rows"):
    """Kernel C: the K sums of val_m W[idx_m] (idx int32), (1, K) for
    layout `rows` (w (C, K)) or (K, 1) for `cols` (w (K, C)). CPU
    tensors run the plain version in float64; CUDA tensors launch the
    kernel (float32 idx, val and W) or raise."""
    idx, val = _check_gather(idx, val, w, layout)
    if on_cpu("coo_gather", idx):
        return coo_gather_reference(idx, val, w, layout)
    if val.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError("coo_gather takes float32 values and W, got %s/%s"
                        % (val.dtype, w.dtype))
    n_cell = w.shape[0] if layout == "rows" else w.shape[1]
    idx, val, w = _aligned(idx), _aligned(val), _aligned(w)
    shape = _gather_shape(idx.numel(), n_cell, layout, idx.device.index)
    # a cols W read through L2 is first transposed into rows here
    scratch = (torch.empty((n_cell, K), dtype=torch.float32,
                           device=idx.device)
               if layout == "cols" and not shape["staged"] else None)
    part = torch.empty((shape["blocks"], K), dtype=torch.float32,
                       device=idx.device)
    out = torch.empty(K, dtype=torch.float32, device=idx.device)
    lib = _library()
    launch("coo_gather", lib.vireo_probe_coo_gather,
           (idx.data_ptr(), val.data_ptr(), w.data_ptr(), idx.numel(),
            n_cell, int(layout == "cols"), shape["staged"],
            None if scratch is None else scratch.data_ptr(),
            part.data_ptr(), shape["blocks"], out.data_ptr()), idx.device,
           lib.vireo_probe_coo_error_string)
    LAUNCHES["coo_gather_%s%s" % (layout, "_smem" if shape["staged"]
                                  else "")] += 1
    return out.reshape((1, K) if layout == "rows" else (K, 1))


def _check_scatter(r, c, v):
    r, c = _flat("coo_scatter", r, torch.int32), _flat("coo_scatter", c,
                                                       torch.int32)
    v = v.reshape(-1)
    if not v.is_floating_point() or not r.numel() == c.numel() == v.numel():
        raise ValueError("coo_scatter: %d rows, %d columns and %d float "
                         "values" % (r.numel(), c.numel(), v.numel()))
    if not r.numel():
        raise ValueError("coo_scatter: no nonzeros")
    for x in (c, v):
        if x.device != r.device:
            raise ValueError("coo_scatter: operands on %s and %s"
                             % (r.device, x.device))
    return r, c, v


def coo_scatter_reference(r, c, v, dtype=None):
    """Plain version of kernel D in `dtype` (the device's working type by
    default): the (8, 128) tile of the sums of v at (r, c)."""
    r, c, v = _check_scatter(r, c, v)
    dtype = dtype or default_dtype(r.device)
    out = torch.zeros(TILE, dtype=dtype, device=r.device)
    return out.index_put_((r.long(), c.long()), v.to(dtype),
                          accumulate=True)


def coo_scatter(r, c, v):
    """Kernel D: the (8, 128) tile of the sums of v at (r, c) (int32,
    r < 8, c < 128; others add nothing on a card). CPU tensors run the
    plain version in float64; CUDA tensors launch the kernel (float32 v)
    or raise."""
    r, c, v = _check_scatter(r, c, v)
    if on_cpu("coo_scatter", r):
        return coo_scatter_reference(r, c, v)
    if v.dtype != torch.float32:
        raise TypeError("coo_scatter takes float32 values, got %s" % v.dtype)
    r, c, v = r.contiguous(), c.contiguous(), v.contiguous()
    lib = _library()
    blocks = scatter_blocks(r.numel())
    part = torch.empty((blocks, TILE[0] * TILE[1]), dtype=torch.float32,
                       device=r.device)
    out = torch.empty(TILE, dtype=torch.float32, device=r.device)
    launch("coo_scatter", lib.vireo_probe_coo_scatter,
           (r.data_ptr(), c.data_ptr(), v.data_ptr(), r.numel(),
            part.data_ptr(), blocks, out.data_ptr()), r.device,
           lib.vireo_probe_coo_error_string)
    LAUNCHES["coo_scatter"] += 1
    return out


def take_sum(idx, val, w):
    """The library baseline (JAX's `probe_xla_take`): val @ W[idx], one
    index_select and one product, in the tensors' type."""
    return torch.matmul(val.reshape(-1), w.index_select(0, idx.reshape(-1)))


def timed(fn, *args, n=3):
    """Best of n calls of fn(*args), in seconds, each ending in a fetch
    of the output's sum (as the JAX probe's `timed`), after one call."""
    float(fn(*args).sum())
    best = np.inf
    for _ in range(n):
        t = time.perf_counter()
        float(fn(*args).sum())
        best = min(best, time.perf_counter() - t)
    return best


# The inputs of each probe, drawn from RandomState(0) in the JAX probe's
# order and shapes, then placed on the device.

def _put(device, *arrays):
    return [torch.from_numpy(a).to(device) for a in arrays]


def probe_xla_take(nnz, C, device=None):
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    idx = rng.randint(0, C, size=nnz).astype(np.int32)
    val = rng.rand(nnz).astype(np.float32)
    W = rng.rand(C, K).astype(np.float32)
    return timed(take_sum, *_put(dev, idx, val, W))


def probe_gather(nnz, C, device=None):
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    n_blk = nnz // BLK
    idx = rng.randint(0, C, size=(n_blk * 16, 128)).astype(np.int32)
    val = rng.rand(n_blk * 16, 128).astype(np.float32)
    W = rng.rand(C, K).astype(np.float32)
    return timed(functools.partial(coo_gather, layout="rows"),
                 *_put(dev, idx, val, W))


def probe_scatter(nnz, device=None):
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    n_blk = nnz // BLK
    r = rng.randint(0, 8, size=(1, n_blk * BLK)).astype(np.int32)
    c = rng.randint(0, 128, size=(1, n_blk * BLK)).astype(np.int32)
    v = rng.rand(1, n_blk * BLK).astype(np.float32)
    return timed(coo_scatter, *_put(dev, r, c, v))


def probe_lane_gather(nnz, C, device=None):
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    n_blk = nnz // BLK
    idx = rng.randint(0, C, size=(n_blk * 16, 128)).astype(np.int32)
    val = rng.rand(n_blk * 16, 128).astype(np.float32)
    WT = rng.rand(K, C).astype(np.float32)
    return timed(functools.partial(coo_gather, layout="cols"),
                 *_put(dev, idx, val, WT))


def main(device=None):
    dev = resolve_device(device)
    nnz = int(os.environ.get("PB_NNZ", 4_194_304))
    C = int(os.environ.get("PB_CELLS", 100_000))
    results = {"nnz": nnz, "backend": dev.type, "device": device_label(dev)}
    for name, fn in [("xla_take", lambda: probe_xla_take(nnz, C, dev)),
                     ("pallas_vmem_gather",
                      lambda: probe_gather(nnz, C, dev)),
                     ("pallas_scalar_scatter",
                      lambda: probe_scatter(nnz, dev)),
                     ("pallas_lane_gather",
                      lambda: probe_lane_gather(nnz, C, dev))]:
        dt = fn()
        sync(dev)
        results[name + "_s"] = round(dt, 5)
        results[name + "_ns_per_nnz"] = round(1e9 * dt / nnz, 3)
        print(json.dumps({k: v for k, v in results.items()
                          if k.startswith(name)
                          or k in ("nnz", "backend", "device")}),
              flush=True)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
