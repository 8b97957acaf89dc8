"""Per-rank input: each rank loads only its cell range (counterpart of
vireo_tpu/parallel/loader.py).

Rank p of P owns cells [p * ceil(C / P), (p + 1) * ceil(C / P)) of the
pool (the last range short), keeps only those columns after reading,
and places its block; no rank's device holds another's cells.
"""

import numpy as np
import torch

from .mesh import CELL_AXIS, Layout, ShardedCounts

__all__ = ["process_cell_range", "load_cellSNP_sharded",
           "dense_counts_from_local"]


def process_cell_range(n_cell, process_id=None, n_processes=None):
    """The [lo, hi) cell range of rank `process_id` of `n_processes`
    (default: this rank of the world), and the range size c_local."""
    import torch.distributed as dist
    if process_id is None:
        process_id = dist.get_rank() if dist.is_initialized() else 0
    if n_processes is None:
        n_processes = dist.get_world_size() if dist.is_initialized() else 1
    c_local = -(-int(n_cell) // int(n_processes))
    lo = int(process_id) * c_local
    hi = min(lo + c_local, int(n_cell))
    return lo, hi, c_local


def load_cellSNP_sharded(dir_name, process_id=None, n_processes=None):
    """A cellSNP folder with only this rank's cell columns kept: returns
    (cell_dat, (lo, hi, c_local, n_cell)), the AD/DP CSC matrices and the
    barcodes sliced to the range (the port's reader, native where it
    builds)."""
    from ..io.matrices import read_cellSNP
    cell_dat = read_cellSNP(dir_name)
    n_cell = cell_dat["AD"].shape[1]
    lo, hi, c_local = process_cell_range(n_cell, process_id, n_processes)
    cell_dat["AD"] = cell_dat["AD"].tocsc()[:, lo:hi]
    cell_dat["DP"] = cell_dat["DP"].tocsc()[:, lo:hi]
    cell_dat["samples"] = cell_dat["samples"][lo:hi]
    return cell_dat, (lo, hi, c_local, n_cell)


def dense_counts_from_local(mesh, AD_local, DP_local, meta, dtype=np.int8):
    """This rank's int8 DenseCounts block from its columns (`meta` as
    `load_cellSNP_sharded` returns it), zero-padded to c_local cells, as
    a ShardedCounts of a (n_var, c_local * n_cell_shards) pool: the
    padded cells are zero-count cells of the model, as in
    vireo_tpu/parallel/loader.py:51-83. Counts above 127 saturate. On a
    vars axis the rank keeps its variants' rows."""
    from ..ops.counts import DenseCounts
    lo, hi, c_local, n_cell = (int(x) for x in meta)
    n_var = int(AD_local.shape[0])
    lay = Layout.even(mesh, (n_var, c_local * mesh.extent(CELL_AXIS)))
    if lay.cells != (lo, lo + c_local):
        raise ValueError("cells [%d, %d) are not this rank's range %s"
                         % (lo, hi, lay.cells))
    v0, v1 = lay.vars

    def block(M):
        d = np.asarray(M.todense() if hasattr(M, "todense") else M)[v0:v1]
        out = np.zeros((v1 - v0, c_local), dtype)
        out[:, :hi - lo] = np.minimum(d, 127).astype(dtype)
        return torch.from_numpy(out).to(mesh.device)

    return ShardedCounts(DenseCounts(block(AD_local), block(DP_local)), lay)
