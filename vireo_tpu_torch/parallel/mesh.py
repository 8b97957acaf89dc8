"""Multi-GPU execution: the cell-sharded and the vars x cells fit over
torch.distributed (counterpart of vireo_tpu/parallel/mesh.py).

One process per rank, each holding only its block of the counts:

- `Mesh`: the world's ranks on a grid with named dimensions ("cells",)
  or ("vars", "cells"), a torch.distributed DeviceMesh laid out as
  `make_mesh2d` lays out its devices in the JAX package (rank r at vars
  index r // n_cells and cells index r % n_cells), with the collectives
  over each dimension;
- `Layout`: which block of a (n_var, n_cell) pool each rank holds:
  equal ranges of cells (and of variants on a vars axis), the last one
  short where the extent does not divide;
- `ShardedCounts`: a rank's counts object (DenseCounts, PackedCounts,
  HybridCounts or SparseCounts) behind the model's two contractions.
  Where the JAX package psums inside shard_map or lets GSPMD insert a
  reduction, it all-reduces: the variant-side statistics over the
  `cells` group, the cell-side partial logliks over the `vars` group.
  The model adds the rest (models/vireo.py): the per-cell ELBO terms
  over `cells`, the genotype and theta terms over `vars`.

Every rank runs the same control flow: each decision the host takes
(a fit's stop test, the warm winner, the donor branches) reads values
that the collectives made identical on every rank.

The fit entry points of the JAX package are here with its names:
`fit_vb_auto` and `warm_restarts_auto` (both layouts), and the COO and
dense shard paths `sharded_fit_vb` and `sharded_fit_vb_dense` over the
host blocks of `build_cell_sharded_coo` and `build_cell_sharded_dense`.
Each takes and returns global states: a rank takes its block of the
state and the result is gathered.
"""

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..utils.timing import span

__all__ = ["CELL_AXIS", "VAR_AXIS", "Mesh", "Layout", "ShardedCounts",
           "make_mesh", "make_mesh2d", "count_spec", "n_cell_shards",
           "initialize_distributed", "shard_bounds", "shard_state",
           "gather_state", "shard_priors", "gather_priors",
           "build_cell_sharded_coo", "build_cell_sharded_dense",
           "sharded_fit_vb", "sharded_fit_vb_dense", "fit_vb_auto",
           "warm_restarts_auto", "fit_sharded", "world_size", "world_min"]

CELL_AXIS = "cells"
VAR_AXIS = "vars"

# seconds a collective may wait for the other ranks before it fails: a
# rank that left the common control flow stops the run instead of
# hanging it
GROUP_TIMEOUT_S = 120

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def _group_options(backend, timeout):
    """Process-group options that carry `timeout`, for the mesh's
    sub-groups (which otherwise get torch's default of 30 minutes)."""
    opts = (dist.ProcessGroupNCCL.Options() if backend == "nccl"
            else dist.ProcessGroupGloo._Options())
    opts._timeout = timeout
    return opts


def _device_mesh(device_type, sizes, names, backend, timeout):
    """init_device_mesh with the names, each sub-group given `timeout`."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(
        device_type, tuple(sizes), mesh_dim_names=tuple(names),
        backend_override={n: (backend, _group_options(backend, timeout))
                          for n in names})


def _rank_device(device=None):
    """The device this rank computes on: the CPU when asked for (a
    `device` argument or VIREO_PLATFORM=cpu), else the card that
    `initialize_distributed` selected."""
    from ..utils.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """The world's ranks on a named grid; every rank builds the same
    mesh, in the same order, as with any torch.distributed group.

    `shape`: {axis: extent} in grid order, ("vars", "cells") or
    ("cells",); the product is the world size. `device`: this rank's
    device (default: the card `initialize_distributed` selected, or the
    CPU when asked for). The collectives take tensors on that device or
    on the CPU and return them on the device they came from.
    """

    def __init__(self, shape, device=None):
        if not dist.is_initialized():
            raise RuntimeError(
                "a mesh needs torch.distributed: launch the ranks with "
                "python -m torch.distributed.run --nproc-per-node N (or "
                "call parallel.mesh.initialize_distributed)")
        names = tuple(shape)
        sizes = tuple(int(shape[n]) for n in names)
        world = dist.get_world_size()
        if int(np.prod(sizes)) != world or min(sizes) < 1:
            raise ValueError(
                "mesh %s needs %d ranks, the world has %d: launch %d with "
                "python -m torch.distributed.run --nproc-per-node %d"
                % ("x".join(map(str, sizes)), int(np.prod(sizes)), world,
                   int(np.prod(sizes)), int(np.prod(sizes))))
        self.shape = dict(zip(names, sizes))
        self.device = _rank_device(device)
        self.backend = dist.get_backend()
        self.device_mesh = _device_mesh(
            self.device.type, sizes, names, self.backend,
            datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        self.coords = dict(zip(names, self.device_mesh.get_coordinate()))
        self._groups = {n: self.device_mesh.get_group(n) for n in names}

    def __repr__(self):
        return "Mesh(%s, rank %d, %s, %s)" % (self.shape, self.rank,
                                              self.device, self.backend)

    @property
    def axis_names(self):
        return tuple(self.shape)

    @property
    def size(self):
        return int(np.prod(list(self.shape.values())))

    @property
    def rank(self):
        return dist.get_rank()

    @property
    def is_root(self):
        return self.rank == 0

    def has(self, axis):
        return axis in self.shape

    def splits(self, axis):
        """Whether `axis` splits its data over more than one rank."""
        return self.extent(axis) > 1

    def extent(self, axis):
        """Ranks along `axis` (1 where the mesh has no such axis)."""
        return self.shape.get(axis, 1)

    def coord(self, axis):
        """This rank's index along `axis` (0 where there is none)."""
        return self.coords.get(axis, 0)

    def _group(self, axis):
        return None if axis is None else self._groups[axis]

    def _wire(self, x):
        """x as a contiguous tensor on a device the backend carries:
        NCCL takes only the card's tensors, so a host tensor crosses to
        the rank's card and back; gloo takes host tensors and the card's
        (allreduce, allgather and broadcast have CUDA forms in gloo)."""
        if self.backend == "nccl" and x.device.type != "cuda":
            return x.to(self.device)
        return x.contiguous()

    def all_reduce(self, x, axis=None, op="sum"):
        """x reduced (sum, min or max) over the ranks of `axis` (None:
        the world). A contiguous x on a device the backend carries is
        reduced in place; use the returned tensor."""
        y = self._wire(x)
        dist.all_reduce(y, op=_OPS[op], group=self._group(axis))
        return y if y.device == x.device else y.to(x.device)

    def all_gather(self, x, axis=None, dim=0, sizes=None):
        """The pieces of x from the ranks of `axis` (None: the world), in
        the order of their coordinate, concatenated along `dim`.
        `sizes[i]`: the extent of piece i along `dim` (default: x's on
        every rank); the pieces travel padded to the largest."""
        n = self.size if axis is None else self.extent(axis)
        if sizes is None:
            sizes = [x.shape[dim]] * n
        top = max(sizes)
        y = self._wire(x)
        if y.shape[dim] < top:
            pad = list(y.shape)
            pad[dim] = top - y.shape[dim]
            y = torch.cat([y, y.new_zeros(pad)], dim=dim)
        out = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(out, y.contiguous(), group=self._group(axis))
        got = torch.cat([o.narrow(dim, 0, s) for o, s in zip(out, sizes)],
                        dim=dim)
        return got if got.device == x.device else got.to(x.device)

    def broadcast(self, x, src=0):
        """Rank `src`'s x on every rank."""
        y = self._wire(x).clone()
        dist.broadcast(y, src=src)
        return y if y.device == x.device else y.to(x.device)

    def barrier(self):
        self.all_reduce(torch.zeros(1, device=self.device))


def make_mesh(n_devices=None, devices=None, axis=CELL_AXIS, device=None):
    """The 1-D mesh of every rank along `axis` (cells by default).
    `n_devices`, where given, must be the world size (a rank cannot be
    left out of a torch.distributed mesh); `devices` is accepted for the
    JAX signature and must be None."""
    if devices is not None:
        raise ValueError("a rank computes on its own device; pass device=")
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else int(n_devices)
    return Mesh({axis: n}, device=device)


def make_mesh2d(n_var_shards, n_cell_shards=None, devices=None, device=None):
    """The 2-D (vars x cells) mesh: variants split `n_var_shards` ways
    and cells `n_cell_shards` ways (default: the world over the vars
    extent). The capacity layout of vireo_tpu/parallel/mesh.py:49-71: a
    rank holds a (V / n_var_shards, C / n_cell_shards) block, and its
    genotype state follows its variants."""
    if devices is not None:
        raise ValueError("a rank computes on its own device; pass device=")
    world = dist.get_world_size() if dist.is_initialized() else 1
    nv = int(n_var_shards)
    nc = world // nv if n_cell_shards is None else int(n_cell_shards)
    return Mesh({VAR_AXIS: nv, CELL_AXIS: nc}, device=device)


def count_spec(mesh):
    """Which mesh axes split the (n_var, n_cell) counts: (vars or None,
    cells), the PartitionSpec of vireo_tpu/parallel/mesh.py:74-79."""
    return (VAR_AXIS if mesh.has(VAR_AXIS) else None, CELL_AXIS)


def n_cell_shards(mesh):
    """Number of shards along the cell axis."""
    return mesh.extent(CELL_AXIS)


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, store=None, device=None):
    """Join this process to the world (the counterpart of
    vireo_tpu/parallel/mesh.py:87-115). Returns True when a process
    group is (or already was) initialized, False when nothing asks for
    one.

    The world comes from the arguments, or from VIREO_COORDINATOR
    (host:port, with VIREO_NUM_PROCESSES and VIREO_PROCESS_ID), or from
    the RANK, WORLD_SIZE and MASTER_ADDR that `torch.distributed.run`
    sets; `store` (a torch.distributed Store) replaces the rendezvous.

    Each rank computes on `cuda:{local rank}` when the node has a card a
    rank, and the collectives go over NCCL; ranks that share a card
    (more local ranks than cards) use `cuda:{local rank % cards}` and
    gloo, on the same CUDA tensors; a rank on the CPU (VIREO_PLATFORM=cpu
    or device="cpu") uses gloo. Without a card and without the CPU asked
    for, it raises. Every group fails a collective that waits more than
    GROUP_TIMEOUT_S seconds. Rank 0 prints the choice.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    coordinator = coordinator_address or env.get("VIREO_COORDINATOR")
    launched = "RANK" in env and "WORLD_SIZE" in env
    if store is None and coordinator is None and num_processes is None \
            and not launched:
        return False
    world = int(num_processes if num_processes is not None else
                env.get("VIREO_NUM_PROCESSES", env.get("WORLD_SIZE", 1)))
    rank = int(process_id if process_id is not None else
               env.get("VIREO_PROCESS_ID", env.get("RANK", 0)))
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))

    from ..utils.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        shared = local_world > cards
        dev = torch.device("cuda", local_rank % cards if shared
                           else local_rank)
        torch.cuda.set_device(dev)
        backend = "gloo" if shared else "nccl"
    else:
        backend = "gloo"
    kw = dict(backend=backend, rank=rank, world_size=world,
              timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    if store is not None:
        kw["store"] = store
    elif coordinator is not None:
        kw["init_method"] = coordinator if "://" in coordinator \
            else "tcp://" + coordinator
    else:
        kw["init_method"] = "env://"
    dist.init_process_group(**kw)
    if rank == 0:
        print("[vireo] torch.distributed: %d ranks, backend %s, rank 0 on "
              "%s%s" % (world, backend, dev,
                        " (ranks share the card)" if backend == "gloo"
                        and dev.type == "cuda" else ""), flush=True)
    return True


def world_size():
    """Ranks in the world (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def world_min(value):
    """The smallest of every rank's `value` (a float), on every rank;
    `value` itself without a process group. A decision that reads a
    per-rank quantity (free device memory) takes this, so that every
    rank decides alike."""
    if not dist.is_initialized():
        return float(value)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([float(value)], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return float(t)


# ---------------------------------------------------------------------
# which block each rank holds
# ---------------------------------------------------------------------

def shard_bounds(n, n_shards, block=None):
    """(lo, hi) of each of `n_shards` ranges over n items: blocks of
    `block` (default ceil(n / n_shards)), the last ones short or empty."""
    if block is None:
        block = -(-int(n) // int(n_shards))
    return tuple((min(s * block, n), min((s + 1) * block, n))
                 for s in range(int(n_shards)))


@dataclasses.dataclass(frozen=True)
class Layout:
    """The blocks of a (n_var, n_cell) pool on a mesh: the model's
    variant range (vars axis) and cell range (cells axis) of each shard
    index. A rank holds the block at its coordinates."""
    mesh: Mesh
    shape: tuple
    var_bounds: tuple
    cell_bounds: tuple

    @classmethod
    def even(cls, mesh, shape, cell_block=None):
        """Equal ranges (`shard_bounds`), cells in blocks of `cell_block`
        where given."""
        V, C = (int(s) for s in shape)
        return cls(mesh, (V, C), shard_bounds(V, mesh.extent(VAR_AXIS)),
                   shard_bounds(C, mesh.extent(CELL_AXIS), cell_block))

    def bounds(self, axis):
        return self.var_bounds if axis == VAR_AXIS else self.cell_bounds

    def range(self, axis):
        """This rank's (lo, hi) along `axis`."""
        return self.bounds(axis)[self.mesh.coord(axis)]

    @property
    def vars(self):
        return self.range(VAR_AXIS)

    @property
    def cells(self):
        return self.range(CELL_AXIS)

    @property
    def n_var_local(self):
        lo, hi = self.vars
        return hi - lo

    @property
    def n_cell_local(self):
        lo, hi = self.cells
        return hi - lo

    def take(self, x, axis, dim):
        """This rank's range of x (numpy or tensor, global along `dim`)."""
        lo, hi = self.range(axis)
        index = [slice(None)] * x.ndim
        index[dim] = slice(lo, hi)
        return x[tuple(index)]

    def gather(self, x, axis, dim):
        """The global tensor along `dim` from each rank's range along
        `axis` (x itself where the mesh has no such axis)."""
        if not self.mesh.has(axis):
            return x
        d = dim % x.ndim
        return self.mesh.all_gather(
            x, axis, dim=d, sizes=[hi - lo for lo, hi in self.bounds(axis)])


# ---------------------------------------------------------------------
# the model's state and priors on a layout
# ---------------------------------------------------------------------

def _state_axes(ase):
    """(field, axis, dim) of a VireoState's sharded axes; theta follows
    the variants in ASE mode only (else it is one row, replicated)."""
    axes = [("id_prob", CELL_AXIS, -2), ("gt_prob", VAR_AXIS, -3)]
    if ase:
        axes += [("beta_mu", VAR_AXIS, -2), ("beta_sum", VAR_AXIS, -2)]
    return axes


def _own(x):
    """A block as its own contiguous array (a view would keep the whole
    global array alive)."""
    return x.contiguous() if torch.is_tensor(x) else np.ascontiguousarray(x)


def shard_state(state, layout, ase):
    """This rank's block of a global state (numpy or tensors)."""
    return dataclasses.replace(state, **{
        f: _own(layout.take(getattr(state, f), axis, dim))
        for f, axis, dim in _state_axes(ase)})


def gather_state(state, layout, ase):
    """The global state from each rank's block (every rank gets it)."""
    return dataclasses.replace(state, **{
        f: layout.gather(getattr(state, f), axis, dim)
        for f, axis, dim in _state_axes(ase)})


# (field, axis, dim) of VireoPriors; a row prior (extent 1 along `dim`)
# is broadcast, any other follows its axis
_PRIOR_AXES = (("theta_s1", VAR_AXIS, -2), ("theta_s2", VAR_AXIS, -2),
               ("id_log", CELL_AXIS, -2), ("gt_log", VAR_AXIS, -3))


def shard_priors(priors, layout):
    return dataclasses.replace(priors, **{
        f: layout.take(getattr(priors, f), axis, dim)
        for f, axis, dim in _PRIOR_AXES if getattr(priors, f).shape[dim] != 1})


def gather_priors(priors, layout):
    return dataclasses.replace(priors, **{
        f: layout.gather(getattr(priors, f), axis, dim)
        for f, axis, dim in _PRIOR_AXES if getattr(priors, f).shape[dim] != 1})


# ---------------------------------------------------------------------
# a rank's counts behind the model's contractions
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedCounts:
    """A rank's counts object `local` at `layout`'s block: the model sees
    a (n_var, n_cell) pool, the rank holds its variants and cells.

    `local` may store more cells than its range: zero-count cells that
    complete a layout's block (MeshPackedCounts' grid), which the
    contractions pad with zero weights and cut from their outputs.
    Variant-side results are this rank's variants summed over every
    cell (all-reduced over `cells`); cell-side results are this rank's
    cells summed over every variant (all-reduced over `vars`). The
    scalars are the whole pool's, on every rank.
    """
    local: object
    layout: Layout

    @property
    def mesh(self):
        return self.layout.mesh

    @property
    def n_var(self):
        return self.layout.shape[0]

    @property
    def n_cell(self):
        return self.layout.shape[1]

    @property
    def device(self):
        return self.local.device

    def _pad_cells(self, W):
        n = self.layout.n_cell_local
        if W.shape[0] != n:
            raise ValueError("this rank holds %d cells, the weights have %d"
                             " rows" % (n, W.shape[0]))
        extra = self.local.n_cell - n
        return W if extra == 0 else torch.cat(
            [W, W.new_zeros((extra,) + tuple(W.shape[1:]))])

    def suff_stats(self, W):
        """(AD @ W, DP @ W) for this rank's cells' weights (n_cell_local,
        N) -> two (n_var_local, N), summed over every cell."""
        with span("suff_stats"):
            S1, SS = self.local.suff_stats(self._pad_cells(W))
            S = self.mesh.all_reduce(torch.stack([S1, SS]), CELL_AXIS)
            return S[0], S[1]

    def cell_loglik(self, Wa, Wd):
        """AD.T @ Wa + DP.T @ Wd for this rank's variants' weights
        (n_var_local, N) -> (n_cell_local, N), summed over every
        variant."""
        with span("cell_loglik"):
            out = self.local.cell_loglik(Wa, Wd)[:self.layout.n_cell_local]
            if self.mesh.has(VAR_AXIS):
                out = self.mesh.all_reduce(out.contiguous(), VAR_AXIS)
            return out

    def binom_coeff_sum(self):
        with span("binom"):
            return self.mesh.all_reduce(self.local.binom_coeff_sum())

    def row_sums(self):
        a, d = self.local.row_sums()
        s = self.mesh.all_reduce(torch.stack([a, d]), CELL_AXIS)
        return s[0], s[1]

    def n_vars_per_cell(self):
        n = self.local.n_vars_per_cell()[:self.layout.n_cell_local]
        if self.mesh.has(VAR_AXIS):
            n = self.mesh.all_reduce(n.contiguous(), VAR_AXIS)
        return n

    def var_subset(self, idx):
        """The variant rows `idx` of the pool, each rank keeping its
        cells. Variants are not split on a cells-only mesh, so the
        subset is a block layout there; with them split it is not."""
        if self.mesh.splits(VAR_AXIS):
            raise ValueError("var_subset keeps a block layout only on a "
                             "mesh without a vars axis")
        from ..ops.counts import _row_index
        idx = _row_index(idx, "cpu").numpy()
        lay = dataclasses.replace(self.layout, shape=(len(idx), self.n_cell),
                                  var_bounds=((0, len(idx)),))
        return dataclasses.replace(self, local=self.local.var_subset(idx),
                                   layout=lay)

    def _common_dtype(self, dtype):
        """The widest of the ranks' dense types (int8, bfloat16, int16,
        float32), so that their blocks can travel together: each holds
        every count of the ones before it exactly."""
        order = (torch.int8, torch.bfloat16, torch.int16, torch.float32,
                 torch.float64)
        i = torch.tensor([order.index(dtype)], device=self.mesh.device)
        return order[int(self.mesh.all_reduce(i, op="max"))]

    def _gather_dense(self, d, sizes, axes=(CELL_AXIS, VAR_AXIS)):
        """The blocks `d` (DenseCounts of this rank's variants and
        `sizes[my cell index]` cells) of every rank along `axes` as one
        DenseCounts, in the widest of the ranks' types."""
        from ..ops.counts import DenseCounts
        dtype = self._common_dtype(d.ad.dtype)
        out = []
        for x in (d.ad, d.dp):
            x = x.to(dtype)
            if CELL_AXIS in axes and self.mesh.has(CELL_AXIS):
                x = self.mesh.all_gather(x, CELL_AXIS, dim=1, sizes=sizes)
            if VAR_AXIS in axes:
                x = self.layout.gather(x, VAR_AXIS, 0)
            out.append(x)
        return DenseCounts(*out)

    def gather_rows(self, idx):
        """The pool's variant rows `idx` (ascending) over every cell, as
        one DenseCounts on every rank: each rank densifies the rows of
        its variants in its cells, and the blocks are all-gathered."""
        from ..ops.counts import DenseCounts
        idx = np.asarray(idx, np.int64)
        v_lo, v_hi = self.layout.vars
        mine = idx[(idx >= v_lo) & (idx < v_hi)] - v_lo
        n = self.layout.n_cell_local
        d = self.local.var_subset(mine).densify()
        d = self._gather_dense(DenseCounts(d.ad[:, :n], d.dp[:, :n]),
                               [hi - lo for lo, hi in self.layout.cell_bounds],
                               axes=(CELL_AXIS,))
        if self.mesh.has(VAR_AXIS):
            sizes = [int(((idx >= lo) & (idx < hi)).sum())
                     for lo, hi in self.layout.var_bounds]
            d = DenseCounts(*(self.mesh.all_gather(x, VAR_AXIS, 0, sizes)
                              for x in (d.ad, d.dp)))
        return d

    def densify(self):
        """The whole pool as a DenseCounts on every rank (in the widest
        of the ranks' exact types)."""
        n = self.layout.n_cell_local
        d = self.local.densify()
        from ..ops.counts import DenseCounts
        d = DenseCounts(d.ad[:, :n], d.dp[:, :n])
        return self._gather_dense(d, [hi - lo for lo, hi in
                                      self.layout.cell_bounds])

    def cell_slice(self, start, stop):
        """Cells [start, stop) of the pool as a DenseCounts on every rank:
        each rank unpacks only its overlap with the range
        (vireo_tpu/ops/packed.py:566-579)."""
        start, stop = int(start), int(stop)

        def overlap(lo, hi):
            a = min(max(lo, start), hi)
            return a, max(min(hi, stop), a)

        sizes = [b - a for a, b in (overlap(lo, hi) for lo, hi in
                                    self.layout.cell_bounds)]
        lo, hi = self.layout.cells
        a, b = overlap(lo, hi)
        part = self.local.cell_slice(a - lo, b - lo).densify()
        return self._gather_dense(part, sizes)


# ---------------------------------------------------------------------
# host-side shard builders (numpy and scipy only)
# ---------------------------------------------------------------------

def build_cell_sharded_coo(AD, DP, n_shards, dtype=np.float32,
                           pad_multiple=1024):
    """Split cells into `n_shards` equal ranges and pack each range's COO
    triplets (local cell indices) into equal padded blocks, concatenated
    (vireo_tpu/parallel/mesh.py:257-330, the same arrays and meta).

    Returns (arrays dict, meta dict)."""
    import scipy.sparse as sp
    A = sp.csc_matrix(AD)
    D = sp.csc_matrix(DP)
    n_var, n_cell = A.shape
    c_local = -(-n_cell // n_shards)
    n_cell_pad = c_local * n_shards

    blocks = []
    max_nnz = 0
    for s in range(n_shards):
        lo, hi = s * c_local, min((s + 1) * c_local, n_cell)
        Ab = sp.coo_matrix(A[:, lo:hi])
        Db = sp.coo_matrix(D[:, lo:hi])
        Du = sp.csr_matrix(
            (np.ones_like(Ab.data), (Ab.row, Ab.col)),
            shape=(n_var, hi - lo)) + sp.csr_matrix(
            (np.ones_like(Db.data), (Db.row, Db.col)),
            shape=(n_var, hi - lo))
        U = Du.tocoo()
        rows, cols = U.row.astype(np.int64), U.col.astype(np.int64)
        a = np.asarray(sp.csr_matrix(Ab)[rows, cols]).reshape(-1)
        d = np.asarray(sp.csr_matrix(Db)[rows, cols]).reshape(-1)
        blocks.append((rows, cols, a, d))
        max_nnz = max(max_nnz, len(rows))

    nnz_pad = -(-max(max_nnz, 1) // pad_multiple) * pad_multiple

    def pack(order_key):
        out = {k: [] for k in ("rows", "cols", "ad", "dp", "ptr")}
        n_seg = n_var if order_key == "row" else c_local
        for rows, cols, a, d in blocks:
            order = (np.lexsort((cols, rows)) if order_key == "row"
                     else np.lexsort((rows, cols)))
            r = np.zeros(nnz_pad, np.int32)
            c = np.zeros(nnz_pad, np.int32)
            av = np.zeros(nnz_pad, dtype)
            dv = np.zeros(nnz_pad, dtype)
            n = len(rows)
            r[:n] = rows[order]
            c[:n] = cols[order]
            av[:n] = a[order]
            dv[:n] = d[order]
            out["rows"].append(r)
            out["cols"].append(c)
            out["ad"].append(av)
            out["dp"].append(dv)
            sorted_ids = (rows if order_key == "row" else cols)[order]
            out["ptr"].append(np.searchsorted(
                sorted_ids, np.arange(n_seg + 1)).astype(np.int32))
        return {k: np.concatenate(v) for k, v in out.items()}

    by_row = pack("row")
    by_col = pack("col")
    arrays = dict(
        rows_r=by_row["rows"], cols_r=by_row["cols"],
        ad_r=by_row["ad"], dp_r=by_row["dp"],
        rows_c=by_col["rows"], cols_c=by_col["cols"],
        ad_c=by_col["ad"], dp_c=by_col["dp"],
        row_ptr=by_row["ptr"], col_ptr=by_col["ptr"],
    )
    meta = dict(n_var=n_var, n_cell=n_cell, n_cell_pad=n_cell_pad,
                c_local=c_local, n_shards=n_shards, nnz_pad=nnz_pad)
    return arrays, meta


def build_cell_sharded_dense(AD, DP, n_shards, dtype=np.int8):
    """Split cells into `n_shards` equal (padded) ranges and densify each
    into `dtype` (vireo_tpu/parallel/mesh.py:333-364; int8 clips at 127).

    Returns (ad, dp, meta): (n_var, n_cell_pad) host arrays."""
    import scipy.sparse as sp
    A = sp.csc_matrix(AD)
    D = sp.csc_matrix(DP)
    n_var, n_cell = A.shape
    c_local = -(-n_cell // n_shards)
    n_cell_pad = c_local * n_shards

    ad = np.zeros((n_var, n_cell_pad), dtype)
    dp = np.zeros((n_var, n_cell_pad), dtype)
    clip = 127 if np.dtype(dtype) == np.int8 else None
    for s in range(n_shards):
        lo, hi = s * c_local, min((s + 1) * c_local, n_cell)
        a = np.asarray(A[:, lo:hi].todense())
        d = np.asarray(D[:, lo:hi].todense())
        if clip:
            a = np.minimum(a, clip)
            d = np.minimum(d, clip)
        ad[:, lo:hi] = a
        dp[:, lo:hi] = d
    meta = dict(n_var=n_var, n_cell=n_cell, n_cell_pad=n_cell_pad,
                c_local=c_local, n_shards=n_shards)
    return ad, dp, meta


# ---------------------------------------------------------------------
# the fit entry points
# ---------------------------------------------------------------------

def _to_device(x, dtype, device):
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), device=device).to(dtype)


def _dtype_of(x):
    return x.dtype if torch.is_tensor(x) else torch.from_numpy(
        np.asarray(x)).dtype


def _placed(tree, dtype, device):
    """A state or priors dataclass with every field a tensor of `dtype`
    on `device`."""
    return dataclasses.replace(tree, **{
        f.name: _to_device(getattr(tree, f.name), dtype, device)
        for f in dataclasses.fields(tree)})


def fit_sharded(sc, state, priors, cfg, **fit_kwargs):
    """fit_vb over a ShardedCounts `sc` from a global state and priors
    (numpy or tensors): each rank fits its block, and the result's state
    is gathered, global on every rank."""
    from ..models.vireo import fit_vb
    lay = sc.layout
    dtype = _dtype_of(state.id_prob)
    st = _placed(shard_state(state, lay, cfg.ASE_mode), dtype, sc.device)
    pr = _placed(shard_priors(priors, lay), dtype, sc.device)
    res = fit_vb(sc, st, pr, cfg, **fit_kwargs)
    return dataclasses.replace(res, state=gather_state(res.state, lay,
                                                       cfg.ASE_mode))


def _dense_block(mesh, ad, dp, shape):
    """ShardedCounts of this rank's even block of dense (V, C) counts
    (numpy or tensors), placed on the mesh's device."""
    from ..ops.counts import DenseCounts
    lay = Layout.even(mesh, shape)

    def block(x):
        x = _own(lay.take(lay.take(x, VAR_AXIS, 0), CELL_AXIS, 1))
        return torch.as_tensor(x).to(mesh.device).contiguous()

    return ShardedCounts(DenseCounts(block(ad), block(dp)), lay)


def fit_vb_auto(mesh, counts, state, priors, cfg, **fit_kwargs):
    """fit_vb with dense counts split over the mesh (cells, and variants
    on a vars axis), the assignments over cells and the genotypes (and
    ASE thetas) over variants: the layout of
    vireo_tpu/parallel/mesh.py:132-168, its reductions written out.
    `counts`: the whole pool as a DenseCounts (or numpy pair); `state`
    and `priors` global. Returns the FitResult with the global state."""
    sc = _dense_block(mesh, counts.ad, counts.dp, (counts.n_var,
                                                   counts.n_cell))
    return fit_sharded(sc, state, priors, cfg, **fit_kwargs)


def warm_restarts_auto(mesh, counts, states_batched, priors, cfg,
                       shard_axis="cells", **fit_kwargs):
    """The batched warm fits on a mesh, in the two layouts of
    vireo_tpu/parallel/mesh.py:171-216:

    - "cells": the counts and assignments split over the mesh as in
      `fit_vb_auto`, the restarts side by side in each contraction, the
      statistics all-reduced every iteration;
    - "restarts": every rank holds the whole pool and fits its share of
      the restarts alone, with no collective until the results are
      all-gathered (the reference's pool over restarts, on ranks).

    Returns the FitResult of every restart, global, on every rank."""
    if shard_axis == "cells":
        return fit_vb_auto(mesh, counts, states_batched, priors, cfg,
                           **fit_kwargs)
    if shard_axis != "restarts":
        raise ValueError("shard_axis is 'cells' or 'restarts', not %r"
                         % (shard_axis,))
    from ..models.vireo import fit_vb, FitResult
    from ..ops.counts import DenseCounts
    dev = mesh.device
    local = DenseCounts(torch.as_tensor(counts.ad).to(dev),
                        torch.as_tensor(counts.dp).to(dev))
    R = states_batched.id_prob.shape[0]
    bounds = shard_bounds(R, mesh.size)
    lo, hi = bounds[mesh.rank]
    dtype = _dtype_of(states_batched.id_prob)
    st = _placed(dataclasses.replace(states_batched, **{
        f.name: getattr(states_batched, f.name)[lo:hi]
        for f in dataclasses.fields(states_batched)}), dtype, dev)
    res = fit_vb(local, st, _placed(priors, dtype, dev), cfg, **fit_kwargs)
    sizes = [b - a for a, b in bounds]

    def gather(x):
        return mesh.all_gather(torch.as_tensor(x).to(dev), None, dim=0,
                               sizes=sizes)

    state = dataclasses.replace(res.state, **{
        f.name: gather(getattr(res.state, f.name))
        for f in dataclasses.fields(res.state)})
    return FitResult(state=state,
                     elbo_ref=gather(res.elbo_ref).cpu().numpy(),
                     elbo_final=gather(res.elbo_final).cpu().numpy(),
                     n_iter=gather(res.n_iter).cpu().numpy(),
                     elbo_trace=gather(res.elbo_trace).cpu().numpy())


def sharded_fit_vb_dense(mesh, ad, dp, meta, state, priors, cfg,
                         **fit_kwargs):
    """The full fit over the host dense blocks of
    `build_cell_sharded_dense` (vireo_tpu/parallel/mesh.py:367-405): a
    rank places only its block. `state.id_prob` is (n_cell_pad, K);
    padded cells carry zero counts and add nothing to the data terms."""
    sc = _dense_block(mesh, ad, dp, (meta["n_var"], meta["n_cell_pad"]))
    return fit_sharded(sc, state, priors, cfg, **fit_kwargs)


def sharded_fit_vb(mesh, arrays, meta, state, priors, cfg, **fit_kwargs):
    """The full fit over the per-shard COO chunks of
    `build_cell_sharded_coo` (vireo_tpu/parallel/mesh.py:408-459): a
    rank places only its chunk's real triplets (on a vars axis, those of
    its variants) as a SparseCounts. `state.id_prob` is
    (n_cell_pad, K)."""
    from ..ops.counts import _sparse_from_triplets
    n_var, c_local = meta["n_var"], meta["c_local"]
    if meta["n_shards"] != mesh.extent(CELL_AXIS):
        raise ValueError("the chunks are for %d cell shards, the mesh has %d"
                         % (meta["n_shards"], mesh.extent(CELL_AXIS)))
    lay = Layout.even(mesh, (n_var, meta["n_cell_pad"]))
    s, nnz_pad = mesh.coord(CELL_AXIS), meta["nnz_pad"]
    n_real = int(arrays["row_ptr"][s * (n_var + 1) + n_var])
    part = slice(s * nnz_pad, s * nnz_pad + n_real)
    rows = arrays["rows_r"][part].astype(np.int64)
    v_lo, v_hi = lay.vars
    keep = (rows >= v_lo) & (rows < v_hi)
    local = _sparse_from_triplets(
        rows[keep] - v_lo, arrays["cols_r"][part][keep],
        arrays["ad_r"][part][keep], arrays["dp_r"][part][keep],
        (v_hi - v_lo, c_local), mesh.device)
    return fit_sharded(ShardedCounts(local, lay), state, priors, cfg,
                       **fit_kwargs)
