"""Run a function of the port on spawned ranks: the launcher of the
multi-rank dry run, of chip_smoke's mesh phases and of the tests (a
command line goes through `python -m torch.distributed.run` instead).

    from vireo_tpu_torch.parallel.launch import run_ranks, MeshArg
    out = run_ranks("vireo_tpu_torch.engine.wrap:vireo_wrap", 4,
                    args=(AD, DP), kwargs=dict(n_donor=4,
                                               mesh=MeshArg((2, 2))))
    out[rank]                # each rank's result, tensors as numpy

The ranks are torch.multiprocessing's spawned processes. Each joins the
world through a FileStore in `workdir` (no port is opened), with every
group's timeout set, runs the function and writes its result there. An
argument given as `MeshArg(shape)` receives the rank's mesh. When a
rank fails, torch.multiprocessing stops the others and raises its
traceback in the parent; ranks still running at `timeout` are killed.
"""

import dataclasses
import importlib
import os
import pickle
import tempfile
import time

import numpy as np
import torch
import torch.multiprocessing

__all__ = ["MeshArg", "run_ranks", "results_agree"]


@dataclasses.dataclass(frozen=True)
class MeshArg:
    """An argument that each rank replaces with its mesh: `shape` (n,)
    for `make_mesh`, (n_vars, n_cells) for `make_mesh2d`."""
    shape: tuple

    def build(self, device=None):
        from .mesh import make_mesh, make_mesh2d
        if len(self.shape) == 1:
            return make_mesh(self.shape[0], device=device)
        return make_mesh2d(*self.shape, device=device)


def _target(name):
    """The function "module:attr.attr" names."""
    module, attr = name.split(":")
    fn = importlib.import_module(module)
    for part in attr.split("."):
        fn = getattr(fn, part)
    return fn


def _to_host(x):
    """A result as picklable host values: tensors as numpy, dataclasses
    as dicts of their fields, a mesh as its shape and this rank's
    coordinates."""
    from .mesh import Mesh
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, Mesh):
        return {"shape": dict(x.shape), "coords": dict(x.coords)}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _to_host(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _result_path(workdir, rank):
    return os.path.join(workdir, "rank%d.pkl" % rank)


def _rank_main(rank, world, workdir, fn, args, kwargs, device):
    import torch.distributed as dist
    from .mesh import initialize_distributed
    if device == "cpu":
        torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "rendezvous"), world)
    initialize_distributed(num_processes=world, process_id=rank,
                           store=store, device=device)
    try:
        meshes = {}

        def arg(v):
            if isinstance(v, MeshArg):
                if v.shape not in meshes:
                    meshes[v.shape] = v.build(device)
                return meshes[v.shape]
            return v

        fn = _target(fn) if isinstance(fn, str) else fn
        out = _to_host(fn(*map(arg, args),
                          **{k: arg(v) for k, v in kwargs.items()}))
        path = _result_path(workdir, rank)
        with open(path + ".tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n_ranks, args=(), kwargs=None, workdir=None, device=None,
              timeout=600):
    """fn(*args, **kwargs) on `n_ranks` spawned ranks computing on
    `device` (default: utils/device.py's, the card unless the CPU is
    asked for; on a card the ranks share or split the node's cards).
    `fn` is "module:function" or a module-level function. Returns each
    rank's result. Raises torch.multiprocessing's ProcessRaisedException
    (with the rank's traceback) when a rank fails, and TimeoutError when
    the ranks outlast `timeout` seconds, after killing them. `workdir`
    (default: a temporary directory) holds the rendezvous file and each
    rank's result."""
    from ..utils.device import resolve_device
    device = resolve_device(device).type
    if workdir is None:
        with tempfile.TemporaryDirectory() as tmp:
            return run_ranks(fn, n_ranks, args, kwargs, tmp, device, timeout)
    os.makedirs(workdir, exist_ok=True)
    for path in [os.path.join(workdir, "rendezvous")] + [
            _result_path(workdir, r) for r in range(n_ranks)]:
        if os.path.exists(path):
            os.remove(path)
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(n_ranks, workdir, fn, tuple(args),
                          dict(kwargs or {}), device),
        nprocs=n_ranks, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic()),
                       grace_period=5):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(10)
            raise TimeoutError("%d ranks outlasted the %s s deadline and "
                               "were killed" % (n_ranks, timeout))
    results = []
    for rank in range(n_ranks):
        with open(_result_path(workdir, rank), "rb") as f:
            results.append(pickle.load(f))
    return results


def results_agree(results):
    """Whether every rank returned the same values (numpy arrays equal
    bit for bit), as the mesh promises for its replicated outputs."""
    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(same, a, b))
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            a, b = np.asarray(a), np.asarray(b)
            return np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
        return a == b or (a != a and b != b)
    return all(same(results[0], r) for r in results[1:])
