"""A list of calls run in order on each spawned rank, for the mesh tests:
one spawn runs every case of a fixture.

    out = run_calls([("module:function", (args...), {kwargs}),
                     (Ref(0, "densify"), {})], n_ranks=2, workdir=...)
    out[rank][call]          # each call's result, tensors as numpy

A call is (target, kwargs) or (target, args, kwargs), its target
"module:function" or a Ref. An argument `MeshArg(shape)` receives the
rank's mesh (one per shape, built once); `Ref(i)` is call i's result as
the rank holds it (`Ref(i, "name")` its attribute), and a call whose
target is a Ref calls it (a method of an earlier result).
"""

import dataclasses

from vireo_tpu_torch.parallel.launch import MeshArg, run_ranks, _target

__all__ = ["Ref", "run_calls"]


@dataclasses.dataclass(frozen=True)
class Ref:
    """An argument (or a call's target) that each rank replaces with its
    own result of call `index`, or that result's attribute `attr`."""
    index: int
    attr: str = None

    def resolve(self, results):
        x = results[self.index]
        return x if self.attr is None else getattr(x, self.attr)


def rank_calls(calls, device):
    """The calls on this rank, its meshes on `device`, in order; returns
    their results."""
    meshes, live = {}, []

    def arg(v):
        if isinstance(v, MeshArg):
            if v.shape not in meshes:
                meshes[v.shape] = v.build(device)
            return meshes[v.shape]
        if isinstance(v, Ref):
            return v.resolve(live)
        return v

    for call in calls:
        target, args, kwargs = call if len(call) == 3 else (
            call[0], (), call[1])
        fn = arg(target) if isinstance(target, Ref) else _target(target)
        live.append(fn(*map(arg, args),
                       **{k: arg(v) for k, v in kwargs.items()}))
    return live


def run_calls(calls, n_ranks, workdir, timeout=300):
    """`calls` on `n_ranks` spawned CPU ranks; each rank's results."""
    return run_ranks(rank_calls, n_ranks, args=(calls, "cpu"),
                     workdir=workdir, device="cpu", timeout=timeout)
