"""The multi-rank dry run (counterpart of
__graft_entry__.py::dryrun_multichip): spawn ranks, build a mesh, and
check every sharded rung of the port against the single-rank fit on a
tiny pool.

    python -m vireo_tpu_torch.parallel.dryrun 4 --mesh 2x2 [--device cuda]

On every rank, for each rung, from the same seeded init and for
DRYRUN_ITERS fixed iterations (past convergence on these shapes, so that
an early stop at another iteration cannot hide a wrong reduction):

1. the COO shard path (`build_cell_sharded_coo` + `sharded_fit_vb`);
2. the int8 dense rung that `counts_from_scipy(mesh=)` places;
3. the packed-hybrid rung (a nibble base and a real overflow residual);
4. the whole `vireo_wrap` on the mesh against `vireo_wrap` on one rank.

Rungs 1-3 must give the single-rank fit's ELBO to DRYRUN_ELBO_RTOL and
its calls for every cell; rung 4 the single-rank run's calls after
label matching. Every rank must return the same summary. The rank
program lives here, so a spawned rank imports only the port.
"""

import argparse
import sys

import numpy as np

__all__ = ["dryrun_multichip", "DRYRUN_ELBO_RTOL", "DRYRUN_ITERS"]

DRYRUN_ELBO_RTOL = 1e-4
DRYRUN_ITERS = 60


def _pool(n_cell_shards):
    """The dry run's pool: dense and deep enough that the fit is not
    chaotic (near-tied assignments would turn float round-off into
    another basin), with a count tail above the nibble cap so that the
    hybrid rung carries a residual."""
    from ..sim.synth import synth_pool_counts
    data = synth_pool_counts(n_var=96, n_cell=16 * n_cell_shards,
                             n_donor=3, density=0.5, mean_extra_depth=4.0,
                             seed=1)
    AD, DP = data["AD"].tolil(), data["DP"].tolil()
    DP[:5, :4] = 90.0
    AD[:5, :4] = 60.0
    return AD.tocsc(), DP.tocsc()


def _rank_dryrun(mesh):
    """Every rung on this rank's mesh against the single-rank fit; returns
    {rung: summary}, the same on every rank, or raises."""
    import torch
    from .mesh import (CELL_AXIS, ShardedCounts, build_cell_sharded_coo,
                       sharded_fit_vb, fit_sharded)
    from ..models.vireo import (VireoConfig, init_state, default_priors,
                                fit_vb)
    from ..ops.counts import (counts_from_scipy, dense_counts, DenseCounts,
                              HybridCounts)
    from ..ops.packed import PackedCounts
    from ..ops.matching import optimal_match
    from ..engine.wrap import vireo_wrap
    from ..utils.device import default_dtype

    dev = mesh.device
    dtype = default_dtype(dev)
    AD, DP = _pool(mesh.extent(CELL_AXIS))
    V, C = AD.shape
    fit_kw = dict(max_iter=DRYRUN_ITERS, min_iter=DRYRUN_ITERS)
    cfg = VireoConfig(n_var=V, n_cell=C, n_donor=3)
    state = init_state(cfg, rng=np.random.RandomState(0), dtype=dtype,
                       device="cpu")
    priors = default_priors(cfg, dtype=dtype, device="cpu")
    ref = fit_vb(dense_counts(AD, DP, dtype=dtype, device=dev),
                 _to(state, dev), _to(priors, dev), cfg, **fit_kw)
    ref_elbo = float(ref.elbo_final)
    ref_calls = ref.state.id_prob.argmax(1).cpu().numpy()
    out = {}

    def check(name, elbo, calls, extra=None):
        rel = abs(elbo - ref_elbo) / max(1.0, abs(ref_elbo))
        agree = int((calls[:C] == ref_calls).sum())
        out[name] = dict(elbo=elbo, ref_elbo=ref_elbo, rel=rel,
                         agree=agree, n_cell=C, **(extra or {}))
        if not np.isfinite(elbo) or rel > DRYRUN_ELBO_RTOL or agree != C:
            raise AssertionError("dryrun rung %s: ELBO %.6f vs single-rank "
                                 "%.6f (rel %.2e), %d/%d calls agree"
                                 % (name, elbo, ref_elbo, rel, agree, C))

    def fit_on(counts):
        res = fit_sharded(counts, state, priors, cfg, **fit_kw)
        return float(res.elbo_final), res.state.id_prob.argmax(1).cpu().numpy()

    # 1. the COO shard path
    arrays, meta = build_cell_sharded_coo(AD, DP,
                                          n_shards=mesh.extent(CELL_AXIS),
                                          pad_multiple=64)
    res = sharded_fit_vb(mesh, arrays, meta, state, priors, cfg, **fit_kw)
    check("coo_shard_path", float(res.elbo_final),
          res.state.id_prob.argmax(1).cpu().numpy())

    # 2. the dense int8 rung the ladder places on the mesh
    dense = counts_from_scipy(AD, DP, mesh=mesh)
    if not (isinstance(dense, ShardedCounts)
            and isinstance(dense.local, DenseCounts)
            and dense.local.ad.dtype == torch.int8):
        raise AssertionError("expected the int8 dense rung, got %r"
                             % (dense,))
    check("dense_int8", *fit_on(dense))

    # 3. the packed-hybrid rung, forced below the exact dense rung
    hyb = counts_from_scipy(AD, DP, dense_budget=1.5 * V * C, mesh=mesh)
    if not (isinstance(hyb.local, HybridCounts)
            and isinstance(hyb.local.base, PackedCounts)):
        raise AssertionError("expected a packed hybrid, got %r" % (hyb,))
    resid = int(mesh.all_reduce(torch.tensor([hyb.local.resid.nnz])))
    if resid == 0:
        raise AssertionError("the hybrid residual is empty")
    check("packed_hybrid", *fit_on(hyb), extra=dict(resid_nnz=resid))

    # 4. the whole vireo_wrap on the mesh
    kw = dict(n_donor=3, learn_GT=True, n_init=2, random_seed=7,
              check_doublet=True, verbose=False, device=dev)
    res_m = vireo_wrap(AD, DP, mesh=mesh, **kw)
    res_1 = vireo_wrap(AD, DP, mesh=None, **kw)
    perm = optimal_match(res_1["GT_prob"], res_m["GT_prob"])[1]
    agree = float(np.mean(np.argmax(res_m["ID_prob"][:, perm], 1)
                          == np.argmax(res_1["ID_prob"], 1)))
    out["vireo_wrap"] = dict(agree=agree, lb=float(res_m["LB_doublet"]),
                             lb_single=float(res_1["LB_doublet"]))
    if agree != 1.0:
        raise AssertionError("vireo_wrap on the mesh: %.3f of the calls "
                             "agree with one rank" % agree)
    return out


def _to(tree, device):
    import dataclasses
    return dataclasses.replace(tree, **{
        f.name: getattr(tree, f.name).to(device)
        for f in dataclasses.fields(tree)})


def dryrun_multichip(n_ranks, mesh_shape=None, device=None, timeout=900,
                     workdir=None):
    """Spawn `n_ranks` ranks computing on `device` (default:
    utils/device.py's, the card unless the CPU is asked for; on one card
    the ranks share it over gloo), on a `mesh_shape` mesh
    ((n,) or (n_vars, n_cells); default the cells over every rank), and
    run every rung (module docstring). Prints one line a rung and
    returns rank 0's summary; raises when a rung or a rank fails."""
    from .launch import run_ranks, MeshArg, results_agree
    from ..utils.device import resolve_device
    device = resolve_device(device).type
    shape = tuple(mesh_shape) if mesh_shape else (int(n_ranks),)
    out = run_ranks("vireo_tpu_torch.parallel.dryrun:_rank_dryrun", n_ranks,
                    kwargs=dict(mesh=MeshArg(shape)), workdir=workdir,
                    device=device, timeout=timeout)
    if not results_agree(out):
        raise AssertionError("the ranks' dry-run summaries differ")
    summary = out[0]
    mesh_name = "x".join(map(str, shape))
    for rung, s in summary.items():
        if rung == "vireo_wrap":
            print("dryrun rung OK: vireo_wrap on mesh %s, %.0f%% donor-call "
                  "agreement (LB %.4f vs %.4f)" % (mesh_name,
                                                   100 * s["agree"], s["lb"],
                                                   s["lb_single"]))
        else:
            print("dryrun rung OK: %s on mesh %s: ELBO %.6f (single rank "
                  "%.6f, rel %.1e), %d/%d calls agree"
                  % (rung, mesh_name, s["elbo"], s["ref_elbo"], s["rel"],
                     s["agree"], s["n_cell"]))
    print("dryrun_multichip OK: all %d rungs pass on %d ranks (%s, mesh %s)"
          % (len(summary), n_ranks, device, mesh_name))
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_ranks", type=int)
    p.add_argument("--mesh", default=None, help="VxC (default: 1-D cells)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="default: the card, or the CPU under "
                   "VIREO_PLATFORM=cpu")
    a = p.parse_args(argv)
    shape = tuple(int(x) for x in a.mesh.lower().split("x")) if a.mesh \
        else None
    dryrun_multichip(a.n_ranks, shape, device=a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
