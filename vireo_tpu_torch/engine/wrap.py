"""Multi-initialization orchestrator for the Vireo model (counterpart
of vireo_tpu/engine/wrap.py).

The n_init random restarts run as one batched fit: the restart axis is
folded into the matmul's column dimension (R*K columns), each restart
stops at its own convergence, and the best ELBO is refit to
convergence, followed by the doublet E-step. Seeded runs draw their
inits from numpy's global stream in the reference's order: on a card
made by one kernel launch (ops/mt19937.py), on any other device drawn
on the host; unseeded runs draw them on the device from a
torch.Generator.

On a mesh (parallel/mesh.py; one process per rank under
torch.distributed) every rank calls `vireo_wrap` with the same
arguments. The counts are placed a block per rank, the cells padded to
a multiple of the cell shards with zero-count cells; every rank draws
the whole init stream at the true cell count and keeps its block, so
numpy's stream stays the single-process one; each fit all-reduces its
statistics; and every rank returns the single-process result dict, its
cell-axis arrays gathered and the padding dropped.
"""

import functools
import os
import warnings

import numpy as np
import torch

from ..ops.counts import (counts_from_scipy, exact_count_dtype,
                          device_dense_budget, DenseCounts, HybridCounts)
from ..models.vireo import (Vireo, VireoConfig, VireoState, default_priors,
                            fit_vb)
from ..models.doublet import predict_doublet
from ..models.ambient import predict_ambient
from ..ops.matching import optimal_match, donor_select
from ..parallel.mesh import (Mesh, Layout, ShardedCounts, VAR_AXIS,
                             make_mesh, make_mesh2d, n_cell_shards,
                             shard_state, gather_state, world_size, world_min)
from ..utils import checkpoint as ckpt
from ..utils.timing import PhaseTimer, profile_trace, span, timing_env
from ..utils.device import (resolve_device, default_dtype,
                            pin_matmul_precision, numpy_dtype, sync)

__all__ = ["vireo_wrap"]


def parse_mesh_spec(spec):
    """A mesh argument as text: "auto", "off" (or "none", "no", "0") ->
    None, "VxC" -> (V, C)."""
    spec = str(spec).strip().lower()
    if spec == "auto":
        return "auto"
    if spec in ("off", "none", "no", "0"):
        return None
    try:
        nv, nc = (int(x) for x in spec.split("x"))
    except ValueError:
        raise ValueError("a mesh is 'auto', 'off' or 'VxC' (e.g. 2x4), not "
                         "%r" % spec) from None
    return nv, nc


def _resolve_mesh(mesh, n_cell, count_bytes=None, var_state_bytes=None,
                  verbose=False):
    """The run's mesh (vireo_tpu/engine/wrap.py:39-87): None or a Mesh
    pass through, "VxC" (or (V, C)) builds that vars x cells mesh, and
    "auto" splits the cells over every rank of the world when the pool
    is big enough to pay for the collectives (VIREO_MESH=off disables,
    VIREO_MESH_MIN_CELLS sets the threshold, VIREO_MESH_SHAPE="VxC"
    forces a 2-D mesh). With no process group, or a world of one rank,
    "auto" gives no mesh.

    Given the size hints, "auto" elects the 2-D mesh itself: a cells
    mesh keeps every variant-axis array whole on each rank (the warm
    genotype batch above all), so when a rank's count block plus that
    state exceeds the device budget but splitting the variants `a` ways
    fits, the smallest power of two `a` that fits wins. The budget is
    the smallest rank's, so that every rank elects alike."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    spec = mesh if isinstance(mesh, tuple) else parse_mesh_spec(mesh)
    if spec is None:
        return None
    if spec != "auto":
        return make_mesh2d(*spec)
    if os.environ.get("VIREO_MESH", "auto").lower() in ("0", "off", "no"):
        return None
    min_cells = int(os.environ.get("VIREO_MESH_MIN_CELLS", 8192))
    n_dev = world_size()
    if n_cell < min_cells or n_dev <= 1:
        return None
    shape = os.environ.get("VIREO_MESH_SHAPE", "")
    if shape:
        return make_mesh2d(*parse_mesh_spec(shape))
    if var_state_bytes:
        budget = world_min(device_dense_budget())
        per_chip = (count_bytes or 0) / n_dev
        if per_chip + var_state_bytes > budget:
            a = 2
            while a <= n_dev // 2:
                if n_dev % a == 0 and \
                        per_chip + var_state_bytes / a <= budget:
                    mesh = make_mesh2d(a, n_dev // a)
                    if verbose and mesh.is_root:
                        print("[vireo] replicated variant-axis state "
                              "(%.2f GiB) busts the per-chip budget on a "
                              "1-D cells mesh; using a %dx%d vars-x-cells "
                              "capacity mesh" % (var_state_bytes / 2**30, a,
                                                 n_dev // a))
                    return mesh
                a *= 2
    return make_mesh()


def _auto_mesh_hints(AD, DP, n_donor, GT_prior, n_extra_donor, n_init,
                     n_GT, dtype):
    """(count_bytes, var_state_bytes) for the 2-D election of
    `_resolve_mesh` (vireo_tpu/engine/wrap.py:90-127); (None, None) for
    a counts object, which is placed already.

    count_bytes: both dense matrices in the ladder's exact type.
    var_state_bytes: the variant-axis arrays a cells mesh keeps whole on
    each rank, the warm genotype batch (n_init, n_var, K, G) and the
    fit's and the doublet phase's copies, K widened to a wider genotype
    prior's donors as the wrap widens the fit."""
    if hasattr(AD, "suff_stats"):
        return None, None
    n_var, n_cell = (int(s) for s in AD.shape)
    vmax = 0.0
    for X in (AD, DP):
        data = X.data if hasattr(X, "data") else np.asarray(X)
        if getattr(data, "size", 0):
            vmax = max(vmax, float(data.max()))
    itemsize = torch.empty((), dtype=exact_count_dtype(vmax)).element_size()
    count_bytes = 2.0 * n_var * n_cell * itemsize
    K = int(n_donor) if n_donor is not None else (
        int(GT_prior.shape[1]) if GT_prior is not None else 8)
    K += int(n_extra_donor or 0)
    if GT_prior is not None:
        K = max(K, int(GT_prior.shape[1]))
    size = torch.empty((), dtype=dtype).element_size()
    return count_bytes, (int(n_init) + 2) * n_var * K * n_GT * size


def _pad_cells(X, n_pad):
    """`n_pad` zero-count cells (columns) appended to a scipy/numpy count
    matrix."""
    import scipy.sparse as sp
    if sp.issparse(X):
        pad = sp.csc_matrix((X.shape[0], n_pad), dtype=X.dtype)
        return sp.hstack([X.tocsc(), pad]).tocsc()
    return np.pad(np.asarray(X), ((0, 0), (0, n_pad)))


def _mesh_native(counts):
    """Counts placed on a mesh already (ShardedCounts, MeshPackedCounts)."""
    return isinstance(counts, ShardedCounts)


def _as_counts(AD, DP, device, mesh=None, verbose=False):
    """(counts, the mesh they are placed on or None). Host matrices go
    through the ladder, on the mesh where there is one. A counts object
    on a mesh keeps its own. A DenseCounts, or a HybridCounts over one,
    built on one device is cut into the mesh's blocks when its cells
    divide into the cell shards; any other is refused by a warning and
    the run goes on unsharded (vireo_tpu/engine/wrap.py:148-194)."""
    if not hasattr(AD, "suff_stats"):
        return counts_from_scipy(AD, DP, device=device, verbose=verbose,
                                 mesh=mesh), mesh
    counts = AD
    if _mesh_native(counts):
        if mesh is not None and counts.mesh.shape != mesh.shape:
            raise ValueError("the counts lie on mesh %s, the run asks for "
                             "%s" % (counts.mesh.shape, mesh.shape))
        return counts, counts.mesh
    if mesh is None:
        return counts, None
    dense_base = isinstance(counts, DenseCounts) or (
        isinstance(counts, HybridCounts)
        and isinstance(counts.base, DenseCounts))
    if dense_base and counts.n_cell % n_cell_shards(mesh) == 0:
        lay = Layout.even(mesh, (counts.n_var, counts.n_cell))
        local = counts.cell_slice(*lay.cells)
        if mesh.has(VAR_AXIS):
            local = local.var_subset(np.arange(*lay.vars))
        if isinstance(local, DenseCounts):
            local = DenseCounts(local.ad.contiguous(), local.dp.contiguous())
        return ShardedCounts(local, lay), mesh
    warnings.warn(
        "[vireo] pre-built %s counts (n_cell=%d) could not be placed on "
        "the mesh (cell axis not divisible by its %d shards, or layout "
        "has no mesh path); the run proceeds UNSHARDED on every rank. Pad "
        "the cell axis to a multiple of the shard count, or pass raw "
        "scipy/numpy matrices so vireo_wrap pads for you."
        % (type(counts).__name__, counts.n_cell, n_cell_shards(mesh)))
    return counts, None


def _batched_beta(cfg, n_init, dtype, device):
    """The (n_init, L, G) beta_mu / beta_sum inits every restart shares
    (the reference defaults)."""
    L, G = cfg.theta_len, cfg.n_GT
    beta_mu = np.ones((L, G)) * np.linspace(0.01, 0.99, G)[None, :]
    beta_mu = torch.as_tensor(beta_mu, device=device).to(dtype)
    beta_mu = beta_mu.expand(n_init, L, G).contiguous()
    beta_sum = torch.full((n_init, L, G), 50.0, dtype=dtype, device=device)
    return beta_mu, beta_sum


def _host_batched_init(cfg, n_init, GT_prior_use, rng, dtype, device,
                       n_cell_draw=None):
    """The reference's per-restart np.random draws, in the order and
    with the per-restart normalisation of
    vireo_tpu/engine/wrap.py::_host_batched_init, assembled into one
    batched array per field and placed once. With a genotype prior only
    the (C, K) assignments are drawn; every restart's genotypes are the
    prior normalised in float64. `n_cell_draw` < cfg.n_cell draws the
    first `n_cell_draw` cells and gives the rest the uniform prior."""
    K, C, G = cfg.n_donor, cfg.n_cell, cfg.n_GT
    c_draw = C if n_cell_draw is None else int(n_cell_draw)
    np_dtype = numpy_dtype(dtype)
    with span("inits.host"):
        id_b = np.empty((n_init, C, K), np_dtype)
        gt_b = np.empty((n_init, cfg.n_var, K, G), np_dtype)
        id_b[:, c_draw:, :] = 1.0 / K
        if GT_prior_use is not None:
            gp = np.asarray(GT_prior_use, np.float64)
            gp = gp / gp.sum(-1, keepdims=True)
        for i in range(n_init):
            idp = rng.rand(c_draw, K)
            id_b[i, :c_draw] = idp / idp.sum(1, keepdims=True)
            if GT_prior_use is None:
                gtp = rng.rand(cfg.n_var, K, G)
                gt_b[i] = gtp / gtp.sum(-1, keepdims=True)
            else:
                gt_b[i] = gp
        beta_mu, beta_sum = _batched_beta(cfg, n_init, dtype, device)
        return VireoState(beta_mu=beta_mu, beta_sum=beta_sum,
                          gt_prob=torch.from_numpy(gt_b).to(device),
                          id_prob=torch.from_numpy(id_b).to(device))


def _mt_batched_init(cfg, n_init, GT_prior_use, rng, dtype, device,
                     n_cell_draw=None):
    """`_host_batched_init`'s draws regenerated on `device` from the
    generator's keys (ops/mt19937.py) instead of uploaded: on a card by
    one kernel launch, on the CPU by the kernel's plain version. The host
    generator advances exactly as if it had drawn them, and each restart
    is normalised in float64 in numpy's summation order before the cast
    to `dtype`, so the state equals
    `_host_batched_init`'s bit for bit, in float32 as in float64 (the JAX
    package's rounds its stream to float32 without x64; the card has
    float64)."""
    from ..ops.mt19937 import take_state, kernel_stream, np_pairwise_sum_last
    K, C, V, G = cfg.n_donor, cfg.n_cell, cfg.n_var, cfg.n_GT
    c_draw = C if n_cell_draw is None else int(n_cell_draw)
    gt_draw = 0 if GT_prior_use is not None else V * K * G
    per = c_draw * K + gt_draw
    with span("inits.plan"):
        plan = take_state(n_init * per, rng, device)
    with span("inits.stream"):
        flat = kernel_stream(plan, rng).reshape(n_init, per)

    with span("inits.normalise"):
        idp = flat[:, :c_draw * K].reshape(n_init, c_draw, K)
        idn = torch.full((n_init, C, K), 1.0 / K, dtype=dtype, device=device)
        idn[:, :c_draw] = idp / np_pairwise_sum_last(idp)[..., None]
        del idp
        if gt_draw:
            gtp = flat[:, c_draw * K:].reshape(n_init, V, K, G)
            gtn = (gtp / np_pairwise_sum_last(gtp)[..., None]).to(dtype)
            del gtp
        else:
            gp = np.asarray(GT_prior_use, np.float64)
            gp = torch.from_numpy(gp / gp.sum(-1, keepdims=True))
            gtn = gp.to(device=device, dtype=dtype).expand(n_init, V, K, G)
    beta_mu, beta_sum = _batched_beta(cfg, n_init, dtype, device)
    return VireoState(beta_mu=beta_mu, beta_sum=beta_sum, gt_prob=gtn,
                      id_prob=idn)


def _seeded_batched_init(cfg, n_init, GT_prior_use, rng, dtype, device,
                         n_cell_draw=None):
    """The seeded runs' inits, numpy's stream in the reference's order:
    on a card made by one kernel launch (`_mt_batched_init`), on any
    other device drawn on the host (`_host_batched_init`); both give the
    same state. A failure of the card's path raises: it never falls back
    to the host."""
    on_card = resolve_device(device).type == "cuda"
    init = _mt_batched_init if on_card else _host_batched_init
    with span("inits"):
        return init(cfg, n_init, GT_prior_use, rng, dtype, device,
                    n_cell_draw=n_cell_draw)


def _device_batched_init(cfg, n_init, GT_prior_use, generator, dtype,
                         device):
    """Unseeded inits drawn on the device: uniform draws normalised per
    restart, or with a genotype prior, the prior in every restart. They
    carry no parity contract with any other stream."""
    shape_id = (n_init, cfg.n_cell, cfg.n_donor)
    shape_gt = (n_init, cfg.n_var, cfg.n_donor, cfg.n_GT)
    with span("inits"):
        idp = torch.rand(shape_id, generator=generator, dtype=dtype,
                         device=device)
        if GT_prior_use is None:
            gtp = torch.rand(shape_gt, generator=generator, dtype=dtype,
                             device=device)
        else:
            gtp = torch.as_tensor(np.asarray(GT_prior_use),
                                  device=device).to(dtype).expand(shape_gt)
        beta_mu, beta_sum = _batched_beta(cfg, n_init, dtype, device)
        return VireoState(beta_mu=beta_mu, beta_sum=beta_sum,
                          gt_prob=gtp / gtp.sum(-1, keepdim=True),
                          id_prob=idp / idp.sum(-1, keepdim=True))


def _model_from_state(counts, cfg_kwargs, n_donor, learn_GT, state,
                      GT_prior_use, dtype, device, device_state=False,
                      layout=None):
    """A Vireo wrapper seeded with an existing state (no RNG draws).

    Seeded runs go through the host, renormalising in float64 as the
    JAX package does (vireo_tpu/engine/wrap.py:425-432), from the global
    state on a mesh; `device_state=True` adopts the state's tensors (a
    rank's block on a mesh) as they are."""
    common = dict(n_cell=counts.n_cell, n_var=counts.n_var, n_donor=n_donor,
                  learn_GT=learn_GT, dtype=dtype, device=device,
                  layout=layout)
    if device_state:
        m = Vireo(state_init=state, **common, **cfg_kwargs)
    else:
        if layout is not None:
            state = gather_state(state, layout,
                                 cfg_kwargs.get("ASE_mode", False))
        m = Vireo(beta_mu_init=state.beta_mu.cpu().numpy(),
                  beta_sum_init=state.beta_sum.cpu().numpy(),
                  ID_prob_init=state.id_prob.cpu().numpy(),
                  GT_prob_init=state.gt_prob.cpu().numpy(), **common,
                  **cfg_kwargs)
    m.set_prior(GT_prior=GT_prior_use)
    return m


def _donor_sizes(model):
    """The summed assignments of each donor (over the padded pool on a
    mesh, as the JAX package sums its padded global array)."""
    if model.layout is None:
        return model.state.id_prob.sum(dim=0).cpu().numpy()
    return model.ID_prob.sum(axis=0)


def _profiled(fn):
    """VIREO_PROFILE=<dir> writes a torch.profiler Chrome trace of the
    whole run there (vireo_tpu/engine/wrap.py:435-446); no-op
    otherwise."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with profile_trace(os.environ.get("VIREO_PROFILE")):
            return fn(*args, **kwargs)
    return wrapper


@_profiled
def vireo_wrap(AD, DP=None, GT_prior=None, n_donor=None, learn_GT=True,
               n_init=20, random_seed=None, check_doublet=True,
               max_iter_init=20, delay_fit_theta=3, n_extra_donor=0,
               extra_donor_mode="distance", check_ambient=False,
               ambient_min_gain=None, nproc=None, dtype=None, verbose=True,
               mesh="auto", checkpoint_dir=None, timing=None, device=None,
               generator=None, **kwargs):
    """Run vireo with multiple initializations; returns the reference's
    result dict (vireo_wrap.py:170-183).

    AD, DP: scipy/numpy (n_var, n_cell) counts, placed by
    `ops.counts.counts_from_scipy` on the rung its budget picks, or any
    prebuilt counts object as AD (DenseCounts, PackedCounts, HybridCounts,
    SparseCounts, or a ShardedCounts placed on a mesh), whose device then
    is the run's default. `device`/`dtype` default to the policy of
    utils/device.py. `nproc` is accepted for CLI parity and ignored.
    `kwargs` may carry model flags (ASE_mode, fix_beta_sum, learn_theta,
    n_GT). `generator`: the torch.Generator for unseeded inits (default:
    one on `device`, seeded from numpy's global stream, rank 0's on a
    mesh). `timing`: True prints the phase summary of the JAX package
    (`utils.timing.PhaseTimer`), None reads VIREO_TIMING as it does, and
    a dict is filled with each phase's seconds. Each phase ends in a
    device sync, so its time holds its own device work; JAX leaves its
    phases unsynchronised (vireo_tpu/engine/wrap.py:476-480), so there a
    phase's device work may surface in a later phase. VIREO_PROFILE=<dir>
    writes a torch.profiler trace of the run there.

    `GT_prior` (n_var, n_prior, 3) gives donor genotypes: all donors
    when n_prior equals n_donor, a superset to pick n_donor of, or a
    subset the fit completes; `n_extra_donor` over-clusters by that
    many donors and keeps n_donor (`extra_donor_mode` "distance" or
    "size"). `checkpoint_dir`: the best warm restart (step 0) and the
    refit state (step 1) are saved there with numpy's RNG position, in
    the JAX package's format; a rerun with the same arguments resumes
    after the latest saved phase and gives the uninterrupted result.
    `check_ambient`: after the doublet phase, the ambient-RNA fractions
    (`models.ambient.predict_ambient`, its SNP gate at
    `ambient_min_gain`, default sqrt(n_cell) / 3) fill `ambient_Psi`,
    `Psi_var` and `Psi_LLRatio`.

    `mesh` (parallel/mesh.py): "auto" (the default; no mesh without a
    process group of two or more ranks, see `_resolve_mesh`), "off" or
    None, "VxC", or a Mesh. On a mesh every rank calls vireo_wrap with
    the same arguments and gets the same result; rank 0 alone prints and
    writes the checkpoints.
    """
    pin_matmul_precision()
    n_cell_in = AD.n_cell if hasattr(AD, "suff_stats") \
        else int(AD.shape[1])
    if _mesh_native(AD) and mesh == "auto":
        mesh = AD.mesh
    # the size hints (a scan of the data's largest count) matter only
    # where an automatic mesh could be elected
    count_bytes = var_state_bytes = None
    if mesh == "auto" and world_size() > 1:
        hint_dtype = dtype or default_dtype(resolve_device(device))
        count_bytes, var_state_bytes = _auto_mesh_hints(
            AD, DP, n_donor, GT_prior, n_extra_donor, n_init,
            int(kwargs.get("n_GT", 3)), hint_dtype)
    mesh = _resolve_mesh(mesh, n_cell_in, count_bytes=count_bytes,
                         var_state_bytes=var_state_bytes, verbose=verbose)
    if mesh is not None and device is None:
        device = mesh.device
    device = resolve_device(getattr(AD, "device", None)
                            if device is None and hasattr(AD, "suff_stats")
                            else device)
    dtype = dtype or default_dtype(device)
    if timing is None:
        timing = timing_env()
    timer = PhaseTimer(sync=lambda: sync(device))
    phase = timer.phase
    root = mesh is None or mesh.is_root

    resume = ckpt.latest_step(checkpoint_dir) if checkpoint_dir else None
    if resume is not None and verbose and root:
        print("[vireo] resuming from checkpoint step %d in %s"
              % (resume, checkpoint_dir))

    # the mesh's equal cell ranges: pad the pool with zero-count cells,
    # whose posterior is the prior; the inits are drawn at the true cell
    # count and the padding leaves every returned array
    n_pad_cells = 0
    if mesh is not None and not hasattr(AD, "suff_stats"):
        rem = n_cell_in % n_cell_shards(mesh)
        if rem:
            n_pad_cells = n_cell_shards(mesh) - rem
            AD = _pad_cells(AD, n_pad_cells)
            DP = _pad_cells(DP, n_pad_cells)
    with phase("data_placement"):
        counts, mesh = _as_counts(AD, DP, device, mesh=mesh, verbose=verbose)
    layout = getattr(counts, "layout", None)
    root = mesh is None or mesh.is_root
    if mesh is not None and verbose and root:
        print("[vireo] counts sharded over %d devices (mesh %s, %s)"
              % (mesh.size, mesh.shape, mesh.backend))

    if learn_GT is False and n_extra_donor > 0:
        if root:
            print("Searching from extra donors only works with learn_GT")
        n_extra_donor = 0

    if n_donor is None:
        if GT_prior is None:
            raise ValueError("[vireo] Error: requiring n_donor or GT_prior.")
        n_donor = GT_prior.shape[1]

    if learn_GT is False and n_init > 1:
        if root:
            print("GT is fixed, so use a single initialization")
        n_init = 1

    if random_seed is not None:
        np.random.seed(random_seed)
    rng = np.random  # the reference draws from the global stream
    device_init = random_seed is None

    # the run's fingerprint, key for key the JAX package's, so that each
    # package refuses the other's checkpoints of another run and resumes
    # from those of the same run
    run_fp = {
        "n_var": int(counts.n_var), "n_cell": int(counts.n_cell),
        "nnz": int(getattr(counts, "nnz", -1)),
        "n_donor": int(n_donor), "n_init": int(n_init),
        "random_seed": -1 if random_seed is None else int(random_seed),
        "learn_GT": int(bool(learn_GT)),
        "n_extra_donor": int(n_extra_donor),
        "has_GT_prior": int(GT_prior is not None),
        "device_init": int(device_init),
    }
    if resume is not None:
        ckpt.check_fingerprint(checkpoint_dir, run_fp)

    n_donor = int(n_donor)
    GT_prior_use = None
    n_donor_use = int(n_donor + n_extra_donor)
    if GT_prior is not None and n_donor_use == GT_prior.shape[1]:
        GT_prior_use = GT_prior.copy()
    elif GT_prior is not None and n_donor_use < GT_prior.shape[1]:
        GT_prior_use = GT_prior.copy()
        n_donor_use = GT_prior.shape[1]

    cfg_kwargs = {k: v for k, v in kwargs.items()
                  if k in ("n_GT", "learn_theta", "ASE_mode",
                           "fix_beta_sum")}
    cfg = VireoConfig(n_var=counts.n_var, n_cell=counts.n_cell,
                      n_donor=n_donor_use, learn_GT=learn_GT, **cfg_kwargs)
    ase = cfg.ASE_mode
    priors = default_priors(cfg, GT_prior=GT_prior_use, dtype=dtype,
                            device=device, layout=layout)

    def model(n_donor, learn_GT, **init):
        return Vireo(n_cell=counts.n_cell, n_var=counts.n_var,
                     n_donor=n_donor, learn_GT=learn_GT, dtype=dtype,
                     device=device, layout=layout, **init, **cfg_kwargs)

    # ---- warm restarts: one batched fit (vireo_wrap.py:64-87)
    if resume is not None:
        # the saved RNG position keeps later draws (the refits' inits)
        # on the uninterrupted run's stream
        best_state, _, ex = ckpt.load_state(checkpoint_dir, 0, dtype=dtype,
                                            device=device, layout=layout,
                                            ase=ase)
        elbo_all = np.asarray(ex["elbo_all"])
        ckpt.load_rng(checkpoint_dir, "rng_0")
    else:
        with phase("warm_restarts"):
            if device_init:
                if generator is None:
                    seed = int(rng.randint(2 ** 31))
                    if mesh is not None:
                        # one stream for every rank: rank 0's seed
                        seed = int(mesh.broadcast(torch.tensor([seed])))
                    generator = torch.Generator(device=device)
                    generator.manual_seed(seed)
                batched = _device_batched_init(cfg, n_init, GT_prior_use,
                                               generator, dtype, device)
            else:
                batched = _seeded_batched_init(cfg, n_init, GT_prior_use,
                                               rng, dtype, device,
                                               n_cell_draw=n_cell_in)
            if layout is not None:
                batched = shard_state(batched, layout, ase)
            warm = fit_vb(counts, batched, priors, cfg,
                          max_iter=max_iter_init, min_iter=5,
                          delay_fit_theta=delay_fit_theta)
            # np.argmax takes the first maximum, as jnp.argmax does; on a
            # mesh every rank takes rank 0's pick
            best = int(np.argmax(warm.elbo_ref))
            if mesh is not None:
                best = int(mesh.broadcast(torch.tensor([best])))
            best_state = warm.state.take(best)
            elbo_all = warm.elbo_ref + float(counts.binom_coeff_sum())
            del warm, batched
        if checkpoint_dir:
            ckpt.save_state(checkpoint_dir, 0, best_state,
                            extra={"elbo_all": elbo_all},
                            fingerprint=run_fp, layout=layout, ase=ase)
            ckpt.save_rng(checkpoint_dir, "rng_0", mesh=mesh)

    if resume is not None and resume >= 1:
        state1, priors1, ex1 = ckpt.load_state(checkpoint_dir, 1,
                                               dtype=dtype, device=device,
                                               layout=layout, ase=ase)
        ckpt.load_rng(checkpoint_dir, "rng_1")
        modelCA = _model_from_state(
            counts, cfg_kwargs, int(ex1["n_donor"]), bool(ex1["learn_GT"]),
            state1, None, dtype, device, device_state=True, layout=layout)
        modelCA.priors = priors1      # the branch's genotype prior
        modelCA.ELBO_ = np.asarray(ex1["ELBO_"])
        if verbose and root:
            print("[vireo] lower bound ranges [%.1f, %.1f, %.1f]"
                  % (np.min(elbo_all), np.median(elbo_all),
                     np.max(elbo_all)))
    else:
        with phase("model_build"):
            modelCA = _model_from_state(
                counts, cfg_kwargs, n_donor_use, learn_GT, best_state,
                GT_prior_use, dtype, device, device_state=device_init,
                layout=layout)
        modelCA.ELBO_ = np.asarray([elbo_all[np.argmax(elbo_all)]])

        # ---- long refit of the winner / extra-donor reduction
        # (vireo_wrap.py:89-105); the branches' host steps take float64
        with phase("refit"):
            if n_extra_donor == 0:
                modelCA.fit(counts, min_iter=5, verbose=False)
            else:
                _ID_prob = donor_select(
                    modelCA.GT_prob.astype(np.float64),
                    modelCA.ID_prob.astype(np.float64), n_donor,
                    mode=extra_donor_mode, verbose=verbose and root)
                modelCA = model(n_donor, learn_GT,
                                GT_prob_init=GT_prior_use,
                                ID_prob_init=_ID_prob,
                                beta_mu_init=modelCA.beta_mu,
                                beta_sum_init=modelCA.beta_sum)
                modelCA.set_prior(GT_prior=GT_prior_use)
                modelCA.fit(counts, min_iter=5,
                            delay_fit_theta=delay_fit_theta, verbose=False)

            if verbose and root:
                print("[vireo] lower bound ranges [%.1f, %.1f, %.1f]"
                      % (np.min(elbo_all), np.median(elbo_all),
                         np.max(elbo_all)))

            # ---- donor-subset prior: keep the largest donors, refit with
            # the genotypes fixed (vireo_wrap.py:111-119)
            if GT_prior is not None and n_donor < GT_prior.shape[1]:
                _donor_cnt = _donor_sizes(modelCA)
                _donor_idx = np.argsort(_donor_cnt)[::-1]
                GT_prior_use = GT_prior[:, _donor_idx[:n_donor], :]
                # the reference keeps the default (uniform) genotype
                # prior here; only the init is pinned
                modelCA = model(n_donor, False, GT_prob_init=GT_prior_use)
                modelCA.fit(counts, min_iter=20, verbose=False)

            # ---- donor-superset prior: graft the known donors into
            # their matched slots (vireo_wrap.py:121-136)
            elif GT_prior is not None and n_donor > GT_prior.shape[1]:
                GT_prior_use = modelCA.GT_prob.astype(np.float64)
                idx = optimal_match(GT_prior, GT_prior_use)[1]
                GT_prior_use[:, idx, :] = GT_prior
                _idx_order = np.append(idx,
                                       np.delete(np.arange(n_donor), idx))
                GT_prior_use = GT_prior_use[:, _idx_order, :]
                ID_prob_use = modelCA.ID_prob[:, _idx_order]
                modelCA = model(n_donor, learn_GT, ID_prob_init=ID_prob_use,
                                beta_mu_init=modelCA.beta_mu,
                                beta_sum_init=modelCA.beta_sum,
                                GT_prob_init=GT_prior_use)
                modelCA.set_prior(GT_prior=GT_prior_use)
                modelCA.fit(counts, min_iter=20, verbose=False)

        if checkpoint_dir:
            ckpt.save_state(checkpoint_dir, 1, modelCA.state,
                            priors=modelCA.priors,
                            extra={"elbo_all": elbo_all,
                                   "ELBO_": modelCA.ELBO_,
                                   "n_donor": modelCA.n_donor,
                                   "learn_GT": modelCA.config.learn_GT},
                            fingerprint=run_fp, layout=layout, ase=ase)
            ckpt.save_rng(checkpoint_dir, "rng_1", mesh=mesh)

    if verbose:
        # every rank gathers (collectives); rank 0 prints
        beta_mu, beta_sum = modelCA.beta_mu, modelCA.beta_sum
        _donor_cnt = _donor_sizes(modelCA)
        if root:
            print("[vireo] allelic rate mean and concentrations:")
            print(np.round(beta_mu, 3))
            print(np.round(beta_sum, 1))
            print("[vireo] donor size before removing doublets:")
            print("\t".join(["donor%d" % x for x in range(len(_donor_cnt))]))
            print("\t".join(["%.0f" % x for x in _donor_cnt]))

    # ---- doublet prediction (vireo_wrap.py:150-156)
    n_donor_final = modelCA.n_donor
    if check_doublet:
        with phase("doublet"):
            doublet_prob, ID_prob, doublet_LLR = predict_doublet(
                modelCA, counts, None,
                doublet_rate_prior=min(0.5, n_cell_in / 100000))
    else:
        ID_prob = modelCA.ID_prob
        doublet_prob = np.zeros(
            (counts.n_cell, int(n_donor_final * (n_donor_final - 1) / 2)))
        doublet_LLR = np.zeros(counts.n_cell)

    beta_mu, beta_sum = modelCA.beta_mu, modelCA.beta_sum
    theta_shapes = np.append(beta_mu * beta_sum, (1 - beta_mu) * beta_sum,
                             axis=0)

    # ---- ambient RNA (vireo_tpu/engine/wrap.py:772-783)
    if check_ambient:
        with phase("ambient"):
            ambient_Psi, Psi_var, Psi_logLik_ratio = predict_ambient(
                modelCA, counts, None, min_ELBO_gain=ambient_min_gain)
    else:
        ambient_Psi, Psi_var, Psi_logLik_ratio = None, None, None

    if isinstance(timing, dict):
        timing.update(timer.phases)
    elif timing and root:
        print(timer.summary())

    RV = {}
    RV['ID_prob'] = ID_prob
    RV['GT_prob'] = modelCA.GT_prob
    RV['doublet_LLR'] = doublet_LLR
    RV['doublet_prob'] = doublet_prob
    RV['theta_shapes'] = theta_shapes
    RV['theta_mean'] = beta_mu
    RV['theta_sum'] = beta_sum
    RV['ambient_Psi'] = ambient_Psi
    RV['Psi_var'] = Psi_var
    RV['Psi_LLRatio'] = Psi_logLik_ratio
    RV['LB_list'] = elbo_all
    RV['LB_doublet'] = modelCA.ELBO_[-1]
    if n_pad_cells:
        for key in ('ID_prob', 'doublet_prob', 'doublet_LLR',
                    'ambient_Psi', 'Psi_var', 'Psi_LLRatio'):
            if RV.get(key) is not None:
                RV[key] = np.asarray(RV[key])[:n_cell_in]
    return RV
