"""Multi-initialization orchestrator for the Vireo model, on one device
(counterpart of vireo_tpu/engine/wrap.py).

The n_init random restarts run as one batched fit: the restart axis is
folded into the matmul's column dimension (R*K columns), each restart
stops at its own convergence, and the best ELBO is refit to
convergence, followed by the doublet E-step. Seeded runs draw their
inits from numpy's global stream in the reference's order; unseeded
runs draw them on the device from a torch.Generator.
"""

import contextlib
import time

import numpy as np
import torch

from ..ops.counts import counts_from_scipy
from ..models.vireo import (Vireo, VireoConfig, VireoState, default_priors,
                            fit_vb)
from ..models.doublet import predict_doublet
from ..utils.device import (resolve_device, default_dtype,
                            pin_matmul_precision, numpy_dtype, sync)

__all__ = ["vireo_wrap"]


def _not_ported(what, item):
    return NotImplementedError(
        "%s is not supported by the PyTorch port yet (ROADMAP.md, queue 1: "
        "%s)" % (what, item))


def _batched_beta(cfg, n_init, dtype, device):
    """The (n_init, L, G) beta_mu / beta_sum inits every restart shares
    (the reference defaults)."""
    L, G = cfg.theta_len, cfg.n_GT
    beta_mu = np.ones((L, G)) * np.linspace(0.01, 0.99, G)[None, :]
    beta_mu = torch.as_tensor(beta_mu, device=device).to(dtype)
    beta_mu = beta_mu.expand(n_init, L, G).contiguous()
    beta_sum = torch.full((n_init, L, G), 50.0, dtype=dtype, device=device)
    return beta_mu, beta_sum


def _host_batched_init(cfg, n_init, rng, dtype, device):
    """The reference's per-restart np.random draws, in the order and
    with the per-restart normalisation of
    vireo_tpu/engine/wrap.py::_host_batched_init, assembled into one
    batched array per field and placed once."""
    K, C, G = cfg.n_donor, cfg.n_cell, cfg.n_GT
    np_dtype = numpy_dtype(dtype)
    id_b = np.empty((n_init, C, K), np_dtype)
    gt_b = np.empty((n_init, cfg.n_var, K, G), np_dtype)
    for i in range(n_init):
        idp = rng.rand(C, K)
        id_b[i] = idp / idp.sum(1, keepdims=True)
        gtp = rng.rand(cfg.n_var, K, G)
        gt_b[i] = gtp / gtp.sum(-1, keepdims=True)
    beta_mu, beta_sum = _batched_beta(cfg, n_init, dtype, device)
    return VireoState(beta_mu=beta_mu, beta_sum=beta_sum,
                      gt_prob=torch.from_numpy(gt_b).to(device),
                      id_prob=torch.from_numpy(id_b).to(device))


def _device_batched_init(cfg, n_init, generator, dtype, device):
    """Unseeded inits drawn on the device: uniform draws normalised per
    restart. They carry no parity contract with any other stream."""
    shape_id = (n_init, cfg.n_cell, cfg.n_donor)
    shape_gt = (n_init, cfg.n_var, cfg.n_donor, cfg.n_GT)
    idp = torch.rand(shape_id, generator=generator, dtype=dtype,
                     device=device)
    gtp = torch.rand(shape_gt, generator=generator, dtype=dtype,
                     device=device)
    beta_mu, beta_sum = _batched_beta(cfg, n_init, dtype, device)
    return VireoState(beta_mu=beta_mu, beta_sum=beta_sum,
                      gt_prob=gtp / gtp.sum(-1, keepdim=True),
                      id_prob=idp / idp.sum(-1, keepdim=True))


def _model_from_state(counts, cfg_kwargs, n_donor, learn_GT, state, dtype,
                      device, device_state=False):
    """A Vireo wrapper seeded with an existing state (no RNG draws).

    Seeded runs go through the host, renormalising in float64 as the
    JAX package does (vireo_tpu/engine/wrap.py:425-432);
    `device_state=True` adopts the state's tensors as they are."""
    if device_state:
        m = Vireo(n_cell=counts.n_cell, n_var=counts.n_var,
                  n_donor=n_donor, learn_GT=learn_GT, dtype=dtype,
                  device=device, state_init=state, **cfg_kwargs)
    else:
        m = Vireo(n_cell=counts.n_cell, n_var=counts.n_var,
                  n_donor=n_donor, learn_GT=learn_GT, dtype=dtype,
                  device=device,
                  beta_mu_init=state.beta_mu.cpu().numpy(),
                  beta_sum_init=state.beta_sum.cpu().numpy(),
                  ID_prob_init=state.id_prob.cpu().numpy(),
                  GT_prob_init=state.gt_prob.cpu().numpy(), **cfg_kwargs)
    m.set_prior()
    return m


@contextlib.contextmanager
def _timed(record, name, device):
    """Record the wall time of a phase that ends in a device sync."""
    t0 = time.perf_counter()
    yield
    sync(device)
    record[name] = time.perf_counter() - t0


def vireo_wrap(AD, DP=None, GT_prior=None, n_donor=None, learn_GT=True,
               n_init=20, random_seed=None, check_doublet=True,
               max_iter_init=20, delay_fit_theta=3, n_extra_donor=0,
               extra_donor_mode="distance", check_ambient=False,
               ambient_min_gain=None, nproc=None, dtype=None, verbose=True,
               mesh=None, checkpoint_dir=None, timing=None, device=None,
               generator=None, **kwargs):
    """Run vireo with multiple initializations; returns the reference's
    result dict (vireo_wrap.py:170-183).

    AD, DP: scipy/numpy (n_var, n_cell) counts, placed by
    `ops.counts.counts_from_scipy` on the rung its budget picks, or any
    prebuilt counts object as AD (DenseCounts, PackedCounts, HybridCounts
    or SparseCounts), whose device then is the run's default.
    `device`/`dtype` default to the policy of utils/device.py. `nproc`
    is accepted for CLI parity and ignored. `kwargs` may carry model
    flags (ASE_mode, fix_beta_sum, learn_theta, n_GT). `generator`: the
    torch.Generator for unseeded inits (default: one on `device`, seeded
    from numpy's global stream). `timing`: True prints the seconds of
    each phase; a dict is filled with them.

    Not ported yet: GT_prior, n_extra_donor > 0, check_ambient, a mesh
    and checkpoint_dir raise NotImplementedError.
    """
    if GT_prior is not None:
        raise _not_ported("GT_prior", "donor-prior branches")
    if n_extra_donor:
        raise _not_ported("n_extra_donor > 0", "donor-prior branches")
    if check_ambient:
        raise _not_ported("check_ambient", "ambient")
    if mesh is not None:
        raise _not_ported("a device mesh", "multi-GPU")
    if checkpoint_dir is not None:
        raise _not_ported("checkpoint_dir", "checkpoints")
    if n_donor is None:
        raise ValueError("[vireo] Error: requiring n_donor or GT_prior.")

    pin_matmul_precision()
    device = resolve_device(getattr(AD, "device", None)
                            if device is None and hasattr(AD, "suff_stats")
                            else device)
    dtype = dtype or default_dtype(device)
    record = timing if isinstance(timing, dict) else {}

    def phase(name):
        return _timed(record, name, device)

    n_cell_in = AD.n_cell if hasattr(AD, "suff_stats") \
        else int(AD.shape[1])
    with phase("data_placement"):
        counts = AD if hasattr(AD, "suff_stats") else counts_from_scipy(
            AD, DP, device=device, verbose=verbose)

    if learn_GT is False and n_init > 1:
        print("GT is fixed, so use a single initialization")
        n_init = 1

    if random_seed is not None:
        np.random.seed(random_seed)
    rng = np.random  # the reference draws from the global stream

    n_donor = int(n_donor)
    cfg_kwargs = {k: v for k, v in kwargs.items()
                  if k in ("n_GT", "learn_theta", "ASE_mode",
                           "fix_beta_sum")}
    cfg = VireoConfig(n_var=counts.n_var, n_cell=counts.n_cell,
                      n_donor=n_donor, learn_GT=learn_GT, **cfg_kwargs)
    priors = default_priors(cfg, dtype=dtype, device=device)

    # ---- warm restarts: one batched fit (vireo_wrap.py:64-87)
    with phase("warm_restarts"):
        if random_seed is None:
            if generator is None:
                generator = torch.Generator(device=device)
                generator.manual_seed(int(rng.randint(2 ** 31)))
            batched = _device_batched_init(cfg, n_init, generator, dtype,
                                           device)
        else:
            batched = _host_batched_init(cfg, n_init, rng, dtype, device)
        warm = fit_vb(counts, batched, priors, cfg,
                      max_iter=max_iter_init, min_iter=5,
                      delay_fit_theta=delay_fit_theta)
        # np.argmax takes the first maximum, as jnp.argmax does
        best = int(np.argmax(warm.elbo_ref))
        best_state = warm.state.take(best)
        elbo_all = warm.elbo_ref + float(counts.binom_coeff_sum())
        del warm, batched

    with phase("model_build"):
        modelCA = _model_from_state(
            counts, cfg_kwargs, n_donor, learn_GT, best_state, dtype,
            device, device_state=random_seed is None)
    modelCA.ELBO_ = np.asarray([elbo_all[np.argmax(elbo_all)]])

    # ---- long refit of the winner (vireo_wrap.py:89-105)
    with phase("refit"):
        modelCA.fit(counts, min_iter=5, verbose=False)
    if verbose:
        print("[vireo] lower bound ranges [%.1f, %.1f, %.1f]"
              % (np.min(elbo_all), np.median(elbo_all), np.max(elbo_all)))
        print("[vireo] allelic rate mean and concentrations:")
        print(np.round(modelCA.beta_mu, 3))
        print(np.round(modelCA.beta_sum, 1))
        print("[vireo] donor size before removing doublets:")
        _donor_cnt = modelCA.state.id_prob.sum(dim=0).cpu().numpy()
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

    theta_shapes = np.append(modelCA.beta_mu * modelCA.beta_sum,
                             (1 - modelCA.beta_mu) * modelCA.beta_sum,
                             axis=0)

    if timing is True:
        print("[vireo] phase seconds: " + ", ".join(
            "%s %.3f" % kv for kv in record.items()))

    RV = {}
    RV['ID_prob'] = ID_prob
    RV['GT_prob'] = modelCA.GT_prob
    RV['doublet_LLR'] = doublet_LLR
    RV['doublet_prob'] = doublet_prob
    RV['theta_shapes'] = theta_shapes
    RV['theta_mean'] = modelCA.beta_mu
    RV['theta_sum'] = modelCA.beta_sum
    RV['ambient_Psi'] = None
    RV['Psi_var'] = None
    RV['Psi_LLRatio'] = None
    RV['LB_list'] = elbo_all
    RV['LB_doublet'] = modelCA.ELBO_[-1]
    return RV
