"""Checkpoint and resume for long fits (counterpart of
vireo_tpu/utils/checkpoint.py).

One `.npz` per checkpoint, with the JAX package's keys and file names
(the state's fields, `prior_*`, `extra_*`, `fp_*` for the run's
fingerprint) and the numpy global RNG in its own `.npz`, so each package
reads the other's files.

On a mesh (a `layout`, parallel/mesh.py) every rank calls these
functions: `save_state` gathers the global state (as
vireo_tpu/utils/checkpoint.py:38-52 fetches its sharded state), rank 0
writes it and every rank waits for the file; `load_state` reads the
global file on every rank and keeps the rank's block.
"""

import glob
import os
import warnings

import numpy as np
import torch

from ..models.vireo import VireoState, VireoPriors
from ..parallel.mesh import (shard_state, gather_state, shard_priors,
                             gather_priors)
from .device import resolve_device, default_dtype

__all__ = ["save_state", "load_state", "latest_step", "save_rng",
           "load_rng", "check_fingerprint"]


def _path(ckpt_dir, step):
    return os.path.join(ckpt_dir, "vireo_ckpt_%08d.npz" % step)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_state(ckpt_dir, step, state, priors=None, elbo_trace=None,
               extra=None, fingerprint=None, layout=None, ase=False):
    """Write a checkpoint atomically (a temporary file, then a rename).

    `fingerprint` is a flat dict of scalars that identify the run
    (shapes, n_donor, n_init, seed, ...); `check_fingerprint` refuses
    to resume from a checkpoint whose fingerprint differs. With a
    `layout`, `state` and `priors` are this rank's blocks (thetas per
    variant when `ase`): they are gathered, rank 0 writes, and every
    rank returns once the file is there.
    """
    if layout is not None:
        state = gather_state(state, layout, ase)
        if priors is not None:
            priors = gather_priors(priors, layout)
        if not layout.mesh.is_root:
            layout.mesh.barrier()
            return _path(ckpt_dir, step)
    path = _write_state(ckpt_dir, step, state, priors, elbo_trace, extra,
                        fingerprint)
    if layout is not None:
        layout.mesh.barrier()
    return path


def _write_state(ckpt_dir, step, state, priors, elbo_trace, extra,
                 fingerprint):
    payload = {"beta_mu": _host(state.beta_mu),
               "beta_sum": _host(state.beta_sum),
               "gt_prob": _host(state.gt_prob),
               "id_prob": _host(state.id_prob)}
    if priors is not None:
        payload.update({"prior_theta_s1": _host(priors.theta_s1),
                        "prior_theta_s2": _host(priors.theta_s2),
                        "prior_id_log": _host(priors.id_log),
                        "prior_gt_log": _host(priors.gt_log)})
    if elbo_trace is not None:
        payload["elbo_trace"] = _host(elbo_trace)
    for k, v in (extra or {}).items():
        payload["extra_" + k] = _host(v)
    for k, v in (fingerprint or {}).items():
        payload["fp_" + k] = np.asarray(v)

    path = _path(ckpt_dir, step)
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **payload)
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir):
    """Highest checkpoint step in the directory, or None."""
    paths = glob.glob(os.path.join(ckpt_dir, "vireo_ckpt_*.npz"))
    if not paths:
        return None
    return max(int(os.path.basename(p)[11:-4]) for p in paths)


def load_state(ckpt_dir, step=None, dtype=None, device=None, layout=None,
               ase=False):
    """(state, priors or None, dict of extras) from a checkpoint, as
    tensors of `dtype` on `device` (defaults: utils/device.py's); with a
    `layout`, this rank's blocks of the global state and priors."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError("no checkpoints in %s" % ckpt_dir)

    def put(a):
        return torch.as_tensor(a, device=device).to(dtype)

    with np.load(_path(ckpt_dir, step)) as z:
        state = VireoState(*(put(z[f]) for f in
                             ("beta_mu", "beta_sum", "gt_prob", "id_prob")))
        priors = None
        if "prior_theta_s1" in z:
            priors = VireoPriors(*(put(z["prior_" + f]) for f in
                                   ("theta_s1", "theta_s2", "id_log",
                                    "gt_log")))
        extras = {k[6:]: z[k] for k in z.files if k.startswith("extra_")}
        if "elbo_trace" in z:
            extras["elbo_trace"] = z["elbo_trace"]
    if layout is not None:
        state = shard_state(state, layout, ase)
        if priors is not None:
            priors = shard_priors(priors, layout)
    return state, priors, extras


def check_fingerprint(ckpt_dir, fingerprint, step=None):
    """Compare a run's fingerprint with the one stored at `step`
    (default: the latest). Raises ValueError on any mismatch; warns when
    the checkpoint holds no fingerprint."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        return
    with np.load(_path(ckpt_dir, step)) as z:
        stored = {k[3:]: z[k] for k in z.files if k.startswith("fp_")}
    if not stored:
        warnings.warn("[vireo] checkpoint %s has no run fingerprint; "
                      "cannot verify it matches this run's inputs"
                      % ckpt_dir)
        return
    bad = [k for k, v in fingerprint.items()
           if k in stored and not np.array_equal(np.asarray(v), stored[k])]
    if bad:
        detail = ", ".join("%s: run=%r ckpt=%r"
                           % (k, fingerprint[k], stored[k].tolist())
                           for k in bad)
        raise ValueError(
            "[vireo] checkpoint directory %s was written by a DIFFERENT "
            "run (%s). Refusing to resume — clear the directory or point "
            "--checkpointDir elsewhere." % (ckpt_dir, detail))


def save_rng(ckpt_dir, name="rng_state", mesh=None):
    """Save numpy's global RNG state (the seeded init stream); on a
    `mesh`, rank 0's, and every rank returns once it is written."""
    if mesh is not None and not mesh.is_root:
        mesh.barrier()
        return
    os.makedirs(ckpt_dir, exist_ok=True)
    s = np.random.get_state()
    np.savez(os.path.join(ckpt_dir, name + ".npz"),
             name=np.array(s[0]), keys=s[1], pos=np.array(s[2]),
             has_gauss=np.array(s[3]), cached=np.array(s[4]))
    if mesh is not None:
        mesh.barrier()


def load_rng(ckpt_dir, name="rng_state"):
    with np.load(os.path.join(ckpt_dir, name + ".npz")) as z:
        np.random.set_state((str(z["name"]), z["keys"], int(z["pos"]),
                             int(z["has_gauss"]), float(z["cached"])))
