"""The comparison that decides `correct` fails a broken timed path: a
run of a tiny cell on the CPU, the harness's look for a card skipped,
with the program broken underneath in each way the cells can be:

- a fit step that returns its state unchanged;
- half of the cells left out of the contractions, the rest counted
  twice (the mean taken over the rest);
- an answer altered where it is produced: one cell's call moved to
  another donor; the sweep's chosen K moved;
- a contraction wrong in a few columns or at one width: the last two
  warm restarts' columns of `cell_loglik` (a tail tile of restarts), or
  `suff_stats` at one K's width of the sweep. Such a fault leaves most
  restarts sound, and an off restart alone reads as float32 reaching
  another optimum; the kept contractions catch it.

(There is no exchange between cards: every cell takes one.)"""

import contextlib
import time

import numpy as np
import pytest
import torch

from helpers import TINY_FITS, tiny_checkout
from portbench.harness.run_cell import run_cell


@contextlib.contextmanager
def _patched(owner, attr, make):
    real = getattr(owner, attr)
    setattr(owner, attr, make(real))
    try:
        yield
    finally:
        setattr(owner, attr, real)


def _stale_step():
    from vireo_tpu_torch.models import vireo

    def make(real):
        def step(counts, state, *args, **kwargs):
            _, loglik, elbo = real(counts, state, *args, **kwargs)
            return state, loglik, elbo
        return step
    return _patched(vireo, "em_step", make)


def _half_the_cells():
    from vireo_tpu_torch.ops.counts import DenseCounts

    def make(real):
        def suff_stats(self, W):
            keep = torch.zeros_like(W)
            keep[::2] = 2.0
            return real(self, W * keep)
        return suff_stats
    return _patched(DenseCounts, "suff_stats", make)


def _altered_call():
    from vireo_tpu_torch.engine import wrap

    def make(real):
        def predict(*args, **kwargs):
            dbl, ID, llr = real(*args, **kwargs)
            ID = np.array(ID)
            ID[0] = np.roll(ID[0], 1)
            return dbl, ID, llr
        return predict
    return _patched(wrap, "predict_doublet", make)


def _altered_best_k():
    from vireo_tpu_torch.engine import select

    def make(real):
        def sweep(*args, **kwargs):
            out = real(*args, **kwargs)
            out["best"] = out["best"] + 1
            return out
        return sweep
    return _patched(select, "sweep_n_donor", make)


def _tail_restarts():
    """cell_loglik wrong in the last two restarts' columns at the warm
    width."""
    from vireo_tpu_torch.ops.counts import DenseCounts
    fit = TINY_FITS["vireo_wrap"]
    K = fit["n_donor"]

    def make(real):
        def cell_loglik(self, Wa, Wd):
            out = real(self, Wa, Wd)
            if out.shape[1] == fit["n_init"] * K:
                out = out.clone()
                out[:, -2 * K:] *= 1.01
            return out
        return cell_loglik
    return _patched(DenseCounts, "cell_loglik", make)


def _one_k():
    """suff_stats wrong at the full width of the sweep's last K only."""
    from vireo_tpu_torch.ops.counts import DenseCounts
    fit = TINY_FITS["sweep_n_donor"]
    width = fit["n_init"] * fit["n_donor_list"][-1]

    def make(real):
        def suff_stats(self, W):
            S1, SS = real(self, W)
            return (S1 * 1.01, SS) if W.shape[1] == width else (S1, SS)
        return suff_stats
    return _patched(DenseCounts, "suff_stats", make)


FAULTS = {"stale_step": _stale_step, "half_the_cells": _half_the_cells,
          "altered_call": _altered_call, "altered_best_k": _altered_best_k,
          "tail_restarts": _tail_restarts, "one_k": _one_k}
# the numbers each fault must break (besides `correct` as a whole)
CAUGHT_BY = {"tail_restarts": ("contraction",),
             "one_k": ("contraction", "elbo_off")}


@pytest.mark.parametrize("entry,fault", [
    ("vireo_wrap", "stale_step"), ("vireo_wrap", "half_the_cells"),
    ("vireo_wrap", "altered_call"), ("sweep_n_donor", "stale_step"),
    ("vireo_wrap", "tail_restarts"), ("sweep_n_donor", "half_the_cells"),
    ("sweep_n_donor", "altered_best_k"), ("sweep_n_donor", "one_k")])
def test_a_broken_path_is_not_correct(tmp_path, entry, fault):
    root = tiny_checkout(tmp_path, entry=entry, traffic="placed")
    with FAULTS[fault]():
        out, lines = run_cell("tiny.cell", 2**31 + 3, 0.2, False,
                              torch.device("cpu"), time.perf_counter(),
                              root=root, log=lambda m: None)
    assert not out["correct"]
    assert out["failed"] == out["attempted"]
    assert lines[-1] == "[check] correct False"
    for name in CAUGHT_BY.get(fault, ()):
        check = out["checks"][name]
        assert check["value"] > check["limit"], (name, check)
