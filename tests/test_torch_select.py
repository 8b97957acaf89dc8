"""The K sweeps (engine/select.py) against the JAX package's, seeded, in
float64 on the CPU: identical per-K ELBO arrays (rtol 1e-9) and the same
best K; an unseeded sweep seeds one device generator per K from numpy's
stream."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vireo_tpu.engine import select as jsel
from vireo_tpu_torch.engine import select as tsel
from vireo_tpu_torch.engine import wrap as twrap
from vireo_tpu_torch.ops import counts as tcounts
from vireo_tpu_torch.sim.synth import synth_pool_counts

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pool():
    return synth_pool_counts(n_var=200, n_cell=150, n_donor=3, density=0.3,
                             mean_extra_depth=1.0, seed=3)


def _same(got, want, keys):
    assert got["best"] == want["best"]
    for K in keys:
        assert got[K].shape == want[K].shape
        np.testing.assert_allclose(got[K], want[K], rtol=1e-9)


# (prebuilt, K list, restarts, the truth where the sweep must find it):
# the pool's donor counts around its truth, and the K sweep of
# chip_smoke's [ksweep] (8 restarts, K = 12..18: warm widths 96-144, which
# K0's kernels take at column tiles 48, 64 and 80 on a card; here their
# plain versions run)
SWEEPS = [pytest.param(False, (2, 3, 4), 3, 3, id="False"),
          pytest.param(True, (2, 3, 4), 3, 3, id="True"),
          pytest.param(True, (12, 14, 16, 18), 8, None, id="k0_widths")]


@pytest.mark.parametrize("prebuilt,ks,n_init,truth", SWEEPS)
def test_seeded_sweep_n_donor_matches_jax(pool, prebuilt, ks, n_init, truth,
                                          capsys):
    kw = dict(n_donor_list=ks, n_init=n_init, max_iter_init=15,
              random_seed=9)
    want = jsel.sweep_n_donor(pool["AD"], pool["DP"], dtype=jnp.float64,
                              **kw)
    out_j = capsys.readouterr().out
    AD = tcounts.counts_from_scipy(pool["AD"], pool["DP"], device="cpu") \
        if prebuilt else pool["AD"]
    got = tsel.sweep_n_donor(AD, pool["DP"], device="cpu", **kw)
    assert capsys.readouterr().out == out_j
    _same(got, want, ks)
    if truth is not None:
        assert got["best"] == truth


def test_seeded_sweep_n_clone_matches_jax(pool):
    ks = (2, 3)
    kw = dict(n_clone_list=ks, n_init=4, min_iter=5, random_seed=2,
              verbose=False)
    np.random.seed(0)
    want = jsel.sweep_n_clone(pool["AD"], pool["DP"], dtype=jnp.float64,
                              **kw)
    np.random.seed(0)
    got = tsel.sweep_n_clone(pool["AD"], pool["DP"], device="cpu", **kw)
    _same(got, want, ks)


def test_unseeded_sweep_seeds_a_device_generator_per_k(pool, monkeypatch):
    calls = {"host": 0, "dev": 0}
    real_host, real_dev = twrap._host_batched_init, twrap._device_batched_init

    def host(*a, **k):
        calls["host"] += 1
        return real_host(*a, **k)

    def dev(cfg, n_init, prior, generator, *a):
        calls["dev"] += 1
        calls.setdefault("seeds", []).append(generator.initial_seed())
        return real_dev(cfg, n_init, prior, generator, *a)

    monkeypatch.setattr(twrap, "_host_batched_init", host)
    monkeypatch.setattr(twrap, "_device_batched_init", dev)
    np.random.seed(11)
    want = [np.random.randint(2 ** 31) for _ in range(2)]
    np.random.seed(11)
    out = tsel.sweep_n_donor(pool["AD"], pool["DP"], n_donor_list=(2, 3),
                             n_init=2, max_iter_init=10, device="cpu",
                             verbose=False)
    assert calls["host"] == 0 and calls["dev"] == 2
    assert calls["seeds"] == want
    assert set(out) == {2, 3, "best"} and np.isfinite(out[3]).all()
