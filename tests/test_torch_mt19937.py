"""The device MT19937 stream (ops/mt19937.py) and the seeded-init routing
of engine/wrap.py against numpy and the JAX package, on the CPU in
float64. The kernel's wrapper (`take_state`, `kernel_stream`) on CPU
keys runs its plain version: the stream equals `np.random.rand` (and
the JAX package's lane stream) bit for bit, and the end state it sets
equals numpy's after the draw; it never launches the kernel.
`_mt_batched_init` equals JAX's `_host_batched_init` and
`_mt_batched_init` bit for bit. Seeded inits take `_mt_batched_init` on
a card and `_host_batched_init` on any other device; seeded `vireo_wrap`
and `sweep_n_donor` forced through `_mt_batched_init` give the host
path's results, and JAX's (LB_list and ELBOs rtol 1e-9, calls and
iterations identical). The kernel itself: test_torch_mt19937_cuda.py on
a card."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vireo_tpu.engine import wrap as jwrap
from vireo_tpu.engine import select as jsel
from vireo_tpu.models.vireo import VireoConfig as JConfig
from vireo_tpu.ops import mt19937 as jmt
from vireo_tpu_torch.engine import wrap as twrap
from vireo_tpu_torch.engine import select as tsel
from vireo_tpu_torch.models import vireo as tvireo
from vireo_tpu_torch.ops import mt19937 as tmt
from vireo_tpu_torch.ops.mt19937 import (device_stream, np_pairwise_sum_last,
                                         take_state, kernel_stream,
                                         stream_walk)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _ask_for_the_cpu(monkeypatch):
    monkeypatch.setenv("VIREO_PLATFORM", "cpu")


@pytest.mark.parametrize("seed,n,pre_words", [
    (2, 1000, 0),        # several lanes, fresh seed (pool offset 624)
    (7, 312 * 5, 0),     # a whole number of chunks
    (3, 987654, 0),      # large, uneven last lane
    (3, 12345, 1),       # odd in-pool offset
    (11, 624 * 3 + 7, 3),
])
def test_stream_bit_parity_and_host_position(seed, n, pre_words):
    np.random.seed(seed)
    if pre_words:
        np.random.bytes(4 * pre_words)
    saved = np.random.get_state()
    want = np.random.rand(n)
    pos_want = np.random.get_state()

    np.random.set_state(saved)
    before = tmt.LAUNCHES
    got = kernel_stream(take_state(n, device="cpu"))
    pos_got = np.random.get_state()

    assert tmt.LAUNCHES == before
    assert got.dtype == torch.float64 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert pos_want[2] == pos_got[2]
    np.testing.assert_array_equal(pos_want[1], pos_got[1])

    # the JAX package's lane plan and stream, from the same state
    np.random.set_state(saved)
    np.testing.assert_array_equal(
        np.asarray(jmt.device_stream(jmt.plan_stream(n, max_lanes=7))), want)


@pytest.mark.parametrize("seed,n,pre_words", [
    (2, 1000, 0),
    (7, 312 * 5, 0),
    (3, 987654, 0),
    (3, 12345, 1),
    (11, 624 * 3 + 7, 3),
    (5, 312 * 7, 0),     # p0 + 2n ends a 624 round: numpy's pos 624
    (5, 311, 1),         # within the keys: no round twisted
])
def test_kernel_plain_version_rebuilds_numpy_state(seed, n, pre_words):
    """The kernel's wrapper on CPU keys (its plain version): the stream
    of `rand(n)` bit for bit, and the end state it sets from the keys the
    plain `_twist` rounds reach is exactly numpy's after `rand(n)`,
    position and Gaussian cache included."""
    np.random.seed(seed)
    if pre_words:
        np.random.bytes(4 * pre_words)
    np.random.standard_normal()          # leaves a cached Gaussian
    saved = np.random.get_state()
    want = np.random.rand(n)
    state_want = np.random.get_state()

    np.random.set_state(saved)
    before = tmt.LAUNCHES
    plan = take_state(n, device="cpu")
    assert np.random.get_state()[2] == saved[2]     # the plan draws nothing
    got = kernel_stream(plan)
    state_got = np.random.get_state()

    assert tmt.LAUNCHES == before
    assert got.dtype == torch.float64 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert state_got[0] == state_want[0]
    np.testing.assert_array_equal(state_got[1], state_want[1])
    assert state_got[2:] == state_want[2:]
    assert stream_walk(n, int(saved[2]))["pos"] == state_want[2]


def test_kernel_plain_version_with_randomstate_object():
    rng = np.random.RandomState(42)
    rng.rand(7)
    ref = np.random.RandomState(42)
    ref.rand(7)
    want = ref.rand(5000)
    got = kernel_stream(take_state(5000, rng=rng, device="cpu"), rng)
    np.testing.assert_array_equal(got.numpy(), want)
    state, state_ref = rng.get_state(), ref.get_state()
    np.testing.assert_array_equal(state[1], state_ref[1])
    assert state[2:] == state_ref[2:]
    np.testing.assert_array_equal(rng.rand(10), ref.rand(10))


def test_stream_walk_ends_where_numpy_does():
    """`stream_walk`'s end position is numpy's after `rand(n)` from any
    position, a round's end (624) included, and its round holds the last
    drawn word."""
    keys = np.random.RandomState(9).get_state()[1]
    rng = np.random.RandomState()
    for p0 in (0, 1, 2, 311, 622, 623, 624):
        for n in (1, 2, 311, 312, 313, 624, 5000, 123457):
            rng.set_state(("MT19937", keys, p0))
            rng.rand(n)
            w = stream_walk(n, p0)
            assert w["pos"] == rng.get_state()[2], (p0, n)
            assert 624 * w["rounds"] <= p0 + 2 * n - 1 < 624 * (w["rounds"]
                                                                + 1)


def test_card_streams_always_take_the_kernel_path(monkeypatch):
    """A seeded init on a card takes `_mt_batched_init` (the kernel), on
    the CPU `_host_batched_init`, at any size: the device alone picks."""
    calls = []
    for name in ("_mt_batched_init", "_host_batched_init"):
        monkeypatch.setattr(twrap, name,
                            lambda *a, _name=name, **k: calls.append(_name))
    small = tvireo.VireoConfig(n_var=6, n_cell=4, n_donor=2)
    large = tvireo.VireoConfig(n_var=30_000, n_cell=100_000, n_donor=16)
    for cfg in (small, large):
        for device in ("cuda", torch.device("cuda", 0), "cpu"):
            twrap._seeded_batched_init(cfg, 50, None, np.random,
                                       torch.float32, device)
    assert calls == ["_mt_batched_init", "_mt_batched_init",
                     "_host_batched_init"] * 2


def test_cpu_stream_never_reaches_the_kernel(monkeypatch):
    """On the CPU, _mt_batched_init plans with `take_state` and streams
    with `kernel_stream`'s plain version: the state and numpy's position
    equal `_host_batched_init`'s bit for bit, and LAUNCHES stays 0."""
    monkeypatch.setattr(tmt, "LAUNCHES", 0)
    plain = []
    real = tmt._kernel_stream_reference

    def counted(*a):
        plain.append(1)
        return real(*a)
    monkeypatch.setattr(tmt, "_kernel_stream_reference", counted)
    cfg = tvireo.VireoConfig(n_var=60, n_cell=40, n_donor=3)
    np.random.seed(5)
    got = twrap._mt_batched_init(cfg, 4, None, np.random, torch.float64,
                                 "cpu")
    pos = np.random.get_state()
    np.random.seed(5)
    want = twrap._host_batched_init(cfg, 4, None, np.random, torch.float64,
                                    "cpu")
    for key in ("beta_mu", "beta_sum", "gt_prob", "id_prob"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      getattr(want, key).numpy(), err_msg=key)
    np.testing.assert_array_equal(pos[1], np.random.get_state()[1])
    assert pos[2:] == np.random.get_state()[2:]
    assert plain == [1] and tmt.LAUNCHES == 0


@pytest.mark.parametrize("K", [2, 3, 4, 7, 8, 12, 16, 24, 100, 128])
def test_pairwise_sum_matches_numpy_bitwise(K):
    x = np.random.RandomState(0).rand(50, K)
    np.testing.assert_array_equal(
        np_pairwise_sum_last(torch.from_numpy(x)).numpy(), np.sum(x, -1))
    np.testing.assert_array_equal(np_pairwise_sum_last(x), np.sum(x, -1))


def _one_lane(n):
    """A `device_stream` plan of one lane: the `n` draws from the global
    generator's keys and position (which do not move)."""
    _, keys, pos, _, _ = np.random.get_state()
    return {"states": torch.from_numpy(keys.astype(np.int64))[None],
            "p0": int(pos), "c_blocks": -(-2 * n // 624), "n_total": n}


def test_float32_stream_is_jax_float32_stream():
    """dtype=float32 on a one-lane stream: JAX's transform without x64,
    deterministic and within 2e-7 of the float64 stream, which is
    numpy's."""
    np.random.seed(9)
    saved = np.random.get_state()
    f64 = device_stream(_one_lane(5000)).numpy()
    f32 = device_stream(_one_lane(5000), dtype=torch.float32).numpy()
    np.testing.assert_array_equal(f64, np.random.rand(5000))
    np.random.set_state(saved)
    j32 = np.asarray(jmt.device_stream(jmt.plan_stream(5000, max_lanes=4),
                                       dtype=jnp.float32))
    assert f32.dtype == np.float32
    np.testing.assert_array_equal(f32, j32)
    np.testing.assert_allclose(f32, f64, rtol=2e-7, atol=2e-7)


def _state(st):
    return {k: np.asarray(getattr(st, k)) for k in
            ("beta_mu", "beta_sum", "gt_prob", "id_prob")}


@pytest.mark.parametrize("with_prior,n_cell_draw", [
    (False, None), (False, 30), (True, None)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_mt_batched_init_bitmatches_jax(with_prior, n_cell_draw, dtype):
    """The port's _mt_batched_init against JAX's _host_batched_init and
    _mt_batched_init (x64), and its own host path: the same state bit for
    bit and the same numpy position after. In float32 (normalised in
    float64, then cast) it equals both host paths cast the same way."""
    cfg_t = tvireo.VireoConfig(n_var=60, n_cell=40, n_donor=3)
    cfg_j = JConfig(n_var=60, n_cell=40, n_donor=3)
    gp = np.random.RandomState(0).rand(60, 3, 3) if with_prior else None
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32

    runs = {}
    for name, fn in (
            ("t_mt", lambda: twrap._mt_batched_init(
                cfg_t, 4, gp, np.random, dtype, "cpu",
                n_cell_draw=n_cell_draw)),
            ("t_host", lambda: twrap._host_batched_init(
                cfg_t, 4, gp, np.random, dtype, "cpu",
                n_cell_draw=n_cell_draw)),
            ("j_host", lambda: jwrap._host_batched_init(
                cfg_j, 4, gp, np.random, jdt, n_cell_draw=n_cell_draw)),
            ("j_mt", lambda: jwrap._mt_batched_init(
                cfg_j, 4, gp, np.random, jnp.float64,
                n_cell_draw=n_cell_draw))):
        np.random.seed(5)
        runs[name] = (_state(fn()), np.random.get_state())

    got, pos = runs["t_mt"]
    assert got["id_prob"].dtype == np.dtype(str(dtype)[6:])
    for other in ("t_host", "j_host", "j_mt"):
        want, pos_w = runs[other]
        for key in got:
            w = want[key]
            if other == "j_mt":          # JAX's is float64 only
                w = w.astype(got[key].dtype)
            np.testing.assert_array_equal(got[key], w,
                                          err_msg="%s %s" % (other, key))
        assert pos[2] == pos_w[2]
        np.testing.assert_array_equal(pos[1], pos_w[1])


def _spy(monkeypatch, calls):
    for name in ("_mt_batched_init", "_host_batched_init"):
        real = getattr(twrap, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(twrap, name, spy)


def _force_mt(mp):
    """Send the CPU's seeded inits through what is `_mt_batched_init`
    now (a spy, where one is set): the card's path, which runs the
    kernel's plain version on the CPU."""
    mp.setattr(twrap, "_host_batched_init", twrap._mt_batched_init)


def test_seeded_inits_route_by_stream_size(small_data, monkeypatch):
    """Seeded runs on the CPU take the host's draws, whatever the size of
    the stream; unseeded runs take neither path."""
    AD, DP, _ = small_data
    kw = dict(n_donor=3, n_init=2, random_seed=1, check_doublet=False,
              verbose=False, device="cpu")
    for n_init in (1, 2, 9):
        calls = []
        with monkeypatch.context() as mp:
            _spy(mp, calls)
            twrap.vireo_wrap(AD, DP, **dict(kw, n_init=n_init))
        assert calls == ["_host_batched_init"], (n_init, calls)
    calls = []
    with monkeypatch.context() as mp:
        _spy(mp, calls)
        twrap.vireo_wrap(AD, DP, **dict(kw, random_seed=None))
    assert calls == []


def _record_fits(monkeypatch, modules, calls):
    real = tvireo.fit_vb

    def spy(*args, **kwargs):
        res = real(*args, **kwargs)
        calls.append(np.atleast_1d(np.asarray(res.n_iter)).tolist())
        return res
    for m in modules:
        monkeypatch.setattr(m, "fit_vb", spy)


def test_wrap_device_mt_equals_host_path_and_jax(small_data, monkeypatch):
    """vireo_wrap through the host's draws and forced through
    `_mt_batched_init`: identical fits and results (the later host draws
    of the doublet-free run included), and JAX's vireo_wrap on the same
    seed."""
    AD, DP, _ = small_data
    kw = dict(n_donor=3, n_init=3, random_seed=6, check_doublet=False,
              verbose=False)
    res, fits = {}, {}
    for path in ("host", "mt"):
        calls = []
        with monkeypatch.context() as mp:
            if path == "mt":
                _force_mt(mp)
            _record_fits(mp, (twrap, tvireo), calls)
            res[path] = twrap.vireo_wrap(AD, DP, device="cpu", **kw)
            res[path]["next_draw"] = np.random.rand(3)
        fits[path] = calls
    assert fits["host"] == fits["mt"] and len(fits["mt"]) == 2
    for key in ("ID_prob", "GT_prob", "doublet_prob", "LB_list",
                "theta_shapes", "next_draw"):
        np.testing.assert_array_equal(res["host"][key], res["mt"][key],
                                      err_msg=key)

    rj = jwrap.vireo_wrap(AD, DP, dtype=jnp.float64, mesh=None, **kw)
    rt = res["mt"]
    np.testing.assert_allclose(rt["LB_list"], rj["LB_list"], rtol=1e-9)
    np.testing.assert_allclose(rt["LB_doublet"], rj["LB_doublet"],
                               rtol=1e-9)
    np.testing.assert_array_equal(np.argmax(rt["ID_prob"], 1),
                                  np.argmax(np.asarray(rj["ID_prob"]), 1))
    np.testing.assert_allclose(rt["ID_prob"], np.asarray(rj["ID_prob"]),
                               rtol=1e-9, atol=1e-12)


def test_seeded_sweep_under_device_mt_matches_jax(small_data, monkeypatch):
    AD, DP, _ = small_data
    calls = []
    _spy(monkeypatch, calls)
    _force_mt(monkeypatch)
    kw = dict(n_donor_list=(2, 3), n_init=3, max_iter_init=15,
              random_seed=4, verbose=False)
    want = jsel.sweep_n_donor(AD, DP, dtype=jnp.float64, **kw)
    got = tsel.sweep_n_donor(AD, DP, device="cpu", **kw)
    assert calls == ["_mt_batched_init"] * 2
    assert got["best"] == want["best"]
    for K in (2, 3):
        np.testing.assert_allclose(got[K], want[K], rtol=1e-9)
