"""The capacity ladder: vireo_tpu_torch.ops.counts.counts_from_scipy
picks the same rung as vireo_tpu.ops.counts.counts_from_scipy (single
device, `max_dense_elems=0`) for every budget and count magnitude, with
and without VIREO_NO_HYBRID / VIREO_NO_PACKED, and both read
VIREO_DENSE_BUDGET_GB. The rungs' numbers are held against JAX in
tests/test_torch_packed.py and, end to end, in tests/test_torch_wrap.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vireo_tpu.ops import counts as jcounts
from vireo_tpu.ops import packed as jpacked
from vireo_tpu_torch.ops import counts as tcounts

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's entry points run on the card unless asked for the CPU
    (utils/device.py); these tests ask for it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIREO_PLATFORM", "cpu")
        yield

V, C = 100, 131
N_ELEMS = V * C


def _pool(vmax, seed=3):
    rng = np.random.RandomState(seed)
    DP = (rng.rand(V, C) < 0.25) * (1 + rng.poisson(1.5, (V, C)))
    DP = np.minimum(DP, vmax)
    if vmax > 15:
        hot = (DP > 0) & (rng.rand(V, C) < 0.05)
        DP = np.where(hot, rng.randint(16, vmax + 1, (V, C)), DP)
    DP[0, 0] = vmax
    AD = rng.binomial(DP, 0.4)
    return AD.astype(np.float64), DP.astype(np.float64)


def _kind(c):
    """The class name, and the base's for a hybrid: the port's classes
    carry the names of their JAX counterparts."""
    name = type(c).__name__
    return name, type(c.base).__name__ if name == "HybridCounts" else None


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("env", [None, "VIREO_NO_HYBRID", "VIREO_NO_PACKED"])
@pytest.mark.parametrize("budget", [8 * N_ELEMS, 4 * N_ELEMS, 2 * N_ELEMS,
                                    N_ELEMS, N_ELEMS // 2],
                         ids=["8n", "4n", "2n", "1n", "half_n"])
@pytest.mark.parametrize("vmax", [12, 100, 200, 500])
def test_ladder_picks_the_jax_rung(vmax, budget, env, monkeypatch):
    for var in ("VIREO_NO_HYBRID", "VIREO_NO_PACKED"):
        monkeypatch.delenv(var, raising=False)
    if env:
        monkeypatch.setenv(env, "1")
    AD, DP = _pool(vmax)
    j = jcounts.counts_from_scipy(AD, DP, dtype=jnp.float64,
                                  max_dense_elems=0, dense_budget=budget)
    t = tcounts.counts_from_scipy(AD, DP, dense_budget=budget)
    # the order is JAX's; only the dense rung's bytes follow the port's
    # exact type: counts of 128 to 16,383 as int16 where JAX holds them
    # as bfloat16 or float32, so where two int16 matrices fit and JAX's
    # dense type does not (vmax 500 at 4n), the port is dense
    want = _kind(j)
    if tcounts._dense_bytes((V, C), vmax) <= budget:
        want = ("DenseCounts", None)
    assert _kind(t) == want
    rung = tcounts.ladder_rung((V, C), float(DP.max()), budget)
    assert {"dense": ("DenseCounts", None),
            "int8-hybrid": ("HybridCounts", "DenseCounts"),
            "packed": ("PackedCounts", None),
            "packed-hybrid": ("HybridCounts", "PackedCounts"),
            "coo": ("SparseCounts", None)}[rung] == _kind(t)
    if isinstance(t, tcounts.DenseCounts):
        assert t.ad.dtype == tcounts.exact_count_dtype(vmax)
        if vmax <= 127:
            assert _dtype_name(t.ad.dtype) == jnp.dtype(j.ad.dtype).name
    if isinstance(t, tcounts.HybridCounts):
        assert t.cap == j.cap and t.resid_nnz == j.resid_nnz
    # whatever the rung, the contractions are the pool's
    W = torch.as_tensor(np.random.RandomState(vmax).rand(C, 3))
    S1, SS = t.suff_stats(W)
    np.testing.assert_allclose(S1.numpy(), AD @ W.numpy(), rtol=1e-12)
    np.testing.assert_allclose(SS.numpy(), DP @ W.numpy(), rtol=1e-12)


def test_packed_rung_holds_the_jax_bytes():
    AD, DP = _pool(12)
    j = jcounts.counts_from_scipy(AD, DP, max_dense_elems=0,
                                  dense_budget=N_ELEMS)
    t = tcounts.counts_from_scipy(AD, DP, dense_budget=N_ELEMS)
    assert isinstance(j, jpacked.PackedCounts)
    Cb = (C + 1) // 2
    np.testing.assert_array_equal(
        t.ad_p.numpy(), np.asarray(j.ad_p).view(np.uint8)[:V, :Cb])
    np.testing.assert_array_equal(
        t.dp_p.numpy(), np.asarray(j.dp_p).view(np.uint8)[:V, :Cb])


@pytest.mark.parametrize("gb,rung", [("1", "dense"), ("0.00002", "packed"),
                                     ("0.000001", "coo")])
def test_dense_budget_env_is_read_as_in_jax(gb, rung, monkeypatch):
    """VIREO_DENSE_BUDGET_GB sets the budget in both packages, so the
    same environment gives the same rung."""
    monkeypatch.setenv("VIREO_DENSE_BUDGET_GB", gb)
    assert tcounts.device_dense_budget() == jcounts.device_dense_budget() \
        == float(gb) * 2**30
    assert tcounts.device_dense_budget("cpu") == float(gb) * 2**30
    AD, DP = _pool(12)
    assert tcounts.ladder_rung((V, C), 12.0,
                               tcounts.device_dense_budget()) == rung
    t = tcounts.counts_from_scipy(AD, DP)
    j = jcounts.counts_from_scipy(AD, DP, max_dense_elems=0)
    assert _kind(t) == _kind(j)


def test_default_budget_without_env(monkeypatch):
    monkeypatch.delenv("VIREO_DENSE_BUDGET_GB", raising=False)
    assert tcounts.device_dense_budget("cpu") == 16 * 2**30


GiB = 2**30
CARD = 80 * GiB
# 30k x 100k pools: a heavy tail (int16 counts, 11.18 GiB) and a
# pool16-like one (int8, 5.59 GiB)
HEAVY = ((30000, 100000), 2007.0)
LIGHT = ((30000, 100000), 12.0)


def _card(monkeypatch, free, reserved=0, allocated=0):
    """An 80 GiB card as torch.cuda's queries see it: `free` bytes free,
    the caching allocator holding `reserved` bytes, `allocated` of them
    live; the budget from the card alone (no VIREO_DENSE_BUDGET_GB)."""
    monkeypatch.delenv("VIREO_DENSE_BUDGET_GB", raising=False)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (free, CARD))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: reserved)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: allocated)
    return torch.device("cuda")


def test_default_budget_is_55_percent_of_the_card(monkeypatch):
    """JAX's rule (55% of the device's limit), whatever is free."""
    cuda = _card(monkeypatch, free=3 * GiB, reserved=40 * GiB,
                 allocated=12 * GiB)
    assert tcounts.device_dense_budget(cuda) == 0.55 * CARD
    assert tcounts.device_room(cuda) == (3 + 40 - 12) * GiB
    assert tcounts.device_room("cpu") is None


@pytest.mark.parametrize("pool,rung,dtype", [
    (HEAVY, "dense", torch.int16), (LIGHT, "dense", torch.int8)])
@pytest.mark.parametrize("free,reserved,allocated", [
    (79 * GiB, 0, 0),                      # an empty card
    (55 * GiB, 24 * GiB, 0),               # a previous job's counts cached
    (33 * GiB, 46 * GiB, 11.2 * GiB)])     # and a reference's live beside
def test_the_allocator_cache_does_not_move_the_rung(monkeypatch, pool,
                                                    rung, dtype, free,
                                                    reserved, allocated):
    cuda = _card(monkeypatch, free, reserved, allocated)
    assert tcounts.placement_rung(*pool, cuda) == (rung, 0.55 * CARD)
    assert tcounts.exact_count_dtype(pool[1]) == dtype


@pytest.mark.parametrize("pool,room,rung", [
    (HEAVY, 11 * GiB, "int8-hybrid"),      # 11.18 GiB do not fit
    (HEAVY, 8 * GiB, "packed-hybrid"),
    (LIGHT, 5.5 * GiB, "packed"),          # 5.59 GiB do not fit
    (LIGHT, 6 * GiB, "dense")])            # they fit, if barely
def test_a_card_that_cannot_hold_the_rung_takes_the_next(monkeypatch, capsys,
                                                        pool, room, rung):
    """Where the card's free memory (and the allocator's unused cache)
    cannot hold the rung the budget picks, the ladder picks again under
    55% of that room."""
    cuda = _card(monkeypatch, free=room - GiB, reserved=2 * GiB,
                 allocated=GiB)
    got, budget = tcounts.placement_rung(*pool, cuda, verbose=True)
    assert got == rung
    out = capsys.readouterr().out
    if rung == "dense":
        assert budget == 0.55 * CARD and out == ""
    else:
        assert budget == 0.55 * room
        assert "the dense rung needs" in out and ("the %s rung" % rung) in out


class _CellsMesh:
    """What the placement reads of a mesh of `size` ranks on one cells
    axis (no process group: `world_min` is each rank's own value)."""
    is_root = True

    def __init__(self, size):
        self.size = size

    def has(self, axis):
        return axis == "cells"

    def extent(self, axis):
        return self.size if axis == "cells" else 1


@pytest.mark.parametrize("room,rung", [(6 * GiB, "dense"),
                                       (5.5 * GiB, "int8-hybrid")])
def test_a_mesh_holds_each_rank_to_its_room(monkeypatch, room, rung):
    """On two ranks each holds half the dense rung's 11.18 GiB: 6 GiB of
    room a rank holds it, 5.5 GiB does not, and the ladder picks again
    under 55% of the two ranks' room."""
    cuda = _card(monkeypatch, free=room)
    got, budget = tcounts.placement_rung(*HEAVY, cuda, mesh=_CellsMesh(2))
    assert got == rung
    assert budget == (2 * 0.55 * CARD if rung == "dense" else 2 * 0.55 * room)


@pytest.mark.parametrize("gb,rung", [("44", "dense"),
                                     ("4", "packed-hybrid")])
def test_the_budget_env_wins_over_the_card(monkeypatch, gb, rung):
    """VIREO_DENSE_BUDGET_GB is taken as it is, as is an explicit budget,
    even where the card could not hold the rung."""
    cuda = _card(monkeypatch, free=GiB)
    monkeypatch.setenv("VIREO_DENSE_BUDGET_GB", gb)
    assert tcounts.placement_rung(*HEAVY, cuda) == (rung, float(gb) * GiB)
    monkeypatch.delenv("VIREO_DENSE_BUDGET_GB")
    assert tcounts.placement_rung(*HEAVY, cuda, dense_budget=44 * GiB) \
        == ("dense", 44 * GiB)


@pytest.mark.parametrize("vmax", [12, 200])
def test_ladder_never_refuses_a_pool(vmax, capsys):
    """The smallest budget still places the pool (on the COO rung)."""
    AD, DP = _pool(vmax)
    t = tcounts.counts_from_scipy(AD, DP, dense_budget=1, verbose=True)
    assert isinstance(t, tcounts.SparseCounts)
    assert "COO" in capsys.readouterr().out
    np.testing.assert_array_equal(t.n_vars_per_cell().numpy(),
                                  (DP > 0).sum(axis=0))
