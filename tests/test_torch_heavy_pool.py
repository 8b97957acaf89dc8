"""chip_smoke.py's heavy-tailed pool (`_heavy_pool`, the `[heavy]` phase)
against benchmarks/e2e_hybrid.py, and the port's vireo_wrap on each rung
that pool lands on against the JAX package's, on the CPU.

The script is loaded by file with VIREO_COMPILE_CACHE="" and small
E2E_* sizes; `vireo_tpu.ops.counts.counts_from_scipy` is replaced by a
stub that keeps the AD and DP it is handed and the truth from the
script's frame, then stops the script before its fit. chip_smoke's
helper must give the same matrices and truth exactly.

The rungs: the pool's largest count is above 256, so by default it lands
on dense float32 counts; a dense_budget of 2, 1 and 0 (one byte) times
n_var x n_cell bytes forces the int8-hybrid, packed-hybrid and COO
rungs. The port's vireo_wrap there, in float64, against the JAX
package's vireo_wrap in float64 on the same rung (its counts_from_scipy
in float64 with max_dense_elems=0 and the same budget): identical
refit iterations, winner and calls, LB_list rtol 1e-9, and the doublet
phase's outputs rtol 1e-9 (atol 1e-12). On the packed-hybrid rung the
JAX package's base contracts through its Pallas kernels in float32, so
there the port is held against JAX's default (dense float64) run, as
tests/test_torch_wrap.py holds its packed and hybrid rungs. JAX's
dense and COO counts are float64 (the type its counts_from_scipy gives
a small pool's dense rung and its COO values): the JAX package sums the
binomial constant of the ELBO in the counts' type, so on float32 counts
its LB_list moves by float32's rounding of that sum (2e-7 to 3e-7
relative on this pool), where the port sums it in float64 whatever the
counts' type.
"""

import importlib.util
import inspect
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from vireo_tpu.engine import wrap as jwrap
from vireo_tpu.models import vireo as jvireo
from vireo_tpu.ops import counts as jcounts
from vireo_tpu_torch.engine import wrap as twrap
from vireo_tpu_torch.models import vireo as tvireo
from vireo_tpu_torch.ops import counts as tcounts

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
SMALL = dict(n_var=300, n_cell=800)
N_INIT = 4
WRAP_DONORS = 4


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's entry points run on the card unless asked for the CPU
    (utils/device.py); these tests ask for it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIREO_PLATFORM", "cpu")
        yield


class _Stop(Exception):
    pass


def _script_pool(V, C, K):
    """AD, DP and the truth of benchmarks/e2e_hybrid.py at V x C x K, as
    the script hands them to counts_from_scipy."""
    got = {}

    def stub(AD, DP, **kwargs):
        scope = inspect.currentframe().f_back.f_locals
        got.update(AD=AD, DP=DP, **{k: scope[k] for k in
                                    ("donor", "is_dbl", "donor2")})
        raise _Stop

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIREO_COMPILE_CACHE", "")
        for key, value in (("E2E_VARS", V), ("E2E_CELLS", C),
                           ("E2E_DONORS", K)):
            mp.setenv(key, str(value))
        mp.setattr(jcounts, "counts_from_scipy", stub)
        spec = importlib.util.spec_from_file_location(
            "jax_e2e_hybrid", REPO / "benchmarks" / "e2e_hybrid.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        with pytest.raises(_Stop):
            module.main()
    return got


def _smoke_pool(V, C, K):
    kw = dict(chip_smoke.HEAVY, n_var=V, n_cell=C, n_donor=K)
    return chip_smoke._heavy_pool(**kw)


@pytest.mark.parametrize("K", [WRAP_DONORS, 16])
def test_heavy_pool_is_the_scripts(K):
    V, C = SMALL["n_var"], SMALL["n_cell"]
    want = _script_pool(V, C, K)
    got = _smoke_pool(V, C, K)
    for key in ("AD", "DP"):
        a, b = got[key], want[key]
        assert a.shape == b.shape == (V, C) and a.format == b.format
        assert a.has_canonical_format and b.has_canonical_format
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.data, b.data)
    for key in ("donor", "is_dbl", "donor2"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["DP"].max() > 256      # the regime the phase is for


def test_heavy_sizes_are_the_scripts_defaults():
    """HEAVY's sizes, hot share and density are the script's defaults."""
    text = (REPO / "benchmarks" / "e2e_hybrid.py").read_text()
    for env, key in (("E2E_VARS", "n_var"), ("E2E_CELLS", "n_cell"),
                     ("E2E_DONORS", "n_donor"), ("E2E_HOT", "hot_frac")):
        assert ('os.environ.get("%s", %s)' % (env, format(
            chip_smoke.HEAVY[key], "_d") if key != "hot_frac"
            else chip_smoke.HEAVY[key])) in text, env
    assert "density = %s\n" % chip_smoke.HEAVY["density"] in text
    assert "np.random.RandomState(%d)" % chip_smoke.HEAVY["seed"] in text


def test_heavy_accuracy_matches_labels_as_the_script():
    """chip_smoke's `_heavy_accuracy`: the calls' labels matched to the
    truth, confident true singlets only."""
    rng = np.random.RandomState(3)
    C, K = 500, 4
    pool = dict(donor=rng.randint(0, K, C), is_dbl=rng.rand(C) < 0.1)
    perm = rng.permutation(K)
    ID_prob = np.full((C, K), 0.02)
    ID_prob[np.arange(C), perm[pool["donor"]]] = 0.94
    wrong = np.arange(C) < 40
    ID_prob[wrong] = np.roll(ID_prob[wrong], 1, axis=1)
    unsure = (np.arange(C) >= 40) & (np.arange(C) < 60)
    ID_prob[unsure] = 1.0 / K
    acc, assigned = chip_smoke._heavy_accuracy(pool, ID_prob)
    singlets = ~pool["is_dbl"]
    conf = singlets & ~unsure
    assert assigned == pytest.approx(conf.sum() / singlets.sum())
    assert acc == pytest.approx(1.0 - (wrong & conf).sum() / conf.sum())


@pytest.fixture(scope="module")
def heavy():
    return _smoke_pool(SMALL["n_var"], SMALL["n_cell"], WRAP_DONORS)


def _record_fits(mp, module, calls):
    real = module.fit_vb

    def spy(*args, **kwargs):
        res = real(*args, **kwargs)
        calls.append(np.atleast_1d(np.asarray(res.n_iter)).copy())
        return res

    mp.setattr(module, "fit_vb", spy)


def _jax_run(AD, DP, budget):
    """JAX's vireo_wrap in float64 on the rung its ladder picks under
    `budget` bytes (None: its dense rung in float64); its counts' class
    names, result and refit length."""
    if budget is None:
        jc = jcounts.counts_from_scipy(AD, DP, dtype=jnp.float64)
    else:
        jc = jcounts.counts_from_scipy(AD, DP, dtype=jnp.float64,
                                       max_dense_elems=0,
                                       dense_budget=budget)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("VIREO_FUSED_DOUBLET", raising=False)
        _record_fits(mp, jvireo, calls)
        res = jwrap.vireo_wrap(jc, n_donor=WRAP_DONORS, n_init=N_INIT,
                               random_seed=6, dtype=jnp.float64,
                               verbose=False, mesh=None)
    names = (type(jc).__name__, type(getattr(jc, "base", jc)).__name__)
    return names, res, calls[-1]


@pytest.fixture(scope="module")
def jax_default(heavy):
    return _jax_run(heavy["AD"], heavy["DP"], None)


@pytest.mark.parametrize("rung,units,cls,base", [
    ("dense", None, "DenseCounts", None),
    ("int8-hybrid", 2, "HybridCounts", "DenseCounts"),
    ("packed-hybrid", 1, "HybridCounts", "PackedCounts"),
    ("coo", 0, "SparseCounts", None),
])
def test_heavy_pool_rungs_match_jax(heavy, jax_default, rung, units, cls,
                                    base):
    AD, DP = heavy["AD"], heavy["DP"]
    V, C = AD.shape
    budget = (tcounts.device_dense_budget("cpu") if units is None
              else max(units * V * C, 1))
    assert tcounts.ladder_rung((V, C), float(DP.max()), budget) == rung
    counts = tcounts.counts_from_scipy(
        AD, DP, device="cpu", dense_budget=None if units is None else budget)
    assert type(counts).__name__ == cls
    if base:
        assert type(counts.base).__name__ == base
    else:
        assert not hasattr(counts, "base")
    if rung == "dense":
        assert counts.ad.dtype == torch.float32
    if rung in ("dense", "packed-hybrid"):
        names, rj, j_refit = jax_default
        assert names == ("DenseCounts", "DenseCounts")
    else:
        names, rj, j_refit = _jax_run(AD, DP, budget)
        assert names == (cls, base or cls)
    t_calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("VIREO_FUSED_DOUBLET", raising=False)
        _record_fits(mp, twrap, t_calls)
        _record_fits(mp, tvireo, t_calls)
        rt = twrap.vireo_wrap(counts, n_donor=WRAP_DONORS, n_init=N_INIT,
                              random_seed=6, dtype=torch.float64,
                              verbose=False)
    np.testing.assert_array_equal(t_calls[-1], j_refit)
    assert np.argmax(rt["LB_list"]) == np.argmax(rj["LB_list"])
    np.testing.assert_allclose(rt["LB_list"], rj["LB_list"], rtol=1e-9)
    np.testing.assert_allclose(rt["LB_doublet"], rj["LB_doublet"],
                               rtol=1e-9)
    for key in ("ID_prob", "doublet_prob", "GT_prob", "doublet_LLR"):
        np.testing.assert_allclose(rt[key], np.asarray(rj[key]), rtol=1e-9,
                                   atol=1e-12, err_msg=key)
    calls = [np.argmax(np.hstack([np.asarray(r["ID_prob"]),
                                  np.asarray(r["doublet_prob"])]), 1)
             for r in (rt, rj)]
    np.testing.assert_array_equal(calls[0], calls[1])
