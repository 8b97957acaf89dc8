"""The port's vireo_wrap on a mesh against the JAX package's, case by
case as tests/test_sharding.py runs them, and the ambient phase on a
mesh.

Four spawned CPU ranks (gloo, float64) run every case at once, on a
2 x 2 vars x cells mesh and on a 4-rank cells mesh; JAX runs here on
the mesh of the same shape over its virtual devices. Every rank must
return the same result dict. Tolerances: the warm restarts, the refit
and the doublet phase (unfused on every mesh, as in the JAX package,
VIREO_FUSED_DOUBLET set or not) are float64 on both sides, rtol 1e-9.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from vireo_tpu.engine import wrap as jwrap
from vireo_tpu.ops.counts import counts_from_scipy as jax_counts_from_scipy
from vireo_tpu.ops.counts import dense_counts as jax_dense_counts
from vireo_tpu.ops.matching import optimal_match
from vireo_tpu.parallel import mesh as jmesh
from vireo_tpu_torch.engine import wrap as twrap
from vireo_tpu_torch.ops import counts as tcounts
from vireo_tpu_torch.parallel.launch import (MeshArg, results_agree,
                                             run_ranks)
from vireo_tpu_torch.sim.synth import synth_pool_counts
from torch_rank_calls import Ref, run_calls

F64 = torch.float64
RTOL = 1e-9
WRAP = "vireo_tpu_torch.engine.wrap:vireo_wrap"
ENV = "os:environ.__setitem__"
UNSET = "os:environ.pop"
TAKES_K1 = "vireo_tpu_torch.models.doublet:takes_fused_estep"


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIREO_PLATFORM", "cpu")
        yield


def _small_data():
    """conftest.py's small_data (60 variants x 40 cells, 3 donors)."""
    rng = np.random.RandomState(11)
    n_var, n_cell, n_donor = 60, 40, 3
    GT = rng.randint(0, 3, size=(n_var, n_donor))
    theta = np.array([0.02, 0.5, 0.98])
    donor = rng.randint(0, n_donor, size=n_cell)
    DP = (rng.rand(n_var, n_cell) < 0.25) * rng.poisson(
        3, size=(n_var, n_cell))
    p = theta[GT[:, donor]]
    AD = rng.binomial(DP.astype(int), p)
    return sp.csc_matrix(AD.astype(float)), sp.csc_matrix(DP.astype(float))


def _pools():
    """The pools of the cases: small_data; test_sharding.py's int8
    end-to-end, packed and 2-D election pools; an ambient pool."""
    AD, DP = _small_data()
    int8 = synth_pool_counts(n_var=200, n_cell=1600, n_donor=4,
                             doublet_rate=0.06, density=0.3,
                             mean_extra_depth=2.0, seed=5)
    packed = synth_pool_counts(n_var=300, n_cell=500, n_donor=3,
                               density=0.2, seed=1)
    DPd = np.minimum(np.asarray(packed["DP"].todense()), 15.0)
    ADd = np.minimum(np.asarray(packed["AD"].todense()), DPd)
    elect = synth_pool_counts(n_var=512, n_cell=128, n_donor=4, density=0.4,
                              mean_extra_depth=2.0, seed=5)
    amb = synth_pool_counts(n_var=220, n_cell=300, n_donor=3,
                            doublet_rate=0.1, density=0.15, seed=4)
    return dict(small=(AD, DP), int8=int8, packed=(ADd, DPd),
                elect=elect, ambient=amb)


KW = dict(learn_GT=True, check_doublet=True, dtype=F64, verbose=False)
JKW = dict(learn_GT=True, check_doublet=True, dtype=jnp.float64,
           verbose=False)
ELECT_KW = dict(n_donor=4, n_init=16, random_seed=17)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pools = _pools()
    m22, m4 = MeshArg((2, 2)), MeshArg((4,))
    AD, DP = pools["small"]
    d8 = pools["int8"]
    ADd, DPd = pools["packed"]
    el = pools["elect"]
    amb = pools["ambient"]
    calls = [
        # 0: the 1-D mesh, float64 dense counts placed on it
        (WRAP, (tcounts.dense_counts(AD, DP, dtype=F64, device="cpu"),),
         dict(KW, n_donor=3, n_init=3, random_seed=23, mesh=m4)),
        # 1: the 2-D mesh, 37 cells padded to the cell shards
        (WRAP, (AD[:, :37], DP[:, :37]),
         dict(KW, n_donor=3, n_init=3, random_seed=23, mesh=m22)),
        # 2: a prebuilt single-device int8 pool, cut into the mesh's
        # blocks
        ("vireo_tpu_torch.ops.counts:counts_from_scipy",
         (d8["AD"], d8["DP"]), dict(device="cpu")),
        (WRAP, (Ref(2),), dict(KW, n_donor=4, n_init=4, random_seed=11,
                               mesh=m4)),
        # 4-5: the packed rung on the mesh
        ("vireo_tpu_torch.ops.packed:pack_scipy_sharded",
         (sp.csr_matrix(ADd), sp.csr_matrix(DPd), m4), {}),
        (WRAP, (Ref(4),), dict(KW, n_donor=3, n_init=3, random_seed=7)),
        # 6-12: the automatic 2-D election under a small device budget
        (ENV, ("VIREO_MESH_MIN_CELLS", "64"), {}),
        (ENV, ("VIREO_DENSE_BUDGET_GB", repr(0.5 / 1024)), {}),
        ("vireo_tpu_torch.engine.wrap:_auto_mesh_hints",
         (el["AD"], el["DP"], 4, None, 0, 16, 3, F64), {}),
        (WRAP, (el["AD"], el["DP"]), dict(KW, mesh="auto", **ELECT_KW)),
        (ENV, ("VIREO_DENSE_BUDGET_GB", "16"), {}),
        ("vireo_tpu_torch.engine.wrap:_resolve_mesh", ("auto", 128),
         dict(count_bytes=1e6, var_state_bytes=1e6)),
        (UNSET, ("VIREO_DENSE_BUDGET_GB",), {}),
        # 13: the ambient phase on the 2-D mesh
        (WRAP, (amb["AD"], amb["DP"]),
         dict(KW, n_donor=3, n_init=3, random_seed=5, check_ambient=True,
              mesh=m22)),
        # 14-17: whether a mesh takes the doublet phase through K1
        ("vireo_tpu_torch.ops.counts:counts_from_scipy", (AD, DP),
         dict(mesh=m4)),
        (TAKES_K1, (Ref(14), 10, True), {}),
        ("vireo_tpu_torch.ops.counts:counts_from_scipy", (AD, DP),
         dict(mesh=m22)),
        (TAKES_K1, (Ref(16), 10, True), {}),
        # 18-22: the same under VIREO_FUSED_DOUBLET=1, and call 3 under it
        (ENV, ("VIREO_FUSED_DOUBLET", "1"), {}),
        (TAKES_K1, (Ref(14), 10, True), {}),
        (TAKES_K1, (Ref(16), 10, True), {}),
        (WRAP, (Ref(2),), dict(KW, n_donor=4, n_init=4, random_seed=11,
                               mesh=m4)),
        (UNSET, ("VIREO_FUSED_DOUBLET",), {}),
    ]
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("VIREO_FUSED_DOUBLET", raising=False)
        out = run_calls(calls, 4, str(tmp_path_factory.mktemp("wrap4")),
                        timeout=400)
    whole = (0, 1, 3, 5, 8, 9, 13, 15, 17, 19, 20, 21)
    assert [i for i in whole if not results_agree([o[i] for o in out])] \
        == []
    return dict(pools, out=out)


def _same_result(rt, rj):
    """A port result dict against JAX's: float64 throughout."""
    assert set(rt) == set(rj)
    assert np.argmax(rt["LB_list"]) == np.argmax(rj["LB_list"])
    for key in ("LB_list", "LB_doublet", "theta_mean", "theta_sum",
                "theta_shapes"):
        np.testing.assert_allclose(rt[key], np.asarray(rj[key]), rtol=RTOL,
                                   err_msg=key)
    for key in ("ID_prob", "doublet_prob", "GT_prob", "doublet_LLR"):
        assert rt[key].shape == np.asarray(rj[key]).shape, key
        np.testing.assert_allclose(rt[key], np.asarray(rj[key]),
                                   rtol=RTOL, atol=1e-12, err_msg=key)
    assert (np.argmax(rt["ID_prob"], 1)
            == np.argmax(np.asarray(rj["ID_prob"]), 1)).all()


def test_vireo_wrap_on_mesh(runs):
    """test_sharding.py::test_vireo_wrap_on_mesh: the wrap on a cells
    mesh (float64 dense counts, so the doublet phase is unfused on both
    sides) equals JAX's on make_mesh(4)."""
    AD, DP = runs["small"]
    rj = jwrap.vireo_wrap(AD, DP, mesh=jmesh.make_mesh(4), n_donor=3,
                          n_init=3, random_seed=23, **JKW)
    _same_result(runs["out"][0][0], rj)


def test_vireo_wrap_on_mesh2d(runs):
    """test_sharding.py::test_vireo_wrap_on_mesh2d: 37 cells padded to
    the two cell shards, the padding dropped from every output; the
    doublet phase unfused on the vars axis."""
    AD, DP = runs["small"]
    rj = jwrap.vireo_wrap(AD[:, :37], DP[:, :37],
                          mesh=jmesh.make_mesh2d(2, 2), n_donor=3, n_init=3,
                          random_seed=23, **JKW)
    rt = runs["out"][0][1]
    assert rt["ID_prob"].shape == (37, 3)
    _same_result(rt, rj)


def test_wrap_int8_cells_mesh_runs_k1_per_rank(runs, monkeypatch):
    """test_sharding.py::test_wrap_auto_mesh_int8_end_to_end: a
    single-device int8 pool cut into a 4-rank mesh's blocks. The whole
    run, the doublet phase included (unfused on a mesh, as in the JAX
    package), equals JAX's on make_mesh(4) (rtol 1e-9); the calls
    recover the simulation."""
    d = runs["int8"]
    jc = jax_counts_from_scipy(d["AD"], d["DP"], max_dense_elems=10)
    assert jc.ad.dtype == jnp.int8
    monkeypatch.delenv("VIREO_FUSED_DOUBLET", raising=False)
    rj = jwrap.vireo_wrap(jc, mesh=jmesh.make_mesh(4), n_donor=4, n_init=4,
                          random_seed=11, **JKW)
    rt = runs["out"][0][3]
    _same_result(rt, rj)
    from scipy.optimize import linear_sum_assignment
    singlet = d["donor2"] < 0
    conf = np.zeros((4, 4))
    np.add.at(conf, (d["donor"][singlet],
                     np.argmax(rt["ID_prob"], 1)[singlet]), 1)
    ri, ci = linear_sum_assignment(-conf)
    assert conf[ri, ci].sum() / singlet.sum() > 0.95


@pytest.mark.parametrize("mesh,knob,call", [
    ("cells", None, 15),
    ("vars x cells", None, 17),
    ("cells", "1", 19),
    ("vars x cells", "1", 20),
])
def test_doublet_dispatch_on_meshes(runs, mesh, knob, call):
    """takes_fused_estep on each rank: no mesh's blocks go to K1, the
    knob set or not, as the JAX package keeps its kernel off a mesh."""
    assert all(o[call] is False for o in runs["out"])


def test_doublet_takes_k1_on_a_cells_mesh_only(runs, monkeypatch):
    """VIREO_FUSED_DOUBLET=1 moves the int8 pool's doublet phase to K1
    on one device (its bf16 rounding moves the calls' probabilities) and
    leaves the same pool on a cells mesh unfused: that run is the
    default's bit for bit."""
    d = runs["int8"]
    default, knob = runs["out"][0][3], runs["out"][0][21]
    assert set(knob) == set(default)
    for key in default:
        np.testing.assert_array_equal(knob[key], default[key], err_msg=key)
    monkeypatch.setenv("VIREO_FUSED_DOUBLET", "1")
    one = twrap.vireo_wrap(tcounts.counts_from_scipy(d["AD"], d["DP"],
                                                     device="cpu"),
                           n_donor=4, n_init=4, random_seed=11, mesh=None,
                           **KW)
    assert np.abs(one["doublet_prob"] - default["doublet_prob"]).max() \
        > 1e-9


def test_vireo_wrap_on_mesh_packed(runs):
    """test_sharding.py::test_vireo_wrap_on_mesh_packed: the whole wrap
    on a MeshPackedCounts (K2/K3's plain versions on each rank's block,
    the doublet phase unfused) equals JAX's dense float64 wrap on
    make_mesh(4)."""
    ADd, DPd = runs["packed"]
    rj = jwrap.vireo_wrap(jax_dense_counts(ADd, DPd, dtype=jnp.float64),
                          mesh=jmesh.make_mesh(4), n_donor=3, n_init=3,
                          random_seed=7, **JKW)
    _same_result(runs["out"][0][5], rj)


def test_auto_mesh_elects_2d_when_var_state_busts_budget(runs):
    """test_sharding.py::test_auto_mesh_elects_2d_when_var_state_busts_
    budget: under a 0.5 MiB budget a rank's count block plus the whole
    warm genotype batch does not fit, splitting the variants two ways
    does, so "auto" elects the 2 x 2 mesh on four ranks; the run equals
    JAX's on make_mesh2d(2, 2). With 16 GiB it stays a cells mesh."""
    el = runs["elect"]
    out = runs["out"]
    count_bytes, var_bytes = out[0][8]
    budget = 0.5 * 2**20
    assert count_bytes / 4 + var_bytes > budget
    assert count_bytes / 4 + var_bytes / 2 <= budget
    rj = jwrap.vireo_wrap(el["AD"], el["DP"], mesh=jmesh.make_mesh2d(2, 2),
                          **ELECT_KW, **JKW)
    _same_result(out[0][9], rj)
    for rank_out in out:
        assert rank_out[11]["shape"] == {"cells": 4}


def test_auto_mesh_election_picks_2x2(tmp_path):
    """The election itself: the hints of the case above give the 2 x 2
    mesh on four ranks, every rank alike."""
    el = _pools()["elect"]
    hints = twrap._auto_mesh_hints(el["AD"], el["DP"], 4, None, 0, 16, 3,
                                   F64)
    calls = [(ENV, ("VIREO_DENSE_BUDGET_GB", repr(0.5 / 1024)), {}),
             ("vireo_tpu_torch.engine.wrap:_resolve_mesh", ("auto", 128),
              dict(count_bytes=hints[0], var_state_bytes=hints[1]))]
    import os
    env = dict(os.environ)
    os.environ["VIREO_MESH_MIN_CELLS"] = "64"
    try:
        out = run_calls(calls, 4, str(tmp_path), timeout=120)
    finally:
        os.environ.clear()
        os.environ.update(env)
    assert [o[1]["shape"] for o in out] == [{"vars": 2, "cells": 2}] * 4


def test_ambient_on_mesh2d(runs):
    """--callAmbientRNAs on a 2 x 2 mesh: the SNP gate from the
    all-reduced statistics, the selected blocks gathered, every rank
    running the EM; psi, its variance and the LLR equal JAX's run on
    make_mesh2d(2, 2) in float64."""
    amb = runs["ambient"]
    rj = jwrap.vireo_wrap(amb["AD"], amb["DP"], mesh=jmesh.make_mesh2d(2, 2),
                          n_donor=3, n_init=3, random_seed=5,
                          check_ambient=True, **JKW)
    rt = runs["out"][0][13]
    _same_result(rt, rj)
    for key in ("ambient_Psi", "Psi_var", "Psi_LLRatio"):
        assert rt[key].shape[0] == 300
        np.testing.assert_allclose(rt[key], np.asarray(rj[key]), rtol=RTOL,
                                   atol=1e-9, err_msg=key)


def test_vireo_wrap_mesh_spec_string(tmp_path):
    """mesh="1x2" in vireo_wrap resolves the 2-D mesh (make_mesh2d(1, 2))
    and gives the single-device result."""
    AD, DP = _small_data()
    out = run_ranks(WRAP, 2, args=(AD, DP),
                    kwargs=dict(KW, n_donor=3, n_init=2, random_seed=1,
                                mesh="1x2"),
                    workdir=str(tmp_path), device="cpu", timeout=120)
    one = twrap.vireo_wrap(AD, DP, n_donor=3, n_init=2, random_seed=1,
                           mesh=None, **KW)
    _, perm = optimal_match(one["GT_prob"], out[0]["GT_prob"], axis=1)
    np.testing.assert_array_equal(perm, np.arange(3))
    for key in ("LB_list", "ID_prob", "doublet_prob", "doublet_LLR"):
        np.testing.assert_allclose(out[0][key], one[key], rtol=RTOL,
                                   atol=1e-12, err_msg=key)
