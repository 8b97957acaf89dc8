"""The port's mesh (vireo_tpu_torch.parallel.mesh) against the JAX
package's, case by case as tests/test_sharding.py runs them: the fits
and the counts on the mesh.

The port runs in spawned CPU ranks (gloo, float64) through the
package's launcher; JAX runs here on 2 or 4 of conftest's 8 virtual
devices, on the mesh of the same shape. Each spawn runs every case of
its mesh at once, and every rank must return the same results.
Tolerances: iteration counts identical; ELBOs and states rtol 1e-9
(float64 sums in another order).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from vireo_tpu.models import vireo as jvireo
from vireo_tpu.ops.counts import dense_counts as jax_dense_counts
from vireo_tpu.parallel import mesh as jmesh
from vireo_tpu_torch.engine import wrap as twrap
from vireo_tpu_torch.models import vireo as tvireo
from vireo_tpu_torch.ops import counts as tcounts
from vireo_tpu_torch.parallel import mesh as tmesh
from vireo_tpu_torch.parallel.launch import MeshArg, results_agree
from torch_rank_calls import Ref, run_calls

F64 = torch.float64
RTOL = 1e-9
FIT = "vireo_tpu_torch.parallel.mesh:"
ENV = "os:environ.__setitem__"
UNSET = "os:environ.pop"


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


def _states(cfg_kw, seed, n=None):
    """The port's and JAX's init states (and default priors) from one
    seeded stream each, float64; `n` restarts stacked."""
    tc, jc = tvireo.VireoConfig(**cfg_kw), jvireo.VireoConfig(**cfg_kw)
    rt, rj = np.random.RandomState(seed), np.random.RandomState(seed)
    if n is None:
        ts = tvireo.init_state(tc, rng=rt, dtype=F64, device="cpu")
        js = jvireo.init_state(jc, rng=rj, dtype=jnp.float64)
    else:
        ts = [tvireo.init_state(tc, rng=rt, dtype=F64, device="cpu")
              for _ in range(n)]
        ts = tvireo.VireoState(*(torch.stack([getattr(s, f) for s in ts])
                                 for f in ("beta_mu", "beta_sum", "gt_prob",
                                           "id_prob")))
        js = [jvireo.init_state(jc, rng=rj, dtype=jnp.float64)
              for _ in range(n)]
        js = jax.tree.map(lambda *xs: jnp.stack(xs), *js)
    return (tc, ts, tvireo.default_priors(tc, dtype=F64, device="cpu"),
            jc, js, jvireo.default_priors(jc, dtype=jnp.float64))


def _fit_matches(t, j, fields=("id_prob", "gt_prob", "beta_mu", "beta_sum")):
    """A port FitResult (host dict) against a JAX FitResult."""
    np.testing.assert_array_equal(np.asarray(t["n_iter"]),
                                  np.asarray(j.n_iter))
    for key in ("elbo_final", "elbo_ref"):
        np.testing.assert_allclose(t[key], np.asarray(getattr(j, key)),
                                   rtol=RTOL, err_msg=key)
    for f in fields:
        want = np.asarray(getattr(j.state, f))
        got = t["state"][f][..., :want.shape[-2], :] if f == "id_prob" \
            else t["state"][f]
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12,
                                   err_msg=f)


# ---------------------------------------------------------------------
# two ranks, a cells mesh
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def cells2(tmp_path_factory):
    """The 1-D cases on two ranks: the COO and dense shard paths,
    fit_vb_auto and both layouts of warm_restarts_auto."""
    AD, DP = _small_data()
    V, C = AD.shape
    mesh = MeshArg((2,))
    arrays, meta = tmesh.build_cell_sharded_coo(AD, DP, 2, dtype=np.float64,
                                                pad_multiple=32)
    ad_d, dp_d, meta_d = tmesh.build_cell_sharded_dense(AD, DP, 2,
                                                        dtype=np.float64)
    pad = _states(dict(n_var=V, n_cell=meta["n_cell_pad"], n_donor=3), 2)
    one = _states(dict(n_var=V, n_cell=C, n_donor=3), 2)
    warm = _states(dict(n_var=V, n_cell=C, n_donor=3), 4, n=4)
    rest = _states(dict(n_var=V, n_cell=C, n_donor=3), 0, n=8)
    dense = tcounts.dense_counts(AD, DP, dtype=F64, device="cpu")
    fit = dict(max_iter=15, min_iter=3)
    calls = [
        (FIT + "sharded_fit_vb", (mesh, arrays, meta) + pad[1:3] + pad[:1],
         fit),
        (FIT + "fit_vb_auto", (mesh, dense, one[1], one[2], one[0]), fit),
        (FIT + "warm_restarts_auto", (mesh, dense, warm[1], warm[2],
                                      warm[0]), dict(max_iter=10, min_iter=3)),
        (FIT + "warm_restarts_auto", (mesh, dense, rest[1], rest[2],
                                      rest[0]),
         dict(shard_axis="restarts", max_iter=10, min_iter=5)),
        (FIT + "sharded_fit_vb_dense", (mesh, ad_d, dp_d, meta_d)
         + pad[1:3] + pad[:1], fit),
    ]
    out = run_calls(calls, 2, str(tmp_path_factory.mktemp("cells2")),
                    timeout=300)
    assert results_agree(out)
    return dict(AD=AD, DP=DP, out=out[0], pad=pad, one=one, warm=warm,
                rest=rest, arrays=arrays, meta=meta)


def test_sharded_coo_path_matches_jax(cells2):
    """test_sharding.py::test_sharded_matches_single_device: the COO
    chunks of build_cell_sharded_coo, equal to JAX's."""
    AD, DP = cells2["AD"], cells2["DP"]
    j_arrays, j_meta = jmesh.build_cell_sharded_coo(
        AD, DP, n_shards=2, dtype=np.float64, pad_multiple=32)
    assert j_meta == cells2["meta"]
    for k, v in j_arrays.items():
        np.testing.assert_array_equal(cells2["arrays"][k], v, err_msg=k)
    _, _, _, jc, js, jp = cells2["pad"]
    j = jmesh.sharded_fit_vb(jmesh.make_mesh(2), j_arrays, j_meta, js, jp,
                             jc, max_iter=15, min_iter=3)
    _fit_matches(cells2["out"][0], j)


def test_fit_vb_auto_matches_jax(cells2):
    """test_sharding.py::test_auto_sharded_dense."""
    _, _, _, jc, js, jp = cells2["one"]
    jcounts = jax_dense_counts(cells2["AD"], cells2["DP"], dtype=jnp.float64)
    j = jmesh.fit_vb_auto(jmesh.make_mesh(2), jcounts, js, jp, jc,
                          max_iter=15, min_iter=3)
    _fit_matches(cells2["out"][1], j)


@pytest.mark.parametrize("layout", ["cells", "restarts"])
def test_warm_restarts_auto_matches_jax(cells2, layout):
    """test_sharding.py::test_warm_restarts_auto (cells) and
    ::test_warm_restarts_sharded_restarts (restarts): every restart's
    iterations, ELBOs and state."""
    name, call, kw = {"cells": ("warm", 2, dict(max_iter=10, min_iter=3)),
                      "restarts": ("rest", 3,
                                   dict(max_iter=10, min_iter=5))}[layout]
    _, _, _, jc, js, jp = cells2[name]
    jcounts = jax_dense_counts(cells2["AD"], cells2["DP"], dtype=jnp.float64)
    j = jmesh.warm_restarts_auto(jmesh.make_mesh(2), jcounts, js, jp, jc,
                                 shard_axis=layout, **kw)
    _fit_matches(cells2["out"][call], j)


def test_dense_shard_path_matches_jax(cells2):
    """test_sharding.py::test_dense_sharded_matches_single_device."""
    ad, dp, meta = jmesh.build_cell_sharded_dense(
        cells2["AD"], cells2["DP"], 2, dtype=np.float64)
    _, _, _, jc, js, jp = cells2["pad"]
    j = jmesh.sharded_fit_vb_dense(jmesh.make_mesh(2), ad, dp, meta, js, jp,
                                   jc, max_iter=15, min_iter=3)
    _fit_matches(cells2["out"][4], j)


# ---------------------------------------------------------------------
# four ranks: a 2 x 2 mesh and a cells mesh
# ---------------------------------------------------------------------

def _clipped(AD, DP):
    """The pool with every count clipped into a nibble (the packed
    rung's range)."""
    DPd = np.minimum(np.asarray(DP.todense()), 15.0)
    ADd = np.minimum(np.asarray(AD.todense()), DPd)
    return ADd, DPd


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    """The 2-D fits, the packed rung and the ladder on four ranks, and
    `_resolve_mesh` under its environment variables."""
    AD, DP = _small_data()
    V, C = AD.shape
    m22, m4 = MeshArg((2, 2)), MeshArg((4,))
    dense = tcounts.dense_counts(AD, DP, dtype=F64, device="cpu")
    two_d = _states(dict(n_var=V, n_cell=C, n_donor=3), 2)
    ase = _states(dict(n_var=V, n_cell=C, n_donor=3, ASE_mode=True), 3)
    ADd, DPd = _clipped(AD, DP)
    ADs, DPs = sp.csr_matrix(ADd), sp.csr_matrix(DPd)
    packed_st = _states(dict(n_var=V, n_cell=C, n_donor=3), 4)
    n = V * C
    calls = [
        # 0-1: fit_vb_auto on the 2 x 2 mesh, without and with ASE
        (FIT + "fit_vb_auto", (m22, dense, two_d[1], two_d[2], two_d[0]),
         dict(max_iter=15, min_iter=3)),
        (FIT + "fit_vb_auto", (m22, dense, ase[1], ase[2], ase[0]),
         dict(max_iter=10, min_iter=3)),
        # 2-8: the packed rung on a cells mesh (MeshPackedCounts)
        ("vireo_tpu_torch.ops.packed:pack_scipy_sharded", (ADs, DPs, m4), {}),
        (Ref(2, "densify"), {}),
        (Ref(2, "binom_coeff_sum"), {}),
        (Ref(2, "n_vars_per_cell"), {}),
        (Ref(2, "row_sums"), {}),
        (FIT + "fit_sharded", (Ref(2),) + packed_st[1:3] + packed_st[:1],
         dict(max_iter=15, min_iter=3)),
        (Ref(2, "var_subset"), (np.array([2, 0, 7]),), {}),
        (Ref(8, "densify"), {}),
        # 10-11: the ladder's packed rung on the mesh
        ("vireo_tpu_torch.ops.counts:counts_from_scipy", (ADs, DPs),
         dict(dense_budget=1.5 * n, mesh=m4)),
        (Ref(10, "densify"), {}),
        # 12-16: the dense budget aggregates over the mesh's ranks
        (ENV, ("VIREO_DENSE_BUDGET_GB", repr(1.5 * n / 2**30)), {}),
        ("vireo_tpu_torch.ops.counts:counts_from_scipy", (AD, DP),
         dict(mesh=m4)),
        ("vireo_tpu_torch.ops.counts:counts_from_scipy", (AD, DP),
         dict(device="cpu")),
        ("vireo_tpu_torch.ops.counts:_shard_factor", (m4,), {}),
        (UNSET, ("VIREO_DENSE_BUDGET_GB",), {}),
        # 17-26: _resolve_mesh's gates and environment
        (ENV, ("VIREO_MESH_MIN_CELLS", "1000"), {}),
        ("vireo_tpu_torch.engine.wrap:_resolve_mesh", ("auto", 500), {}),
        ("vireo_tpu_torch.engine.wrap:_resolve_mesh", ("auto", 2000), {}),
        ("vireo_tpu_torch.engine.wrap:_resolve_mesh", (None, 2000), {}),
        (ENV, ("VIREO_MESH", "off"), {}),
        ("vireo_tpu_torch.engine.wrap:_resolve_mesh", ("auto", 2000), {}),
        (UNSET, ("VIREO_MESH",), {}),
        (ENV, ("VIREO_MESH_SHAPE", "2x2"), {}),
        ("vireo_tpu_torch.engine.wrap:_resolve_mesh", ("auto", 1000), {}),
        (UNSET, ("VIREO_MESH_SHAPE",), {}),
        # 27-28: the packed rung's cells' variant counts, gathered
        ("builtins:getattr", (Ref(2), "layout"), {}),
        (Ref(27, "gather"), (Ref(5), "cells", 0), {}),
        # 29-31: the dense rung on a 2 x 2 mesh from 39 cells (one padded
        # cell), each rank's block placed directly; its layout's ranges
        ("vireo_tpu_torch.ops.counts:counts_from_scipy",
         (AD[:, :39], DP[:, :39]), dict(mesh=m22)),
        ("builtins:getattr", (Ref(29, "layout"), "vars"), {}),
        ("builtins:getattr", (Ref(29, "layout"), "cells"), {}),
    ]
    out = run_calls(calls, 4, str(tmp_path_factory.mktemp("ranks4")),
                    timeout=300)
    # the results every rank holds whole (not its block, mesh or counts)
    whole = (0, 1, 3, 4, 6, 7, 9, 11, 28)
    assert [i for i in whole if not results_agree([o[i] for o in out])] \
        == []
    return dict(AD=AD, DP=DP, out=out, two_d=two_d, ase=ase, ADd=ADd,
                DPd=DPd, packed_st=packed_st)


@pytest.mark.parametrize("case", ["plain", "ase"])
def test_mesh2d_fit_matches_jax(ranks4, case):
    """test_sharding.py::test_mesh2d_fit_parity and ::_ase: fit_vb_auto
    on a 2 x 2 vars x cells mesh, the genotypes (and in ASE mode the
    thetas) split over the variants, against JAX's on make_mesh2d(2, 2)."""
    call, st, kw = {"plain": (0, "two_d", dict(max_iter=15, min_iter=3)),
                    "ase": (1, "ase", dict(max_iter=10, min_iter=3))}[case]
    _, _, _, jc, js, jp = ranks4[st]
    jcounts = jax_dense_counts(ranks4["AD"], ranks4["DP"], dtype=jnp.float64)
    j = jmesh.fit_vb_auto(jmesh.make_mesh2d(2, 2), jcounts, js, jp, jc, **kw)
    for rank_out in ranks4["out"]:
        _fit_matches(rank_out[call], j)
    if case == "ase":
        assert ranks4["out"][0][call]["state"]["beta_mu"].shape == (60, 3)


def test_mesh_packed_parity(ranks4):
    """test_sharding.py::test_mesh_packed_parity: the packed rung split
    over four ranks densifies to the counts, reduces as one device, fits
    as JAX's dense float64 fit from the same init, and keeps a variant
    subset packed."""
    out = ranks4["out"][0]
    ADd, DPd = ranks4["ADd"], ranks4["DPd"]
    np.testing.assert_array_equal(out[3]["ad"], ADd)
    np.testing.assert_array_equal(out[3]["dp"], DPd)
    single = tcounts.counts_from_scipy(ADd, DPd, device="cpu",
                                       dense_budget=ADd.size)
    assert type(single).__name__ == "PackedCounts"
    np.testing.assert_allclose(out[4], float(single.binom_coeff_sum()),
                               rtol=1e-12)
    np.testing.assert_array_equal(out[28], single.n_vars_per_cell().numpy())
    for got, want in zip(out[6], single.row_sums()):
        np.testing.assert_array_equal(got, want.numpy())
    _, _, _, jc, js, jp = ranks4["packed_st"]
    j = jvireo.fit_vb(jax_dense_counts(ADd, DPd, dtype=jnp.float64), js, jp,
                      jc, max_iter=15, min_iter=3)
    _fit_matches(out[7], j)
    np.testing.assert_array_equal(out[9]["ad"], ADd[[2, 0, 7]])


def test_counts_from_scipy_packed_on_mesh(ranks4):
    """test_sharding.py::test_counts_from_scipy_packed_on_mesh: the
    ladder's packed rung on a mesh gives a MeshPackedCounts."""
    out = ranks4["out"][0]
    assert out[10]["layout"]["mesh"]["shape"] == {"cells": 4}
    assert set(out[10]["local"]) == {"ad_p", "dp_p", "shape"}
    np.testing.assert_array_equal(out[11]["ad"], ranks4["ADd"])


def test_ladder_budget_aggregates_across_mesh(ranks4):
    """test_sharding.py::test_ladder_budget_aggregates_across_mesh: a
    per-rank budget too small for two int8 matrices, whose four-rank
    aggregate fits them: the mesh gets the dense rung, one rank not."""
    out = ranks4["out"]
    assert out[0][15] == 4 and tcounts._shard_factor(None) == 1
    assert tcounts._packed_shard_factor(None) == 1
    for rank_out in out:
        assert set(rank_out[13]["local"]) == {"ad", "dp", "row_chunk"}
        assert rank_out[13]["local"]["ad"].dtype == np.int8
        assert set(rank_out[14]) == {"ad_p", "dp_p", "shape"}   # packed


def test_mesh_dense_block_placed_directly_equals_the_union_block(ranks4):
    """A rank's dense block, placed from each matrix's own block without
    a union of the patterns, holds the cut block of the host's dense
    arrays bit for bit in int8, its padded cell zero."""
    AD, DP = ranks4["AD"][:, :39], ranks4["DP"][:, :39]
    blocks = set()
    for rank_out in ranks4["out"]:
        (v0, v1), (c0, c1) = rank_out[30], rank_out[31]
        blocks.add((v0, c0))
        local = rank_out[29]["local"]
        assert rank_out[29]["layout"]["shape"] == (60, 40)
        for got, X in ((local["ad"], AD), (local["dp"], DP)):
            want = np.zeros((v1 - v0, c1 - c0))
            cut = (X.toarray() if sp.issparse(X) else X)[v0:v1, c0:c1]
            want[:, :cut.shape[1]] = cut
            assert got.dtype == np.int8
            np.testing.assert_array_equal(got, want)
        if c1 > 39:
            assert not local["ad"][:, 39 - c0:].any()
    assert blocks == {(0, 0), (0, 20), (30, 0), (30, 20)}


@pytest.mark.parametrize("call,want", [
    (18, None), (19, {"cells": 4}), (20, None), (22, None),
    (25, {"vars": 2, "cells": 2})])
def test_resolve_mesh_gates_and_env(ranks4, call, want):
    """test_sharding.py::test_resolve_mesh_gates and
    ::test_resolve_mesh_shape_env: VIREO_MESH_MIN_CELLS=1000 keeps a
    500-cell pool on one rank and splits a 2000-cell one; mesh=None and
    VIREO_MESH=off give none; VIREO_MESH_SHAPE=2x2 the 2-D mesh."""
    for rank, rank_out in enumerate(ranks4["out"]):
        got = rank_out[call]
        if want is None:
            assert got is None
        else:
            assert got["shape"] == want
    assert ranks4["out"][3][25]["coords"] == {"vars": 1, "cells": 1}


def test_resolve_mesh_without_a_process_group():
    """With no process group, "auto" gives no mesh, and a VxC mesh
    raises naming the launcher."""
    assert twrap._resolve_mesh("auto", 10 ** 6) is None
    assert twrap._resolve_mesh("off", 10 ** 6) is None
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        twrap._resolve_mesh("2x2", 10 ** 6)


def test_auto_mesh_hints_use_prior_donor_width():
    """test_sharding.py::test_auto_mesh_hints_use_prior_donor_width, and
    the hints equal JAX's."""
    from vireo_tpu.engine.wrap import _auto_mesh_hints as jhints
    AD, DP = _small_data()
    gp = np.random.RandomState(0).rand(AD.shape[0], 16, 3)
    _, vs_prior = twrap._auto_mesh_hints(AD, DP, 8, gp, 0, 10, 3,
                                         torch.float32)
    _, vs_plain16 = twrap._auto_mesh_hints(AD, DP, 16, None, 0, 10, 3,
                                           torch.float32)
    _, vs_plain8 = twrap._auto_mesh_hints(AD, DP, 8, None, 0, 10, 3,
                                          torch.float32)
    assert vs_prior == vs_plain16 == 2 * vs_plain8
    assert twrap._auto_mesh_hints(AD, DP, 8, gp, 1, 10, 3, torch.float64) \
        == jhints(AD, DP, 8, gp, 1, 10, 3, jnp.float64)


def test_count_spec_and_shards():
    """count_spec and n_cell_shards read a mesh's axes as JAX's do."""
    class FakeMesh:
        def __init__(self, shape):
            self.shape = shape

        def has(self, axis):
            return axis in self.shape

        def extent(self, axis):
            return self.shape.get(axis, 1)

    assert tmesh.count_spec(FakeMesh({"cells": 4})) == (None, "cells")
    assert tmesh.count_spec(FakeMesh({"vars": 2, "cells": 2})) == (
        "vars", "cells")
    assert tmesh.n_cell_shards(FakeMesh({"vars": 2, "cells": 3})) == 3
    assert tmesh.shard_bounds(10, 4) == ((0, 3), (3, 6), (6, 9), (9, 10))
    assert tmesh.shard_bounds(3, 4) == ((0, 1), (1, 2), (2, 3), (3, 3))
