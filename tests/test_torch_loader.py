"""Per-rank input (vireo_tpu_torch.parallel.loader) against the JAX
package's loader, on a synthetic cellSNP folder of an odd cell count.

Two spawned CPU ranks (gloo, float64) each read their half of the
folder, build their int8 block (`dense_counts_from_local`) and their
packed block (`pack_scipy_sharded` over the loader's ranges), and run
vireo_wrap on each. Both runs are float64 throughout, the doublet phase
unfused (VIREO_FUSED_DOUBLET unset): the packed run (K2/K3's plain
versions) rtol 1e-9 against JAX's dense float64 run and the port's
single-device packed run; the int8 run (K0's plain version on each
rank's block) rtol 1e-9 against the port's single-device int8 run over
the same padded pool.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_cli import _write_cellsnp
from vireo_tpu.engine import wrap as jwrap
from vireo_tpu.ops.counts import dense_counts as jax_dense_counts
from vireo_tpu.parallel import loader as jloader
from vireo_tpu.parallel import mesh as jmesh
from vireo_tpu_torch.engine import wrap as twrap
from vireo_tpu_torch.ops import counts as tcounts
from vireo_tpu_torch.parallel import loader as tloader
from vireo_tpu_torch.parallel.launch import MeshArg
from torch_rank_calls import Ref, run_calls

torch.set_num_threads(1)

F64 = torch.float64
KW = dict(n_donor=3, n_init=3, random_seed=5, dtype=F64, verbose=False)
V, C = 220, 301


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIREO_PLATFORM", "cpu")
        yield


@pytest.mark.parametrize("n_cell,pid,n_proc", [
    (100, 2, 3), (100, 0, 1), (7, 3, 4), (301, 1, 2), (5, 3, 4)])
def test_process_cell_range_matches_jax(n_cell, pid, n_proc):
    assert tloader.process_cell_range(n_cell, pid, n_proc) == \
        jloader.process_cell_range(n_cell, pid, n_proc)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loader")
    d = _write_cellsnp(tmp / "cellsnp", V=V, C=C, seed=4)
    assert d["DP"].max() <= 15          # the packed rung's range
    m2 = MeshArg((2,))
    get = "operator:getitem"
    calls = [
        ("vireo_tpu_torch.parallel.loader:load_cellSNP_sharded",
         (str(tmp / "cellsnp"),), {}),
        (get, (Ref(0), 0), {}),                       # 1: cell_dat
        (get, (Ref(0), 1), {}),                       # 2: meta
        (get, (Ref(1), "AD"), {}),
        (get, (Ref(1), "DP"), {}),
        ("vireo_tpu_torch.parallel.loader:dense_counts_from_local",
         (m2, Ref(3), Ref(4), Ref(2)), {}),           # 5
        (Ref(5, "densify"), {}),
        ("vireo_tpu_torch.ops.packed:pack_scipy_sharded",
         (Ref(3), Ref(4), m2), dict(cell_range=Ref(2))),   # 7
        (Ref(7, "densify"), {}),
        ("vireo_tpu_torch.engine.wrap:vireo_wrap", (Ref(7),), KW),
        ("vireo_tpu_torch.engine.wrap:vireo_wrap", (Ref(5),), KW),
    ]
    out = run_calls(calls, 2, str(tmp / "ranks"), timeout=300)
    return dict(tmp=tmp, d=d, out=out)


@pytest.mark.parametrize("rank", [0, 1])
def test_each_rank_reads_its_columns_as_jax_does(ranks, rank):
    dat_t, meta_t = ranks["out"][rank][0]
    dat_j, meta_j = jloader.load_cellSNP_sharded(
        str(ranks["tmp"] / "cellsnp"), process_id=rank, n_processes=2)
    assert tuple(meta_t) == tuple(meta_j) == (
        (0, 151, 151, C) if rank == 0 else (151, C, 151, C))
    for key in ("AD", "DP"):
        assert (dat_t[key] != dat_j[key]).nnz == 0
        assert (dat_t[key] != ranks["d"][key].tocsc()[
            :, meta_t[0]:meta_t[1]]).nnz == 0
    assert list(dat_t["samples"]) == list(dat_j["samples"])


def test_dense_blocks_assemble_jax_s_padded_pool(ranks):
    """The ranks' int8 blocks, zero-padded to c_local cells each, form
    the pool that JAX's dense_counts_from_local assembles: 2 x 151 cells,
    the last one padding."""
    blocks = []
    for rank in (0, 1):
        dat, meta = ranks["out"][rank][0]
        j = jloader.dense_counts_from_local(jmesh.make_mesh(1), dat["AD"],
                                            dat["DP"], meta)
        blocks.append(np.asarray(j.ad))
    got = ranks["out"][0][6]
    assert got["ad"].dtype == np.int8 and got["ad"].shape == (V, 302)
    np.testing.assert_array_equal(got["ad"], np.concatenate(blocks, 1))
    np.testing.assert_array_equal(got["ad"][:, :C],
                                  ranks["d"]["AD"].toarray())
    assert not got["dp"][:, C:].any()


def test_packed_blocks_over_the_loader_ranges(ranks):
    got = ranks["out"][1][8]
    np.testing.assert_array_equal(got["ad"], ranks["d"]["AD"].toarray())
    np.testing.assert_array_equal(got["dp"], ranks["d"]["DP"].toarray())
    assert ranks["out"][0][7]["layout"]["cell_bounds"] == ((0, 151),
                                                           (151, C))


def test_packed_loader_run_matches_jax_and_one_device(ranks):
    d = ranks["d"]
    rt = ranks["out"][0][9]
    rj = jwrap.vireo_wrap(jax_dense_counts(d["AD"], d["DP"],
                                           dtype=jnp.float64), mesh=None,
                          n_donor=3, n_init=3, random_seed=5,
                          dtype=jnp.float64, verbose=False)
    one = twrap.vireo_wrap(tcounts.counts_from_scipy(
        d["AD"], d["DP"], device="cpu", dense_budget=V * C), mesh=None, **KW)
    for want in (rj, one):
        for key in ("LB_list", "LB_doublet", "theta_mean", "ID_prob",
                    "doublet_prob", "GT_prob", "doublet_LLR"):
            np.testing.assert_allclose(rt[key], np.asarray(want[key]),
                                       rtol=1e-9, atol=1e-12, err_msg=key)
    assert rt["ID_prob"].shape == (C, 3)


def test_int8_loader_run_matches_one_device(ranks):
    """The int8 blocks' pool has the padding cell (302 cells, as JAX's
    loader builds it): the single-device run over the same padded pool."""
    d = ranks["d"]
    rt = ranks["out"][1][10]
    pad = np.zeros((V, 1))
    AD = np.concatenate([d["AD"].toarray(), pad], 1)
    DP = np.concatenate([d["DP"].toarray(), pad], 1)
    one = twrap.vireo_wrap(tcounts.counts_from_scipy(AD, DP, device="cpu"),
                           mesh=None, **KW)
    for key in ("LB_list", "LB_doublet", "theta_mean", "ID_prob",
                "doublet_prob", "GT_prob", "doublet_LLR"):
        np.testing.assert_allclose(rt[key], one[key], rtol=1e-9, atol=1e-12,
                                   err_msg=key)
    assert rt["ID_prob"].shape == (302, 3)
