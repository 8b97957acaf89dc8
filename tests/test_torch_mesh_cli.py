"""The port's `vireo` CLI on two ranks (`--mesh 1x2`), and checkpoints
on a mesh: rank 0 writes the global state, and every rank resumes from
it, a single-process file included.

Two spawned CPU ranks (gloo, float64) run the CLI and the checkpointed
runs; the single-process runs are made here. The 2-rank CLI writes the
single-process CLI's files, byte for byte.
"""

import gzip
import os

import numpy as np
import pytest
import torch

from test_torch_cli import _write_cellsnp, _read_table
from vireo_tpu_torch.cli import vireo_cli as tcli
from vireo_tpu_torch.engine import wrap as twrap
from vireo_tpu_torch.parallel.launch import MeshArg
from torch_rank_calls import run_calls

torch.set_num_threads(1)

F64 = torch.float64
KW = dict(n_donor=3, n_init=3, random_seed=23, dtype=F64, verbose=False)
WRAP = "vireo_tpu_torch.engine.wrap:vireo_wrap"


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIREO_PLATFORM", "cpu")
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("meshcli")
    d = _write_cellsnp(tmp / "cellsnp")
    common = ["-c", str(tmp / "cellsnp"), "-N", "3", "--nInit", "5",
              "--randSeed", "3", "--noPlot"]
    tcli.main(common + ["-o", str(tmp / "one")])
    # a single-process run's checkpoints, its refit step removed: a
    # mesh run resumes after its warm restarts
    twrap.vireo_wrap(d["AD"], d["DP"], checkpoint_dir=str(tmp / "ck0"),
                     mesh=None, **KW)
    for name in ("vireo_ckpt_00000001.npz", "rng_1.npz"):
        os.remove(tmp / "ck0" / name)
    m2 = MeshArg((2,))
    calls = [
        ("vireo_tpu_torch.cli.vireo_cli:main",
         (common + ["-o", str(tmp / "mesh"), "--mesh", "1x2"],), {}),
        (WRAP, (d["AD"], d["DP"]), dict(KW, checkpoint_dir=str(tmp / "ck"),
                                         mesh=m2)),
        (WRAP, (d["AD"], d["DP"]), dict(KW, checkpoint_dir=str(tmp / "ck"),
                                         mesh=m2)),
        (WRAP, (d["AD"], d["DP"]), dict(KW, checkpoint_dir=str(tmp / "ck0"),
                                         mesh=m2)),
    ]
    out = run_calls(calls, 2, str(tmp / "ranks"), timeout=300)
    return dict(tmp=tmp, out=out)


@pytest.mark.parametrize("name", [
    "donor_ids.tsv", "summary.tsv", "_log.txt", "prob_singlet.tsv.gz",
    "prob_doublet.tsv.gz", "GT_donors.vireo.vcf.gz"])
def test_two_rank_cli_writes_the_single_process_files(runs, name):
    """`--mesh 1x2` on two ranks: rank 0 writes each file of the
    single-process CLI, with the same content (the variants are not
    split, so each rank's cells get their whole log-likelihood and the
    probabilities come out equal)."""
    tmp = runs["tmp"]
    assert sorted(os.listdir(tmp / "mesh")) == sorted(os.listdir(tmp / "one"))
    read = gzip.open if name.endswith(".gz") else open
    with read(tmp / "mesh" / name, "rb") as fm, \
            read(tmp / "one" / name, "rb") as f1:
        assert fm.read() == f1.read()
    if name == "donor_ids.tsv":
        head, rows = _read_table(tmp / "mesh" / name)
        assert len(rows) == 400 and head[0] == "cell"


def test_mesh_checkpoints_are_global_and_written_once(runs):
    """Rank 0 writes the gathered state in the JAX package's format."""
    ck = runs["tmp"] / "ck"
    names = sorted(os.listdir(ck))
    assert names == ["rng_0.npz", "rng_1.npz", "vireo_ckpt_00000000.npz",
                     "vireo_ckpt_00000001.npz"]
    with np.load(ck / "vireo_ckpt_00000001.npz") as z:
        assert z["id_prob"].shape == (400, 3)
        assert z["gt_prob"].shape == (300, 3, 3)
        assert int(z["fp_n_cell"]) == 400


def test_mesh_resume_after_the_refit_equals_the_run(runs):
    """A rerun with the same arguments resumes after the refit and
    returns the uninterrupted run's dict, bit for bit, on every rank."""
    for rank_out in runs["out"]:
        full, resumed = rank_out[1], rank_out[2]
        assert set(full) == set(resumed)
        for key, v in full.items():
            if v is None:
                assert resumed[key] is None
            else:
                np.testing.assert_array_equal(resumed[key], v, err_msg=key)


def test_mesh_resumes_from_a_single_process_checkpoint(runs):
    """A mesh run resumes from a single-process run's warm checkpoint
    (every rank takes its block of the global file) and gives the
    uninterrupted mesh run's results: float64 to rtol 1e-9, the doublet
    phase (unfused) included."""
    full, resumed = runs["out"][0][1], runs["out"][0][3]
    for key in ("LB_list", "LB_doublet", "theta_mean", "theta_sum",
                "ID_prob", "doublet_prob", "GT_prob", "doublet_LLR"):
        np.testing.assert_allclose(resumed[key], full[key], rtol=1e-9,
                                   atol=1e-12, err_msg=key)
    assert (np.argmax(resumed["ID_prob"], 1)
            == np.argmax(full["ID_prob"], 1)).all()
