"""The port's `vireo` CLI against the JAX CLI on a synthetic cellSNP
folder, and the port's import boundary.

The JAX CLI places a small pool as float32 and takes the unfused
doublet branch; the port runs float64 on the CPU with int8 counts and
K1's plain version (bf16-rounded weights) in the doublet phase. So the
calls must be identical, while the printed numbers agree within the
bf16 rounding of the doublet weights. That rounding moves a pair's
log-likelihood by up to ~0.2 at this coverage, which moves a
probability p by at most p(1-p)*0.2 <= 0.05: probabilities atol 5e-2,
the log-likelihood ratio rtol 5e-2 (atol 0.5). `best_doublet` is
compared where the JAX run's best pair leads the next by more than
0.25 in log-probability; nearer ties may be reordered. The data seed is
picked so that no probability lies within 1e-3 of the 0.9 call
thresholds, which the test checks.
"""

import ast
import gzip
from pathlib import Path

import numpy as np
import pytest
import scipy.io as sio
import torch

from vireo_tpu_torch.sim.synth import synth_pool_counts
from vireo_tpu_torch.cli import vireo_cli as tcli

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's entry points run on the card unless asked for the CPU
    (utils/device.py); these tests ask for it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIREO_PLATFORM", "cpu")
        yield

REPO = Path(__file__).resolve().parent.parent


def _write_cellsnp(folder, seed=12, V=300, C=400, K=3):
    d = synth_pool_counts(n_var=V, n_cell=C, n_donor=K, doublet_rate=0.08,
                          density=0.15, seed=seed)
    folder.mkdir(parents=True)
    sio.mmwrite(str(folder / "cellSNP.tag.AD.mtx"), d["AD"].astype(int))
    sio.mmwrite(str(folder / "cellSNP.tag.DP.mtx"), d["DP"].astype(int))
    with gzip.open(folder / "cellSNP.base.vcf.gz", "wt") as fh:
        fh.write("##fileformat=VCFv4.2\n##contig=<ID=1>\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for v in range(V):
            fh.write("1\t%d\t.\tA\tG\t.\tPASS\t.\n" % (1000 + 10 * v))
    with open(folder / "cellSNP.samples.tsv", "w") as fh:
        fh.write("".join("cell%04d-1\n" % c for c in range(C)))
    return d


def _read_table(path):
    rows = [line.rstrip("\n").split("\t")
            for line in open(path).readlines()]
    return rows[0], rows[1:]


def test_cli_calls_match_jax_cli(tmp_path, monkeypatch):
    from vireo_tpu.cli import vireo_cli as jcli
    monkeypatch.setenv("VIREO_COMPILE_CACHE", "")
    data = tmp_path / "cellsnp"
    _write_cellsnp(data)
    common = ["-c", str(data), "-N", "3", "--nInit", "5", "--randSeed", "3",
              "--noPlot"]
    jcli.main(common + ["-o", str(tmp_path / "jax")])
    tcli.main(common + ["-o", str(tmp_path / "torch")])

    head_j, rows_j = _read_table(tmp_path / "jax" / "donor_ids.tsv")
    head_t, rows_t = _read_table(tmp_path / "torch" / "donor_ids.tsv")
    assert head_t == head_j and len(rows_t) == len(rows_j) == 400
    col = {name: i for i, name in enumerate(head_j)}
    for name in ("cell", "donor_id", "best_singlet", "n_vars"):
        assert [r[col[name]] for r in rows_t] == \
            [r[col[name]] for r in rows_j], name
    with gzip.open(tmp_path / "jax" / "prob_doublet.tsv.gz", "rt") as fh:
        pair_p = np.array([[float(x) for x in line.split("\t")[1:]]
                           for line in fh.read().splitlines()[1:]])
    top2 = np.sort(np.log(np.maximum(pair_p, 1e-300)), axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 0.25
    assert clear.mean() > 0.9
    bd = col["best_doublet"]
    assert [r[bd] for r, c in zip(rows_t, clear) if c] == \
        [r[bd] for r, c in zip(rows_j, clear) if c]
    assert len({r[col["donor_id"]] for r in rows_t}) >= 4  # donors+doublet

    def num(rows, name):
        return np.array([float(r[col[name]]) for r in rows])

    for name in ("prob_max", "prob_doublet"):
        pj = num(rows_j, name)
        assert np.min(np.abs(pj - 0.9)) > 1e-3     # no call on the edge
        np.testing.assert_allclose(num(rows_t, name), pj, atol=5e-2)
    np.testing.assert_allclose(num(rows_t, "doublet_logLikRatio"),
                               num(rows_j, "doublet_logLikRatio"),
                               rtol=5e-2, atol=0.5)

    assert (tmp_path / "torch" / "summary.tsv").read_text() == \
        (tmp_path / "jax" / "summary.tsv").read_text()
    for name in ("prob_singlet.tsv.gz", "prob_doublet.tsv.gz"):
        with gzip.open(tmp_path / "torch" / name, "rt") as fh:
            t_lines = fh.read().splitlines()
        with gzip.open(tmp_path / "jax" / name, "rt") as fh:
            j_lines = fh.read().splitlines()
        assert t_lines[0] == j_lines[0] and len(t_lines) == len(j_lines)
    assert (tmp_path / "torch" / "_log.txt").read_text().startswith(
        "logLik: ")


@pytest.mark.parametrize("flags,item", [
    (["--donorFile", "d.vcf.gz"], "donor-prior"),
    (["--extraDonor", "1"], "donor-prior"),
    (["--callAmbientRNAs"], "ambient"),
    (["--checkpointDir", "ck"], "checkpoints"),
    (["--mesh", "2x4"], "multi-GPU"),
])
def test_cli_unported_flags_exit_naming_roadmap(tmp_path, flags, item):
    with pytest.raises(SystemExit) as exc:
        tcli.main(["-c", str(tmp_path), "-N", "2", "-o",
                   str(tmp_path / "out")] + flags)
    assert "ROADMAP.md" in str(exc.value) and item in str(exc.value)


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "vireo_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10 and all(f.is_file() for f in files)
    for f in files:
        for mod in _imported_modules(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "vireo_tpu"), (f, mod)
