"""The port's plots (plot/base_plot.py) against the JAX package's: the four
functions render on the inputs of tests/test_io_extra.py, plot_GT hands
heat_matrix the same distance matrices, and the `vireo` and `GTbarcode`
CLIs write their figures under the JAX CLIs' file names. Without
matplotlib the `vireo` CLI writes its results and one note naming it."""

import sys

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from vireo_tpu.plot import base_plot as jplot  # noqa: E402
from vireo_tpu_torch.plot import base_plot as tplot  # noqa: E402
from vireo_tpu_torch.cli import vireo_cli as tcli  # noqa: E402

from test_torch_cli import _write_cellsnp, _write_donor_vcf  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _ask_for_the_cpu(monkeypatch):
    monkeypatch.setenv("VIREO_PLATFORM", "cpu")
    monkeypatch.setenv("VIREO_COMPILE_CACHE", "")


def test_plots_render(tmp_path):
    from vireo_tpu_torch.plot import (heat_matrix, plot_GT, minicode_plot,
                                      anno_heat, vireo_colors)
    assert list(vireo_colors) == list(jplot.vireo_colors)

    X = np.random.RandomState(0).rand(4, 4)
    plt.figure()
    im = heat_matrix(X, yticks=list("abcd"), xticks=list("wxyz"))
    np.testing.assert_array_equal(im.get_array(), X)
    plt.savefig(tmp_path / "hm.png")
    plt.close()

    GT_prob = np.random.RandomState(1).dirichlet(
        np.ones(3), size=(30, 4)).reshape(30, 4, 3)
    plot_GT(str(tmp_path), GT_prob, ["d%d" % i for i in range(4)])
    assert (tmp_path / "fig_GT_distance_estimated.pdf").stat().st_size > 0

    barcodes = ["b0102", "b2110", "b1021"]
    plt.figure()
    im = minicode_plot(barcodes, var_ids=["v%d" % i for i in range(4)],
                       sample_ids=["s%d" % i for i in range(len(barcodes))])
    plt.savefig(tmp_path / "mc.png")
    plt.close()
    np.testing.assert_array_equal(
        im.get_array(), [[0, 2, 1], [1, 1, 0], [0, 1, 2], [2, 0, 1]])

    fig = anno_heat(np.random.RandomState(3).rand(20, 8),
                    row_anno=["r%d" % (i % 2) for i in range(20)],
                    col_anno=["c%d" % (i % 2) for i in range(8)])
    fig.savefig(tmp_path / "ah.png")
    plt.close("all")


def _captured(module, monkeypatch):
    seen = []
    real = module.heat_matrix

    def spy(X, *args, **kwargs):
        seen.append((np.array(X), list(args)))
        return real(X, *args, **kwargs)
    monkeypatch.setattr(module, "heat_matrix", spy)
    return seen


def test_plot_gt_matrices_match_jax(tmp_path, monkeypatch):
    rng = np.random.RandomState(2)
    cell = rng.dirichlet(np.ones(3), size=(25, 3))
    donor = rng.dirichlet(np.ones(3), size=(25, 4))
    names, names_in = ["d0", "d1", "d2"], ["a", "b", "c", "d"]
    got, want = _captured(tplot, monkeypatch), _captured(jplot, monkeypatch)
    for module, seen, sub in ((tplot, got, "t"), (jplot, want, "j")):
        (tmp_path / sub).mkdir()
        module.plot_GT(str(tmp_path / sub), cell, names, donor, names_in)
    assert len(got) == len(want) == 2
    for (a, la), (b, lb) in zip(got, want):
        assert la == lb
        np.testing.assert_allclose(a, b, rtol=1e-12)
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j").iterdir()) == \
        ["fig_GT_distance_estimated.pdf", "fig_GT_distance_input.pdf"]


@pytest.mark.parametrize("mode", ["genotype_free", "superset"])
def test_cli_writes_the_jax_cli_figures(tmp_path, mode):
    from vireo_tpu.cli import vireo_cli as jcli
    data = tmp_path / "cellsnp"
    d = _write_cellsnp(data, V=80, C=120, K=3)
    flags = ["-c", str(data), "-N", "3", "--nInit", "2", "--randSeed", "1"]
    if mode == "superset":
        _write_donor_vcf(str(tmp_path / "donors.vcf.gz"), d["GT"], [0, 1],
                         ["A", "B"], np.random.RandomState(0), V=80)
        flags += ["-d", str(tmp_path / "donors.vcf.gz"), "-t", "GT"]
    jcli.main(flags + ["-o", str(tmp_path / "jax")])
    tcli.main(flags + ["-o", str(tmp_path / "torch")])
    figs = {sub: sorted(p.name for p in (tmp_path / sub).iterdir()
                        if p.suffix == ".pdf") for sub in ("jax", "torch")}
    want = ["fig_GT_distance_estimated.pdf"] + (
        ["fig_GT_distance_input.pdf"] if mode == "superset" else [])
    assert figs["torch"] == figs["jax"] == want
    plt.close("all")


def test_cli_without_matplotlib_notes_it_and_writes_results(
        tmp_path, capsys, monkeypatch):
    data = tmp_path / "cellsnp"
    _write_cellsnp(data, V=60, C=80, K=2)
    monkeypatch.setitem(sys.modules, "matplotlib", None)   # not installed
    tcli.main(["-c", str(data), "-N", "2", "--nInit", "2", "--randSeed", "1",
               "-o", str(tmp_path / "out")])
    notes = [x for x in capsys.readouterr().out.splitlines()
             if "matplotlib" in x]
    assert len(notes) == 1 and "not installed" in notes[0]
    names = {p.name for p in (tmp_path / "out").iterdir()}
    assert {"donor_ids.tsv", "summary.tsv", "prob_singlet.tsv.gz",
            "prob_doublet.tsv.gz", "GT_donors.vireo.vcf.gz"} <= names
    assert not any(n.endswith(".pdf") for n in names)
