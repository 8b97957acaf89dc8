"""The port's native reader and writer (io/_native, io/fast.py) against the
JAX package's native readers and the port's pure-Python readers, on
synthetic cellSNP folders and cell VCFs: the same matrices (no entry
differs) and the same metadata; the `.tsv.gz` writer's decompressed
bytes equal the Python writer's; VIREO_NO_NATIVE falls back."""

import gzip

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp

from vireo_tpu.io import fast as jfast
from vireo_tpu_torch.io import fast as tfast
from vireo_tpu_torch.io import matrices as tmat
from vireo_tpu_torch.io import vcf as tvcf
from vireo_tpu_torch.io._native import build as tbuild

from test_torch_cli import _write_cellsnp, _write_cell_vcf


@pytest.fixture(scope="module")
def native():
    if not tfast.native_available():
        pytest.fail("the native library did not build: %s"
                    % tbuild.build_error())
    return True


@pytest.fixture(scope="module")
def cellsnp(tmp_path_factory):
    folder = tmp_path_factory.mktemp("native") / "cellsnp"
    d = _write_cellsnp(folder, seed=7, V=120, C=90, K=3, density=0.2)
    return folder, d


def _same_matrix(a, b):
    assert a.shape == b.shape
    assert (sp.csr_matrix(a) != sp.csr_matrix(b)).nnz == 0


def test_library_lands_in_the_build_dir(native):
    path = tbuild.library_path()
    assert path.is_file() and path.parent == tbuild.BUILD_DIR
    assert path.parent.name == "_build" \
        and path.parent.parent.name == "vireo_tpu_torch"
    assert tbuild.build_error() is None


def test_cell_vcf_parity(native, tmp_path, cellsnp):
    _, d = cellsnp
    path = str(tmp_path / "cells.vcf.gz")
    _write_cell_vcf(path, d, V=120, C=90)
    got = tfast.load_cell_vcf_fast(path, tags=("AD", "DP"),
                                   biallelic_only=True)
    jax_fast = jfast.load_cell_vcf_fast(path, tags=("AD", "DP"),
                                        biallelic_only=True)
    ref = tvcf.load_VCF(path, biallelic_only=True)
    mats = tvcf.read_sparse_GeneINFO(ref["GenoINFO"], keys=["AD", "DP"])
    for want in (jax_fast, dict(ref, **mats)):
        for key in ("variants", "samples", "comments", "contigs",
                    "FixedINFO"):
            assert got[key] == want[key], key
        for key in ("AD", "DP"):
            _same_matrix(got[key], want[key])
    _same_matrix(got["DP"], d["DP"])
    _same_matrix(got["AD"], d["AD"])


def test_read_cellsnp_parity(native, cellsnp, monkeypatch):
    """read_cellSNP through the native paths equals the JAX package's
    (native too) and the port's pure-Python one."""
    from vireo_tpu.io.matrices import read_cellSNP as j_read
    folder, d = cellsnp
    got = tmat.read_cellSNP(str(folder))
    want_j = j_read(str(folder))
    monkeypatch.setenv("VIREO_NO_NATIVE", "1")
    want_py = tmat.read_cellSNP(str(folder))
    for want in (want_j, want_py):
        assert list(got["variants"]) == list(want["variants"])
        assert got["FixedINFO"] == want["FixedINFO"]
        assert got["comments"] == want["comments"]
        assert list(got["samples"]) == list(want["samples"])
        for key in ("AD", "DP"):
            _same_matrix(got[key], want[key])
    _same_matrix(got["DP"], d["DP"])
    assert got["AD"].format == "csc" and got["AD"].has_sorted_indices


def test_read_vartrix_parity(native, tmp_path, cellsnp, monkeypatch):
    from test_torch_cli import _write_vartrix
    folder, d = cellsnp
    _write_vartrix(tmp_path / "vartrix", d, C=90)
    args = [str(tmp_path / "vartrix" / f) for f in
            ("alt.mtx", "ref.mtx", "barcodes.tsv")]
    args.append(str(folder / "cellSNP.base.vcf.gz"))
    got = tmat.read_vartrix(*args)
    monkeypatch.setenv("VIREO_NO_NATIVE", "1")
    want = tmat.read_vartrix(*args)
    assert list(got["variants"]) == list(want["variants"])
    for key in ("AD", "DP"):
        _same_matrix(got[key], want[key])


def test_mtx_unsorted_and_duplicates(native, tmp_path):
    """Shuffled entries come back as canonical CSC; duplicate entries are
    summed (scipy's builder); both equal scipy.io.mmread and the JAX
    package's reader."""
    rng = np.random.RandomState(0)
    M = sp.random(37, 23, density=0.3, random_state=rng, format="coo")
    shuffled = tmp_path / "shuffled.mtx"
    with open(shuffled, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write("37 23 %d\n" % M.nnz)
        for i in rng.permutation(M.nnz):
            f.write("%d %d %.6g\n" % (M.row[i] + 1, M.col[i] + 1,
                                      M.data[i]))
    dup = tmp_path / "dup.mtx"
    with open(dup, "w") as f:
        f.write("%%MatrixMarket matrix coordinate integer general\n")
        f.write("4 3 5\n")
        f.write("1 1 2\n2 2 3\n1 1 5\n4 3 1\n2 2 1\n")
    for path in (shuffled, dup):
        got = tfast.read_mtx_fast(str(path))
        _same_matrix(got, scipy.io.mmread(str(path)).tocsc())
        _same_matrix(got, jfast.read_mtx_fast(str(path)))
        assert got.has_sorted_indices
    got = tfast.read_mtx_fast(str(dup))
    assert got[0, 0] == 7 and got[1, 1] == 4


def test_mtx_other_layouts_go_to_scipy(native, tmp_path):
    """'array', 'symmetric' and 'pattern' files are refused by the native
    parser and read by scipy through read_mtx."""
    files = {
        "arr.mtx": "%%MatrixMarket matrix array real general\n2 3\n"
                   + "".join("%g\n" % v for v in (1.5, 2, 0, 4, 5, 6.5)),
        "sym.mtx": "%%MatrixMarket matrix coordinate real symmetric\n"
                   "3 3 4\n1 1 2\n2 1 3\n3 2 4\n3 3 5\n",
        "pat.mtx": "%%MatrixMarket matrix coordinate pattern general\n"
                   "3 4 3\n1 2\n2 1\n3 4\n",
    }
    for name, text in files.items():
        path = tmp_path / name
        path.write_text(text)
        assert tfast.read_mtx_fast(str(path)) is None
        _same_matrix(tmat.read_mtx(str(path)),
                     sp.csc_matrix(scipy.io.mmread(str(path))))


def test_native_off_falls_back(cellsnp, monkeypatch, tmp_path):
    folder, _ = cellsnp
    monkeypatch.setenv("VIREO_NO_NATIVE", "1")
    assert not tfast.native_available()
    assert tfast.read_mtx_fast(str(folder / "cellSNP.tag.AD.mtx")) is None
    assert tfast.load_variants_fast(str(folder / "cellSNP.base.vcf.gz")) \
        is None
    assert tfast.load_cell_vcf_fast("x.vcf") is None
    assert tfast.write_matrix_tsv_fast(str(tmp_path / "w.tsv"), ["a"],
                                       ["r"], np.ones((1, 1)), "%.2e") \
        is False
    assert "VIREO_NO_NATIVE" in tbuild.build_error()


def _table(seed=1):
    rng = np.random.RandomState(seed)
    mat = np.concatenate([rng.rand(40, 5), rng.rand(40, 5) * 1e-30,
                          rng.randn(40, 5) * 1e3, np.zeros((1, 5))], axis=0)
    names = ["cell%d-1" % i for i in range(mat.shape[0])]
    return ["cell", "a", "b", "c", "d", "e"], names, mat


@pytest.mark.parametrize("gzip_level", [0, 4])
def test_tsv_writer_matches_python(native, tmp_path, gzip_level):
    cols, names, mat = _table()
    path = tmp_path / "nat.tsv"
    assert tfast.write_matrix_tsv_fast(str(path), cols, names, mat, "%.2e",
                                       gzip_level=gzip_level)
    with open(tmp_path / "py.tsv", "w") as fh:
        tmat._write_tsv(fh, cols, tmat._matrix_rows(names, mat, "%.2e"))
    got = gzip.decompress(path.read_bytes()) if gzip_level \
        else path.read_bytes()
    assert got == (tmp_path / "py.tsv").read_bytes()


def test_tsv_writer_refuses_an_overwide_format(native, tmp_path):
    assert tfast.write_matrix_tsv_fast(str(tmp_path / "w.tsv"),
                                       ["cell", "a", "b"], ["c0", "c1"],
                                       np.ones((2, 2)) * 1.234567,
                                       "%200.100f") is False


def test_write_donor_id_native_equals_python(native, tmp_path, monkeypatch):
    """write_donor_id's every file, native writer against Python writer
    (the .gz tables compared decompressed)."""
    rng = np.random.RandomState(3)
    C, K = 60, 4
    ID = rng.dirichlet(np.ones(K), C)
    res = {"ID_prob": ID, "doublet_prob": rng.dirichlet(np.ones(6), C) * 0.1,
           "doublet_LLR": rng.randn(C), "LB_doublet": -123.4,
           "theta_shapes": np.ones((2, 3)), "ambient_Psi": None}
    names = ["donor%d" % k for k in range(K)]
    cells = np.array(["c%03d-1" % c for c in range(C)])
    n_vars = rng.randint(0, 30, C)
    for tag in ("nat", "py"):
        if tag == "py":
            monkeypatch.setenv("VIREO_NO_NATIVE", "1")
        (tmp_path / tag).mkdir()
        tmat.write_donor_id(str(tmp_path / tag), names, cells, n_vars, res)
    for name in ("donor_ids.tsv", "summary.tsv", "_log.txt",
                 "prob_singlet.tsv.gz", "prob_doublet.tsv.gz"):
        a = (tmp_path / "nat" / name).read_bytes()
        b = (tmp_path / "py" / name).read_bytes()
        if name.endswith(".gz"):
            a, b = gzip.decompress(a), gzip.decompress(b)
        assert a == b, name
