"""vireo_tpu_torch.io (the VCF engine, the donor matching, the VarTrix
reader) against vireo_tpu.io on small files written here: the same dicts,
arrays and text, exactly (both are host Python over the same strings;
the JAX package's native reader is not used, as where its toolchain is
absent)."""

import gzip
from pathlib import Path

import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp

from vireo_tpu.io import vcf as jvcf, matrices as jmat
from vireo_tpu_torch.io import vcf as tvcf, matrices as tmat

GOLDEN = Path(__file__).resolve().parent / "goldens" / "GT_donors.ref.vcf.gz"

HEADER = ("##fileformat=VCFv4.2\n##contig=<ID=1>\n##contig=<ID=2>\n"
          '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')


def _same(a, b):
    """Deep equality of the readers' dicts, lists and arrays."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (set(a), set(b))
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif sp.issparse(a):
        assert sp.issparse(b) and a.shape == b.shape
        assert (a != b).nnz == 0
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, np.asarray(b))
    else:
        assert a == b, (a, b)


def _write_cell_vcf(path, V=30, C=7, seed=0, chrom="1", bare_dots=True):
    """A cellSNP-style cell VCF: FORMAT GT:AD:DP:OTH, '.' (with
    `bare_dots`; the dense layout, in both packages, takes only entries
    with every field) and '.:.:.:.' for missing cells, one multi-allelic
    record."""
    rng = np.random.RandomState(seed)
    lines = [HEADER + "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
             + "\t".join("cell%d" % c for c in range(C))]
    for v in range(V):
        alt = "G,T" if v == 5 else "G"
        cells = []
        for c in range(C):
            r = rng.rand()
            if r < 0.3:
                cells.append("." if bare_dots else ".:.:.:.")
            elif r < 0.4:
                cells.append(".:.:.:.")
            else:
                dp = rng.randint(1, 9)
                cells.append("0/1:%d:%d:0" % (rng.binomial(dp, 0.5), dp))
        lines.append("\t".join([chrom, str(100 + 7 * v), ".", "A", alt, ".",
                                "PASS", "DP=3", "GT:AD:DP:OTH"] + cells))
    with gzip.open(path, "wt") as fh:
        fh.write("\n".join(lines) + "\n")


def _write_donor_vcf(path, codes, chrom="1", positions=None):
    """A donor VCF whose FORMAT holds GT, PL and GP (GT missing on some
    records, to exercise the dense layout's '.' fill)."""
    n_var, n_donor = len(codes), len(codes[0])
    positions = positions or [100 + 7 * v for v in range(n_var)]
    lines = [HEADER + "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
             + "\t".join("D%d" % d for d in range(n_donor))]
    for v, row in enumerate(codes):
        fmt = "PL:GP" if v % 9 == 4 else "GT:PL:GP"
        cells = []
        for gt, pl, gp in row:
            cells.append(":".join(([] if v % 9 == 4 else [gt]) + [pl, gp]))
        lines.append("\t".join([chrom, str(positions[v]), ".", "A", "G", ".",
                                "PASS", ".", fmt] + cells))
    with gzip.open(path, "wt") as fh:
        fh.write("\n".join(lines) + "\n")


def _codes(n_var, n_donor, seed):
    rng = np.random.RandomState(seed)
    gts = ["0/0", "0/1", "1/1", "1|0", "./.", ".", ".|."]
    out = []
    for _ in range(n_var):
        row = []
        for _ in range(n_donor):
            g = gts[rng.randint(len(gts))]
            pl = ",".join(str(x) for x in rng.randint(0, 90, 3)) \
                if g[0] != "." else "."
            gp = ",".join("%.3f" % x for x in rng.dirichlet(np.ones(3))) \
                if g[0] != "." else "."
            row.append((g, pl, gp))
        out.append(row)
    return out


@pytest.mark.parametrize("sparse,format_list", [
    (True, None), (False, None), (False, ["AD", "DP"]),
    (True, ["DP", "OTH", "AD", "GT"]),     # sparse: every tag, any order
])
@pytest.mark.parametrize("biallelic_only", [False, True])
def test_load_cell_vcf(tmp_path, sparse, format_list, biallelic_only):
    path = str(tmp_path / "cells.vcf.gz")
    _write_cell_vcf(path, bare_dots=sparse)
    kw = dict(biallelic_only=biallelic_only, sparse=sparse,
              format_list=format_list)
    got = tvcf.load_VCF(path, **kw)
    _same(got, jvcf.load_VCF(path, **kw))
    assert len(got["variants"]) == (29 if biallelic_only else 30)
    assert got["samples"] == ["cell%d" % c for c in range(7)]
    if sparse:
        _same(tvcf.read_sparse_GeneINFO(got["GenoINFO"], keys=["AD", "DP"]),
              jvcf.read_sparse_GeneINFO(got["GenoINFO"], keys=["AD", "DP"]))


def test_load_vcf_without_samples_and_plain_text(tmp_path):
    path = tmp_path / "cells.vcf.gz"
    _write_cell_vcf(str(path))
    plain = tmp_path / "cells.vcf"
    with gzip.open(path, "rt") as fh:
        plain.write_text(fh.read())
    for p in (str(path), str(plain)):
        got = tvcf.load_VCF(p, load_sample=False)
        _same(got, jvcf.load_VCF(p, load_sample=False))
        assert "samples" not in got and "GenoINFO" not in got


def test_sparse_layout_refuses_mixed_formats(tmp_path):
    path = str(tmp_path / "donors.vcf.gz")
    _write_donor_vcf(path, _codes(10, 3, seed=1))
    for mod in (tvcf, jvcf):
        with pytest.raises(ValueError, match="same format"):
            mod.load_VCF(path, sparse=True)


def test_parse_sample_info_warns_on_few_tagged_variants(capsys):
    rows = [["GT:PL", "0/1:0,3,9", "1/1:9,3,0"]] \
        + [["PL", "0,3,9", "9,3,0"]] * 19
    got = tvcf.parse_sample_info(rows, sparse=False, format_list=["GT", "PL"])
    printed = capsys.readouterr().out
    want = jvcf.parse_sample_info(rows, sparse=False,
                                  format_list=["GT", "PL"])
    assert capsys.readouterr().out == printed
    assert "too few variants with tags" in printed and "GT: 1" in printed
    _same(got, want)
    assert tvcf.parse_sample_info([]) is None


@pytest.mark.parametrize("tag", ["GT", "PL", "GP"])
def test_parse_donor_GPb(tmp_path, tag):
    path = str(tmp_path / "donors.vcf.gz")
    _write_donor_vcf(path, _codes(40, 5, seed=2))
    kw = dict(biallelic_only=True, sparse=False, format_list=[tag])
    t_vcf, j_vcf = tvcf.load_VCF(path, **kw), jvcf.load_VCF(path, **kw)
    _same(t_vcf, j_vcf)
    got = tvcf.parse_donor_GPb(t_vcf["GenoINFO"][tag], tag)
    want = jvcf.parse_donor_GPb(j_vcf["GenoINFO"][tag], tag)
    assert got.shape == (40, 5, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got.sum(-1), 1.0)
    missing = np.array([[c in (".", "./.", ".|.") for c in row]
                        for row in t_vcf["GenoINFO"][tag]])
    assert missing.any()
    np.testing.assert_array_equal(got[missing], 1 / 3)
    if tag == "PL":
        i, j = np.argwhere(~missing)[0]
        pl = np.array(t_vcf["GenoINFO"]["PL"][i][j].split(","), float)
        p = 10 ** (-0.1 * (pl - pl.min()) - 0.025)
        np.testing.assert_allclose(got[i, j], p / p.sum())


def test_parse_donor_GPb_min_prob_and_unknown_tag(capsys):
    codes = [["0/0", "1/1", "./."], ["0|1", ".", "1/1"]]
    np.testing.assert_array_equal(
        tvcf.parse_donor_GPb(codes, "GT", min_prob=0.01),
        jvcf.parse_donor_GPb(codes, "GT", min_prob=0.01))
    assert tvcf.parse_donor_GPb(codes, "DS") is None
    printed = capsys.readouterr().out
    assert jvcf.parse_donor_GPb(codes, "DS") is None
    assert capsys.readouterr().out == printed and "no support tag" in printed


@pytest.mark.parametrize("ids1,ids2", [
    (["1_10_A_G", "1_20_C_T", "2_5_G_A"], ["2_5_G_A", "1_10_A_G"]),
    (["1_10_A_G", "1_20_C_T"], ["chr1_20_C_T", "chr1_10_A_G"]),   # chr on 2
    (["chr1_10_A_G", "chr2_5_G_A"], ["2_5_G_A", "1_10_A_G"]),     # chr on 1
    (["1_10_A_G"], ["3_1_A_G"]),                                  # none
])
def test_match_SNPs(ids1, ids2):
    got = tvcf.match_SNPs(ids1, ids2)
    np.testing.assert_array_equal(got, jvcf.match_SNPs(ids1, ids2))
    assert any(x is not None for x in got) == (ids2 != ["3_1_A_G"])


def _cellsnp_like(tmp_path, V=30, C=7):
    """A cell VCF read into the CLI's cell_dat layout by both packages."""
    path = str(tmp_path / "cells.vcf.gz")
    _write_cell_vcf(path, V=V, C=C, chrom="chr1")
    out = []
    for mod in (tvcf, jvcf):
        vcf = mod.load_VCF(path, biallelic_only=True)
        dat = mod.read_sparse_GeneINFO(vcf["GenoINFO"], keys=["AD", "DP"])
        for key in ("samples", "variants", "FixedINFO", "contigs",
                    "comments"):
            dat[key] = vcf[key]
        out.append(dat)
    return out


def test_match_donor_VCF(tmp_path):
    t_cell, j_cell = _cellsnp_like(tmp_path)
    # donors at every other cell position, unprefixed, plus two others
    positions = [100 + 14 * v for v in range(15)] + [5, 9]
    path = str(tmp_path / "donors.vcf.gz")
    _write_donor_vcf(path, _codes(17, 4, seed=3), positions=positions)
    kw = dict(biallelic_only=True, sparse=False, format_list=["GT"])
    got = tmat.match_donor_VCF(t_cell, tvcf.load_VCF(path, **kw))
    want = jmat.match_donor_VCF(j_cell, jvcf.load_VCF(path, **kw))
    _same(got, want)
    cell, donor = got
    assert 0 < len(cell["variants"]) == len(donor["variants"]) < 17
    assert cell["AD"].shape == (len(cell["variants"]), 7)
    assert [v[3:] for v in cell["variants"]] == donor["variants"]


def test_read_vartrix(tmp_path):
    rng = np.random.RandomState(5)
    ref = sp.csc_matrix((rng.rand(12, 9) < 0.4) * rng.randint(1, 9, (12, 9)))
    alt = sp.csc_matrix((rng.rand(12, 9) < 0.4) * rng.randint(1, 9, (12, 9)))
    sio.mmwrite(str(tmp_path / "alt.mtx"), alt)
    sio.mmwrite(str(tmp_path / "ref.mtx"), ref)
    (tmp_path / "barcodes.tsv").write_text(
        "".join("AAAC%02d-1\n" % c for c in range(9)))
    vcf = str(tmp_path / "snps.vcf.gz")
    with gzip.open(vcf, "wt") as fh:
        fh.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                 "FILTER\tINFO\n")
        fh.write("".join("1\t%d\t.\tA\tC\t.\tPASS\t.\n" % (50 + v)
                         for v in range(12)))
    files = [str(tmp_path / f) for f in ("alt.mtx", "ref.mtx",
                                         "barcodes.tsv")]
    for extra in ([], [vcf]):
        got = tmat.read_vartrix(*files, *extra)
        _same(got, jmat.read_vartrix(*files, *extra))
        assert (got["DP"] - got["AD"] - ref).nnz == 0
        assert ("variants" in got) == bool(extra)


def _gt_prob(V, K, seed):
    rng = np.random.RandomState(seed)
    p = rng.dirichlet(np.ones(3) * 0.3, size=(V, K))
    p[0, 0] = [1.0, 0.0, 0.0]            # a zero floored at 1e-10
    return p


def test_genoinfo_maker_and_write_vcf(tmp_path):
    t_cell, j_cell = _cellsnp_like(tmp_path)
    V, K = len(t_cell["variants"]), 3
    GT = _gt_prob(V, K, seed=6)
    ID = np.random.RandomState(7).dirichlet(np.ones(K), size=7)
    texts = []
    for mod, dat, name in ((tvcf, t_cell, "t"), (jvcf, j_cell, "j")):
        dat["samples"] = ["donor%d" % k for k in range(K)]
        dat["GenoINFO"] = mod.GenoINFO_maker(GT, dat["AD"] @ ID,
                                             dat["DP"] @ ID)
        out = str(tmp_path / ("GT_donors_%s.vireo.vcf.gz" % name))
        mod.write_VCF(out, dat)
        assert not Path(out[:-3]).exists()
        with gzip.open(out, "rt") as fh:
            texts.append(fh.read())
    _same(t_cell["GenoINFO"], j_cell["GenoINFO"])
    assert texts[0] == texts[1]
    lines = texts[0].splitlines()
    head = lines.index(next(x for x in lines if x.startswith("#CHROM")))
    assert lines[head].split("\t")[9:] == ["donor0", "donor1", "donor2"]
    assert len(lines) - head - 1 == V
    assert lines[head + 1].split("\t")[9].startswith("0/0:")


def test_write_vcf_without_samples(tmp_path, capsys):
    dat = tvcf.load_VCF(str(GOLDEN), load_sample=False)
    out = str(tmp_path / "sites.vcf.gz")
    tvcf.write_VCF(out, dat, GenoTags=[])
    assert capsys.readouterr().out == ""
    with gzip.open(out, "rt") as fh:
        lines = fh.read().splitlines()
    assert lines[-1].split("\t")[:2] == dat["FixedINFO"]["CHROM"][-1:] \
        + dat["FixedINFO"]["POS"][-1:]


@pytest.mark.parametrize("tag", ["GT", "PL"])
def test_golden_donor_vcf(tag):
    """The in-tree GT_donors.ref.vcf.gz, read by both packages as the CLI
    reads a donor file."""
    kw = dict(biallelic_only=True, sparse=False, format_list=[tag])
    got = tvcf.load_VCF(str(GOLDEN), **kw)
    want = jvcf.load_VCF(str(GOLDEN), **kw)
    _same(got, want)
    assert got["samples"] == ["donor0", "donor1", "donor2", "donor3"]
    gp = tvcf.parse_donor_GPb(got["GenoINFO"][tag], tag)
    np.testing.assert_array_equal(
        gp, jvcf.parse_donor_GPb(want["GenoINFO"][tag], tag))
    assert gp.shape == (len(got["variants"]), 4, 3)
    assert int(got["n_SNP_tagged"][0]) == len(got["variants"])


@pytest.mark.parametrize("tag1,tag2", [("GT", "GT"), ("PL", "GP")])
def test_match_VCF_samples(tmp_path, capsys, tag1, tag2):
    """Two donor VCFs, the second with its donors in another order on
    'chr'-prefixed, partly shared variants: the same result dict and
    prints as JAX's."""
    codes = _codes(40, 4, seed=3)
    _write_donor_vcf(tmp_path / "a.vcf.gz", codes)
    perm = [2, 0, 3, 1]
    codes2 = [[row[k] for k in perm] for row in codes[5:]]
    _write_donor_vcf(tmp_path / "b.vcf.gz", codes2, chrom="chr1",
                     positions=[100 + 7 * v for v in range(5, 40)])
    args = (str(tmp_path / "a.vcf.gz"), str(tmp_path / "b.vcf.gz"), tag1,
            tag2)
    want = jvcf.match_VCF_samples(*args)
    out_j = capsys.readouterr().out
    got = tvcf.match_VCF_samples(*args)
    assert capsys.readouterr().out == out_j
    assert got["matched_n_var"] == 35
    _same(got, want)


def test_snp_gene_match():
    """Overlaps, nearest genes at each distance tier and unmatched SNPs
    against JAX's, on a pandas gene table (the port reads it through
    the DataFrame interface, without importing pandas itself)."""
    pd = pytest.importorskip("pandas")
    genes = pd.DataFrame({
        "chrom": ["1", "1", "1", "2", "2"],
        "start": [100, 150, 5000, 10, 300000],
        "stop": [200, 400, 6000, 50, 300500],
        "gene": ["A", "B", "C", "D", "E"],
        "gene_id": ["a", "b", "c", "d", "e"]})
    info = {"CHROM": ["1", "1", "1", "1", "2", "2", "3", "1"],
            "POS": [160, 100, 450, 20000, 90, 250000, 5, 6000]}
    for kw in (dict(), dict(multi_gene=False), dict(gene_key="gene_id"),
               dict(gaps=[0, 10, 500])):
        jg, jf = jvcf.snp_gene_match(info, genes, **kw)
        tg, tf = tvcf.snp_gene_match(info, genes, **kw)
        assert tf == jf
        assert [list(x) for x in tg] == [list(x) for x in jg]
    assert list(tvcf.snp_gene_match(info, genes)[0][0]) == ["A", "B"]


def test_write_VCF_to_hdf5(tmp_path):
    h5py = pytest.importorskip("h5py")
    _write_donor_vcf(tmp_path / "d.vcf.gz", _codes(20, 3, seed=1))
    dat = tvcf.load_VCF(str(tmp_path / "d.vcf.gz"), sparse=False)
    tvcf.write_VCF_to_hdf5(dat, str(tmp_path / "t.h5"))
    jvcf.write_VCF_to_hdf5(dat, str(tmp_path / "j.h5"))
    with h5py.File(tmp_path / "t.h5") as t, h5py.File(tmp_path / "j.h5") as j:
        keys = []
        t.visit(keys.append)
        jkeys = []
        j.visit(jkeys.append)
        assert keys == jkeys and "GenoINFO/GT" in keys
        for k in keys:
            if isinstance(t[k], h5py.Dataset):
                np.testing.assert_array_equal(t[k][()], j[k][()])
        assert [x.decode() for x in t["samples"][()]] == dat["samples"]


def test_make_whitelists(tmp_path):
    table = ("cell\tdonor_id\tprob_max\n"
             "AAA-1\tdonor0\t1\nCCC-1\tdoublet\t1\nGGG-1\tdonor1\t1\n"
             "TTT-1\tdonor0\t1\nACG-1\tunassigned\t1\n")
    (tmp_path / "donor_ids.tsv").write_text(table)
    for mod, name in ((jmat, "j"), (tmat, "t")):
        mod.make_whitelists(str(tmp_path / "donor_ids.tsv"),
                            str(tmp_path / name))
    for donor in ("donor0", "donor1"):
        assert (tmp_path / ("t_%s.txt" % donor)).read_text() == \
            (tmp_path / ("j_%s.txt" % donor)).read_text()
    assert (tmp_path / "t_donor0.txt").read_text() == "AAA\nTTT\n"
    assert sorted(p.name for p in tmp_path.glob("t_*")) == \
        ["t_donor0.txt", "t_donor1.txt"]
