"""The port's `vireo` CLI against the JAX CLI on a synthetic cellSNP
folder, and the port's import boundary.

Both CLIs run at their defaults, the JAX one in float64 (the port's
working type on the CPU): the port places int8 counts and runs K0's
plain version, the JAX CLI its dense counts; both take the doublet
phase unfused. So every discrete column (the calls, `best_singlet`,
`best_doublet`) is identical on every row, and every printed number
(prob_max, prob_doublet, doublet_logLikRatio, the probability tables,
prop_ambient.tsv) is the same as printed: the two float64 runs differ by
round-off, far below a unit of the last printed digit, so at most one
printed value in a thousand may differ, by one such unit, where it lies
on a rounding midpoint. The data seed is picked so that no probability lies within
1e-3 of the 0.9 call thresholds, which the test checks.
"""

import ast
import gzip
from pathlib import Path

import jax.numpy as jnp
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


def _write_cellsnp(folder, seed=12, V=300, C=400, K=3, density=0.15):
    d = synth_pool_counts(n_var=V, n_cell=C, n_donor=K, doublet_rate=0.08,
                          density=density, seed=seed)
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


def _jax_cli_in_float64(monkeypatch):
    """The JAX CLI with its vireo_wrap run in float64 (its default is
    float32 for a small pool)."""
    import functools
    from vireo_tpu.cli import vireo_cli as jcli
    monkeypatch.setenv("VIREO_COMPILE_CACHE", "")
    monkeypatch.setattr(jcli, "vireo_wrap", functools.partial(
        jcli.vireo_wrap, dtype=jnp.float64))
    return jcli


def test_cli_calls_match_jax_cli(tmp_path, monkeypatch):
    """The genotype-free CLI at both packages' defaults, JAX's in float64:
    every column and table as the module docstring says."""
    jcli = _jax_cli_in_float64(monkeypatch)
    data = tmp_path / "cellsnp"
    _write_cellsnp(data)
    common = ["-c", str(data), "-N", "3", "--nInit", "5", "--randSeed", "3",
              "--noPlot"]
    jcli.main(common + ["-o", str(tmp_path / "jax")])
    tcli.main(common + ["-o", str(tmp_path / "torch")])

    _compare_outputs(tmp_path / "torch", tmp_path / "jax")
    head, rows = _read_table(tmp_path / "torch" / "donor_ids.tsv")
    assert len(rows) == 400
    assert len({r[head.index("donor_id")] for r in rows}) >= 4  # + doublet
    assert (tmp_path / "torch" / "_log.txt").read_text().startswith(
        "logLik: ")


def _pl(gt, rng):
    """Phred-scaled likelihoods of genotype `gt` (0, 1, 2): 0 at it,
    ~30 a category away, ~60 two away, with a little noise."""
    return ",".join(str(30 * abs(k - gt) + rng.randint(0, 4))
                    for k in range(3))


def _write_donor_vcf(path, GT, donors, names, rng, chrom="chr1", V=300):
    """A donor VCF of genotypes GT[:, donors] with GT and PL tags: 90% of
    the cell data's variants in another order, 10 variants of its own,
    'chr'-prefixed names (matched through match_SNPs' retry) and a few
    missing codes."""
    keep = rng.permutation(V)[:int(0.9 * V)]
    lines = ["##fileformat=VCFv4.2",
             '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
             + "\t".join(names)]
    rows = [(1000 + 10 * v, GT[v]) for v in keep] + [
        (5 + v, rng.randint(0, 3, GT.shape[1])) for v in range(10)]
    for pos, g in rows:
        cells = []
        for d in donors:
            if rng.rand() < 0.02:
                cells.append("./.:.")
            else:
                cells.append("%s:%s" % (("0/0", "0/1", "1/1")[g[d]],
                                        _pl(g[d], rng)))
        lines.append("\t".join([chrom, str(pos), ".", "A", "G", ".", "PASS",
                                ".", "GT:PL"] + cells))
    with gzip.open(path, "wt") as fh:
        fh.write("\n".join(lines) + "\n")


def _write_cell_vcf(path, d, V=300, C=400):
    """The pool as a cell VCF (cellSNP's VCF output: GT:AD:DP:OTH,
    missing cells '.')."""
    AD, DP = d["AD"].toarray(), d["DP"].toarray()
    with gzip.open(path, "wt") as fh:
        fh.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                 "FILTER\tINFO\tFORMAT\t"
                 + "\t".join("cell%04d-1" % c for c in range(C)) + "\n")
        for v in range(V):
            cells = ["0/1:%d:%d:0" % (AD[v, c], DP[v, c]) if DP[v, c] else "."
                     for c in range(C)]
            fh.write("\t".join(["1", str(1000 + 10 * v), ".", "A", "G", ".",
                                "PASS", ".", "GT:AD:DP:OTH"] + cells) + "\n")


def _write_vartrix(folder, d, C=400):
    folder.mkdir()
    sio.mmwrite(str(folder / "alt.mtx"), d["AD"].astype(int))
    sio.mmwrite(str(folder / "ref.mtx"), (d["DP"] - d["AD"]).astype(int))
    (folder / "barcodes.tsv").write_text(
        "".join("cell%04d-1\n" % c for c in range(C)))


def _vcf_rows(path):
    with gzip.open(path, "rt") as fh:
        lines = fh.read().splitlines()
    head = [x for x in lines if x.startswith("#")]
    return head, [x.split("\t") for x in lines if not x.startswith("#")]


# mode -> (the donor file's donors (None: no file), extra CLI flags)
MODES = {
    "known_GT": ([0, 1, 2], ["-t", "GT"]),
    "known_PL": ([0, 1, 2], ["-t", "PL"]),
    "subset": ([0, 1, 2, 3], ["-t", "GT", "-N", "3"]),
    "superset": ([0, 1], ["-t", "GT", "-N", "3"]),
    "force_learn_GT": ([0, 1, 2], ["-t", "PL", "--forceLearnGT"]),
    "extra_donor": (None, ["-N", "3", "--extraDonor", "1"]),
    "vartrix": (None, ["-N", "3"]),
    "cell_vcf": (None, ["-N", "3"]),
    "ase_mode": (None, ["-N", "3", "--ASEmode"]),
    "cell_range": (None, ["-N", "3", "--cellRange", "50-350"]),
    "no_doublet": (None, ["-N", "3", "--noDoublet"]),
    "extra_donor_size": (None, ["-N", "3", "--extraDonor", "1",
                                "--extraDonorMode", "size"]),
    "known_GT_ase": ([0, 1, 2], ["-t", "GT", "--ASEmode"]),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cli_donor_modes_match_jax_cli(tmp_path, monkeypatch, mode):
    """Each input path and donor mode against JAX's CLI run in float64,
    the port's working type on the CPU. (In float32 a donor with no reads
    at a variant gets an exactly uniform genotype, whose hard call is
    0/0, where float64 keeps the vanishing evidence of other donors'
    cells, whose ID_prob for it underflows in float32 only; and the
    restarts' ELBOs tie within float32's resolution, so the winner's
    donor order may differ.) The outputs as the module docstring says.
    GT_donors.vireo.vcf.gz, where written: the same header, fixed
    columns, samples and GT calls; AD and DP (the rounded expected reads
    sum_c count x ID_prob) and PL (round(-10 log10 p) of GT_prob) as
    integers, identical but for at most one in a thousand that lies on
    a rounding midpoint, one unit apart."""
    jcli = _jax_cli_in_float64(monkeypatch)
    donors, flags = MODES[mode]
    data = tmp_path / "cellsnp"
    d = _write_cellsnp(data)
    rng = np.random.RandomState(5)
    # a 4th donor in the file that the pool does not hold (subset mode)
    d["GT"] = np.concatenate([d["GT"], rng.binomial(2, 0.5, (300, 1))], 1)
    names = ["S_%s" % "abcd"[k] for k in range(4)]
    if donors is not None:
        _write_donor_vcf(str(tmp_path / "donors.vcf.gz"), d["GT"], donors,
                         [names[k] for k in donors], rng)
        flags = ["-d", str(tmp_path / "donors.vcf.gz")] + flags
    if mode == "vartrix":
        _write_vartrix(tmp_path / "vartrix", d)
        inputs = ["--vartrixData", ",".join(
            str(x) for x in (tmp_path / "vartrix" / "alt.mtx",
                             tmp_path / "vartrix" / "ref.mtx",
                             tmp_path / "vartrix" / "barcodes.tsv",
                             data / "cellSNP.base.vcf.gz"))]
    elif mode == "cell_vcf":
        _write_cell_vcf(str(tmp_path / "cells.vcf.gz"), d)
        inputs = ["-c", str(tmp_path / "cells.vcf.gz")]
    else:
        inputs = ["-c", str(data)]
    common = inputs + flags + ["--nInit", "5", "--randSeed", "3",
                               "--noPlot"]
    jcli.main(common + ["-o", str(tmp_path / "jax")])
    tcli.main(common + ["-o", str(tmp_path / "torch")])
    _compare_outputs(tmp_path / "torch", tmp_path / "jax",
                     doublet="--noDoublet" not in flags)

    head, rows = _read_table(tmp_path / "torch" / "donor_ids.tsv")
    calls = [r[1] for r in rows]
    if donors is not None:
        want = set(names[k] for k in donors) if mode != "subset" \
            else set(names[:3])
        assert set(calls) - {"doublet", "unassigned"} <= want | {"donor2"}
        # donor k of the file is donor k of the pool
        singlet = d["donor2"] < 0
        truth = np.array(names, dtype=object)[d["donor"]]
        if mode == "superset":
            truth[d["donor"] == 2] = "donor2"
        hit = np.mean([c == t for c, t, s in zip(
            [r[5] for r in rows], truth, singlet) if s])
        assert hit > 0.95, hit
    gt_vcf = tmp_path / "torch" / "GT_donors.vireo.vcf.gz"
    learnt = mode not in ("known_GT", "known_PL", "subset", "known_GT_ase")
    assert gt_vcf.exists() == learnt
    assert (tmp_path / "jax" / "GT_donors.vireo.vcf.gz").exists() == learnt
    if learnt:
        _compare_gt_vcf(gt_vcf, tmp_path / "jax" / "GT_donors.vireo.vcf.gz")


def _same_as_printed(t, j, what):
    """Numbers printed by the two CLIs (lists of strings): identical but
    for at most one in a thousand, each one unit of the last printed
    digit apart, as two float64 runs that differ by round-off give only
    where a value lies on a rounding midpoint."""
    assert len(t) == len(j), what
    off = [(a, b) for a, b in zip(t, j) if a != b]
    assert len(off) <= len(t) // 1000, (what, len(off), off[:5])
    for a, b in off:
        mant = b.split("e")[0] if "e" in b else b
        digits = len(mant.split(".")[1]) if "." in mant else 0
        unit = 10.0 ** -digits * (10.0 ** int(b.split("e")[1])
                                  if "e" in b else 1.0)
        assert abs(float(a) - float(b)) <= 1.000001 * unit, (what, a, b)


def _table_numbers(path):
    with gzip.open(path, "rt") as fh:
        lines = fh.read().splitlines()
    return lines[0], [x for line in lines[1:] for x in line.split("\t")]


def _compare_outputs(t_dir, j_dir, doublet=True):
    """donor_ids.tsv, summary.tsv and the probability tables of the two
    CLIs, as the module docstring says."""
    head_j, rows_j = _read_table(j_dir / "donor_ids.tsv")
    head_t, rows_t = _read_table(t_dir / "donor_ids.tsv")
    assert head_t == head_j and len(rows_t) == len(rows_j)
    col = {name: i for i, name in enumerate(head_j)}
    for name in ("cell", "donor_id", "best_singlet", "best_doublet",
                 "n_vars"):
        assert [r[col[name]] for r in rows_t] == \
            [r[col[name]] for r in rows_j], name
    for name in ("prob_max", "prob_doublet", "doublet_logLikRatio"):
        _same_as_printed([r[col[name]] for r in rows_t],
                         [r[col[name]] for r in rows_j], name)
    for name in ("prob_max", "prob_doublet"):
        pj = np.array([float(r[col[name]]) for r in rows_j])
        assert np.min(np.abs(pj - 0.9)) > 1e-3     # no call on the edge
    if not doublet:
        assert {r[col["prob_doublet"]] for r in rows_t} == {"0.00e+00"}
    assert (t_dir / "summary.tsv").read_text() == \
        (j_dir / "summary.tsv").read_text()
    for name in ("prob_singlet.tsv.gz", "prob_doublet.tsv.gz"):
        head_t, nums_t = _table_numbers(t_dir / name)
        head_j, nums_j = _table_numbers(j_dir / name)
        assert head_t == head_j
        _same_as_printed(nums_t, nums_j, name)


def _compare_gt_vcf(t_path, j_path):
    """See test_cli_donor_modes_match_jax_cli for the tolerances."""
    head_t, rows_t = _vcf_rows(t_path)
    head_j, rows_j = _vcf_rows(j_path)
    assert head_t == head_j and len(rows_t) == len(rows_j) > 0
    fmt = rows_t[0][8].split(":")
    assert fmt == ["GT", "AD", "DP", "PL"]
    fields = {}
    for rt, rj in zip(rows_t, rows_j):
        assert rt[:9] == rj[:9]
        for ct, cj in zip(rt[9:], rj[9:]):
            for name, a, b in zip(fmt, ct.split(":"), cj.split(":")):
                fields.setdefault(name, []).append((a, b))
    assert [a for a, _ in fields["GT"]] == [b for _, b in fields["GT"]]
    for name in ("AD", "DP", "PL"):
        _same_as_printed([x for a, _ in fields[name] for x in a.split(",")],
                         [x for _, b in fields[name] for x in b.split(",")],
                         name)


@pytest.mark.parametrize("flags,item", [
    (["--mesh", "2x4"], (2, 4)),
])
def test_cli_unported_flags_exit_naming_roadmap(tmp_path, flags, item):
    """`--mesh VxC`, refused before the multi-GPU slice, parses to the
    2-D mesh's shape; one process cannot hold its 8 ranks, so the CLI
    exits naming the launcher (tests/test_torch_mesh_cli.py runs it on
    two ranks)."""
    options = tcli.build_parser().parse_args(["-c", str(tmp_path)] + flags)
    assert tcli._resolve_cli_mesh(options.mesh) == item
    assert tcli._resolve_cli_mesh("auto") == "auto"
    assert tcli._resolve_cli_mesh("off") is None
    with pytest.raises(SystemExit) as exc:
        tcli.main(["-c", str(tmp_path), "-N", "2", "-o",
                   str(tmp_path / "out")] + flags)
    assert "needs 8 ranks" in str(exc.value)
    assert "torch.distributed.run" in str(exc.value)


@pytest.mark.parametrize("case", ["no_variants", "no_tag", "no_match"])
def test_cli_donor_file_error_exits(tmp_path, capsys, case):
    """The donor file's three error exits, as the JAX CLI's."""
    from vireo_tpu.cli import vireo_cli as jcli
    data = tmp_path / "cellsnp"
    d = _write_cellsnp(data, V=60, C=80, K=2)
    donor = str(tmp_path / "donors.vcf.gz")
    rng = np.random.RandomState(0)
    _write_donor_vcf(donor, d["GT"], [0, 1], ["A", "B"], rng, V=60,
                     chrom="chr1" if case != "no_match" else "chr7")
    if case == "no_tag":
        with gzip.open(donor, "rt") as fh:
            text = fh.read().replace("GT:PL", "GP:PL")
        with gzip.open(donor, "wt") as fh:
            fh.write(text)
    inputs = ["-c", str(data)]
    if case == "no_variants":
        _write_vartrix(tmp_path / "vartrix", d, C=80)
        inputs = ["--vartrixData", ",".join(
            str(tmp_path / "vartrix" / f)
            for f in ("alt.mtx", "ref.mtx", "barcodes.tsv"))]
    out = {}
    for name, cli in (("torch", tcli), ("jax", jcli)):
        with pytest.raises(SystemExit) as exc:
            cli.main(inputs + ["-d", donor, "-t", "GT", "-o",
                               str(tmp_path / name)])
        out[name] = (exc.value.code, capsys.readouterr().out.splitlines())
    assert out["torch"][0] == out["jax"][0] == 1
    assert out["torch"][1][-1] == out["jax"][1][-1]
    assert "Error" in "\n".join(out["torch"][1])


def test_cli_genotype_free_writes_the_donor_vcf(tmp_path):
    data = tmp_path / "cellsnp"
    _write_cellsnp(data, V=60, C=80, K=2)
    tcli.main(["-c", str(data), "-N", "2", "-o", str(tmp_path / "out"),
               "--randSeed", "1", "--nInit", "2", "--noPlot"])
    head, rows = _vcf_rows(tmp_path / "out" / "GT_donors.vireo.vcf.gz")
    assert head[-1].split("\t")[9:] == ["donor0", "donor1"]
    assert len(rows) == 60 and rows[0][8] == "GT:AD:DP:PL"


def test_cli_checkpoint_dir_resumes(tmp_path):
    data = tmp_path / "cellsnp"
    _write_cellsnp(data, V=60, C=80, K=2)
    common = ["-c", str(data), "-N", "2", "--randSeed", "1", "--nInit", "2",
              "--noPlot", "--checkpointDir", str(tmp_path / "ck")]
    tcli.main(common + ["-o", str(tmp_path / "a")])
    assert sorted(p.name for p in (tmp_path / "ck").iterdir())[-1] \
        == "vireo_ckpt_00000001.npz"
    tcli.main(common + ["-o", str(tmp_path / "b")])
    for name in ("donor_ids.tsv", "summary.tsv"):
        assert (tmp_path / "a" / name).read_text() == \
            (tmp_path / "b" / name).read_text()


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


def test_cli_call_ambient_rnas_matches_jax_cli(tmp_path, monkeypatch):
    """--callAmbientRNAs (and --ambientMinGain) against JAX's CLI run in
    float64, both doublet phases unfused: the same header, cells and SNP
    gate; psi and the LLR the same as printed (%.4e, %.2f), as the
    module docstring says."""
    jcli = _jax_cli_in_float64(monkeypatch)
    data = tmp_path / "cellsnp"
    _write_cellsnp(data)
    for gain in ([], ["--ambientMinGain", "3"]):
        common = ["-c", str(data), "-N", "3", "--nInit", "5", "--randSeed",
                  "3", "--noPlot", "--callAmbientRNAs"] + gain
        tag = "gain" if gain else "default"
        jcli.main(common + ["-o", str(tmp_path / ("jax_" + tag))])
        tcli.main(common + ["-o", str(tmp_path / ("torch_" + tag))])
        t_head, t_rows = _read_table(
            tmp_path / ("torch_" + tag) / "prop_ambient.tsv")
        j_head, j_rows = _read_table(
            tmp_path / ("jax_" + tag) / "prop_ambient.tsv")
        assert t_head == j_head == ["cell", "donor0", "donor1", "donor2",
                                    "logLik_ratio"]
        assert [r[0] for r in t_rows] == [r[0] for r in j_rows]
        assert len(t_rows) == 400
        _same_as_printed([x for r in t_rows for x in r[1:4]],
                         [x for r in j_rows for x in r[1:4]], "psi")
        _same_as_printed([r[4] for r in t_rows], [r[4] for r in j_rows],
                         "logLik_ratio")
        t = np.array([[float(x) for x in r[1:4]] for r in t_rows])
        np.testing.assert_allclose(t.sum(1), 1.0, atol=1e-3)
