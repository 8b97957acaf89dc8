"""The port's `GTbarcode` CLI: the in-tree golden byte for byte, its
flags against the JAX CLI's outputs, and `--noPlot` without matplotlib."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from vireo_tpu_torch.cli import gtbarcode_cli as tcli

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "goldens"


def test_gtbarcode_reproduces_the_golden(tmp_path):
    out = tmp_path / "GT_barcodes.tsv"
    tcli.main(["-i", str(GOLDEN / "GT_donors.ref.vcf.gz"), "-o", str(out),
               "--randSeed", "1", "--noPlot"])
    assert out.read_bytes() == (GOLDEN / "GT_barcodes.tsv").read_bytes()


@pytest.mark.parametrize("flags", [
    ["--noHomoAlt", "--randSeed", "1"],
    ["--randSeed", "7"],
    ["-t", "GT", "--randSeed", "3", "--noHomoAlt"],
])
def test_gtbarcode_flags_match_jax_cli(tmp_path, flags):
    from vireo_tpu.cli import gtbarcode_cli as jcli
    vcf = str(GOLDEN / "GT_donors.ref.vcf.gz")
    jcli.main(["-i", vcf, "-o", str(tmp_path / "j.tsv"), "--noPlot"] + flags)
    tcli.main(["-i", vcf, "-o", str(tmp_path / "t.tsv"), "--noPlot"] + flags)
    assert (tmp_path / "t.tsv").read_bytes() == \
        (tmp_path / "j.tsv").read_bytes()


def test_gtbarcode_default_out_file_and_plot_note(tmp_path, capsys,
                                                  monkeypatch):
    """Without -o the TSV goes beside the VCF; without --noPlot the
    mini-code figure goes beside the TSV, as the JAX CLI names it; where
    matplotlib cannot be imported the port writes the TSV and a one-line
    note naming matplotlib instead of the figure."""
    vcf = tmp_path / "donors.vcf.gz"
    vcf.write_bytes((GOLDEN / "GT_donors.ref.vcf.gz").read_bytes())
    tcli.main(["-i", str(vcf), "--randSeed", "1"])
    out = capsys.readouterr().out
    assert "no outFile provided" in out
    assert "matplotlib" not in out
    assert (tmp_path / "GTbarcode.tsv").read_bytes() == \
        (GOLDEN / "GT_barcodes.tsv").read_bytes()
    assert (tmp_path / "GTbarcode.png").stat().st_size > 0

    monkeypatch.setitem(sys.modules, "matplotlib", None)   # not installed
    out_file = tmp_path / "no_mpl" / "GTbarcode.tsv"
    tcli.main(["-i", str(vcf), "-o", str(out_file), "--randSeed", "1",
               "--figFormat", "pdf"])
    notes = [x for x in capsys.readouterr().out.splitlines()
             if "matplotlib" in x]
    assert len(notes) == 1 and "not installed" in notes[0]
    assert out_file.read_bytes() == (GOLDEN / "GT_barcodes.tsv").read_bytes()
    assert not (tmp_path / "no_mpl" / "GTbarcode.pdf").exists()


def test_gtbarcode_usage_exits():
    for argv in ([], ["--randSeed", "1"]):
        with pytest.raises(SystemExit) as exc:
            tcli.main(argv)
        assert exc.value.code == 1


def test_no_plot_run_imports_no_matplotlib(tmp_path):
    code = ("import sys; from vireo_tpu_torch.cli import gtbarcode_cli as c; "
            "c.main(sys.argv[1:]); "
            "assert 'matplotlib' not in sys.modules, 'matplotlib imported'")
    out = tmp_path / "b.tsv"
    proc = subprocess.run(
        [sys.executable, "-c", code, "-i",
         str(GOLDEN / "GT_donors.ref.vcf.gz"), "-o", str(out), "--randSeed",
         "1", "--noPlot"], cwd=str(REPO), capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(REPO)), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert out.read_bytes() == (GOLDEN / "GT_barcodes.tsv").read_bytes()
