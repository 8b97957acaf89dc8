"""The port's pool generators against the JAX package's: `pool_bam` (host
numpy, through the in-memory BAM backend of tests/test_sim.py) gives
the same pooled reads, barcodes and truth table for the same seed; and
`synth_pool_dense_device` samples the model of `synth_pool_counts`: its
shapes and types, and its density, mean depth and doublet share within
the tolerances below of the numpy pool's, with donors that a seeded
vireo_wrap recovers."""

import itertools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vireo_tpu.sim import pool_bam as jpb
from vireo_tpu_torch.sim import pool_bam as tpb
from vireo_tpu_torch.sim.synth import (synth_pool_counts,
                                       synth_pool_dense_device)

from test_sim import FakeBackend, FakeBam, FakeRead, _region_vcf

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(1)

# the device pool against the numpy pool of the same parameters: density
# relative 10% (the numpy pool draws its coverage by a Gamma popularity
# with replacement and drops repeats, ~5% at density 0.05; the device one
# is Bernoulli per entry), mean depth relative 3% (1 + Poisson(0.6) over
# ~100k covered entries: sd ~0.3%), doublet share absolute 0.02 (a
# Bernoulli share of 2000 cells at 0.1: sd 0.0067)
DENSITY_RTOL, DEPTH_RTOL, DOUBLET_ATOL = 0.10, 0.03, 0.02
POOL = dict(n_var=1000, n_cell=2000, n_donor=4, doublet_rate=0.1,
            density=0.05)


@pytest.fixture(autouse=True)
def _ask_for_the_cpu(monkeypatch):
    monkeypatch.setenv("VIREO_PLATFORM", "cpu")


def test_sample_and_pool_barcodes_match_jax():
    lists = [["a%d" % i for i in range(20)], ["b%d" % i for i in range(30)]]
    got = tpb.sample_barcodes(lists, [5, 7], rng=np.random.RandomState(0))
    want = jpb.sample_barcodes(lists, [5, 7], rng=np.random.RandomState(0))
    assert [list(x) for x in got] == [list(x) for x in want]
    with pytest.raises(ValueError):
        tpb.sample_barcodes(lists, [25, 1], rng=np.random.RandomState(0))

    kept = [np.array(["a%d" % i for i in range(50)]),
            np.array(["b%d" % i for i in range(50)])]
    got = tpb.pool_barcodes(kept, 0.25, rng=np.random.RandomState(1))
    want = jpb.pool_barcodes(kept, 0.25, rng=np.random.RandomState(1))
    assert got == want
    assert sum(is_dbl for _, _, is_dbl in got[1]) == round(100 / 5)


def test_shard_regions_match_jax():
    chroms = ["1"] * 7 + ["2"] * 6
    positions = list(range(100, 113))
    for n in (1, 3, 4, 20):
        assert tpb.shard_regions(chroms, positions, n) == \
            jpb.shard_regions(chroms, positions, n)


def _reads():
    barcodes = ["BC%02d" % i for i in range(8)]
    reads = [FakeRead("r%03d" % (i % 120), "1", 10 + (i * 13) % 400,
                      {"CB": barcodes[i % len(barcodes)]})
             for i in range(300)]
    reads += [FakeRead("x1", "1", 11, {}), FakeRead("x2", "1", 11,
                                                     {"CB": "ZZZ"})]
    return barcodes, reads


@pytest.mark.parametrize("nproc,doublet_rate,regions", [
    (1, 0.0, True), (4, 0.0, True), (4, 0.3, True), (1, 0.3, False)])
def test_pool_bams_match_jax(tmp_path, nproc, doublet_rate, regions):
    """The same pooled reads (names and relabelled barcodes, in order)
    and the same cell_info.tsv as the JAX package's pool_bams."""
    vcf = _region_vcf(tmp_path, [("1", p) for p in range(11, 411, 7)]) \
        if regions else None
    out = {}
    for tag, module in (("t", tpb), ("j", jpb)):
        barcodes, reads = _reads()
        backend = FakeBackend({"x.bam": FakeBam(reads)})
        res = module.pool_bams(["x.bam"], [barcodes], [len(barcodes)],
                               str(tmp_path / tag), doublet_rate=doublet_rate,
                               region_vcf=vcf, nproc=nproc,
                               rng=np.random.RandomState(7), backend=backend)
        assert res == str(tmp_path / tag) + ".sorted.bam"
        assert not backend.temps
        out[tag] = ([(r.query_name, r.get_tag("CB")) for r in backend.sink],
                    (tmp_path / (tag + ".cell_info.tsv")).read_text())
    assert out["t"] == out["j"]
    names = [n for n, _ in out["t"][0]]
    assert len(names) == len(set(names)) > 0


def test_pool_bams_requires_pysam(tmp_path):
    with pytest.raises(ImportError, match="pysam"):
        tpb.pool_bams(["x.bam"], [["a"]], [1], str(tmp_path / "x"))


def test_pool_bam_cli_help_and_errors():
    for args, code, text in (
            (["--help"], 0, "--doubletRate"),
            (["-s", "a.bam", "-b", "a.tsv", "-r", "x.vcf", "--noregionFile"],
             2, "mutually exclusive")):
        proc = subprocess.run(
            [sys.executable, "-m", "vireo_tpu_torch.sim.pool_bam"] + args,
            cwd=str(REPO), capture_output=True, text=True, timeout=300)
        assert proc.returncode == code
        assert text in proc.stdout + proc.stderr


@pytest.fixture(scope="module")
def device_pool():
    return synth_pool_dense_device(seed=3, device="cpu", row_chunk=128,
                                   **POOL)


def test_device_pool_shapes_and_truth(device_pool):
    d = device_pool
    V, C, K = POOL["n_var"], POOL["n_cell"], POOL["n_donor"]
    c = d["counts"]
    assert c.ad.shape == c.dp.shape == (V, C)
    assert c.ad.dtype == c.dp.dtype == torch.int8
    assert c.device == torch.device("cpu")
    assert d["GT"].shape == (V, K) and set(np.unique(d["GT"])) <= {0, 1, 2}
    assert d["donor"].shape == d["donor2"].shape == (C,)
    assert ((d["donor"] >= 0) & (d["donor"] < K)).all()
    dbl = d["donor2"] >= 0
    assert (d["donor"][dbl] != d["donor2"][dbl]).all()
    ad, dp = c.ad.numpy(), c.dp.numpy()
    assert (ad <= dp).all() and (ad >= 0).all() and dp.max() <= 12
    # same seed, same pool
    again = synth_pool_dense_device(seed=3, device="cpu", row_chunk=300,
                                    **POOL)
    np.testing.assert_array_equal(again["donor"], d["donor"])
    np.testing.assert_array_equal(again["GT"], d["GT"])


def test_device_pool_statistics_match_numpy_pool(device_pool):
    want = synth_pool_counts(seed=3, **POOL)
    dp = device_pool["counts"].dp.numpy()
    V, C = POOL["n_var"], POOL["n_cell"]
    dens = (dp > 0).mean()
    np.testing.assert_allclose(dens, want["DP"].nnz / (V * C),
                               rtol=DENSITY_RTOL)
    np.testing.assert_allclose(dp[dp > 0].mean(), want["DP"].data.mean(),
                               rtol=DEPTH_RTOL)
    np.testing.assert_allclose((device_pool["donor2"] >= 0).mean(),
                               (want["donor2"] >= 0).mean(),
                               atol=DOUBLET_ATOL)
    # allele fractions by genotype: theta (0.01, 0.5, 0.99) on singlets
    ad = device_pool["counts"].ad.numpy()
    single = device_pool["donor2"] < 0
    gt = device_pool["GT"][:, device_pool["donor"]][:, single]
    a, d = ad[:, single], dp[:, single]
    for g, theta in enumerate((0.01, 0.5, 0.99)):
        m = (gt == g) & (d > 0)
        np.testing.assert_allclose(a[m].sum() / d[m].sum(), theta,
                                   atol=0.02)


def test_seeded_wrap_recovers_the_device_pool_donors(device_pool):
    from vireo_tpu_torch.engine.wrap import vireo_wrap
    d = device_pool
    res = vireo_wrap(d["counts"], n_donor=POOL["n_donor"], n_init=4,
                     random_seed=1, check_doublet=False, verbose=False)
    pred = np.argmax(res["ID_prob"], axis=1)
    single = d["donor2"] < 0
    acc = max(np.mean(np.array(p)[pred][single] == d["donor"][single])
              for p in itertools.permutations(range(POOL["n_donor"])))
    assert acc >= 0.95, acc
