"""The roofline's work functions and peaks at known shapes."""

import pytest

from portbench.harness.manifest import Manifest

PEAKS = {"int8_ops_per_s": 1.979e15, "hbm_bytes_per_s": 3.35e12}


def _work():
    return Manifest().work("contraction")


@pytest.mark.parametrize("kind,n,ops,nbytes", [
    # 2 * (nnz_ad + nnz_dp) * N; 2 * nnz_dp + weights + outputs (float32)
    ("suff_stats", 16, 2 * (10 + 30) * 16, 2 * 30 + 4 * 7 * 16 + 8 * 5 * 16),
    ("cell_loglik", 16, 2 * (10 + 30) * 16,
     2 * 30 + 8 * 5 * 16 + 4 * 7 * 16),
    ("suff_stats", 800, 2 * (10 + 30) * 800,
     2 * 30 + 4 * 7 * 800 + 8 * 5 * 800),
])
def test_work_at_known_shapes(kind, n, ops, nbytes):
    got = _work().work(kind, n, n_var=5, n_cell=7, nnz_ad=10, nnz_dp=30)
    assert got == (ops, nbytes)


def test_least_seconds_names_its_bound():
    w = _work()
    # the main pool at N 16: bytes bind
    t, by = w.least_seconds("suff_stats", 16, 30000, 100000, 15_000_000,
                            30_000_000, PEAKS)
    nbytes = 2 * 30e6 + 4 * 100000 * 16 + 8 * 30000 * 16
    assert by == "bytes" and t == pytest.approx(nbytes / 3.35e12)
    # a dense pool at a wide N: operations bind
    t, by = w.least_seconds("cell_loglik", 4096, 30000, 100000, 1.5e9, 3e9,
                            PEAKS)
    assert by == "operations"
    assert t == pytest.approx(2 * 4.5e9 * 4096 / 1.979e15)


def test_work_refuses_an_unknown_kind():
    with pytest.raises(ValueError):
        _work().work("densify", 16, 5, 7, 10, 30)


def test_peaks_by_card_name():
    m = Manifest()
    assert m.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    assert m.peaks("cpu") is None
