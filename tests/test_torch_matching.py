"""vireo_tpu_torch.ops.matching against vireo_tpu.ops.matching: the
port's numpy/scipy copy must give the same indices, arrays and printed
lines on the same inputs (exact: both run the same numpy operations)."""

import numpy as np
import pytest

from vireo_tpu.ops import matching as jm
from vireo_tpu_torch.ops import matching as tm


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a, dtype=object),
                                      np.asarray(b, dtype=object))


@pytest.mark.parametrize("ref,new,uniq", [
    (["a", "b", "c"], ["c", "a", "b"], True),
    (["a", "x", "c", "y"], ["c", "a", "b"], True),         # missing ids
    (["b", "a", "b", "a", "b"], ["a", "b", "b"], True),    # duplicates, ties
    (["b", "a", "b", "a", "b"], ["a", "b", "b"], False),
    (["1_10_A_G", "1_12_C_T"], [], True),                  # nothing to match
    ([], ["a"], True),
    (np.array([5, 3, 5, 9]), np.array([9, 5, 5, 1]), True),
])
def test_match(ref, new, uniq):
    got = tm.match(ref, new, uniq_ref_only=uniq)
    want = jm.match(ref, new, uniq_ref_only=uniq)
    assert got.dtype == object and len(got) == len(ref)
    _same(got, want)
    for i, j in enumerate(got):
        if j is not None:
            assert new[j] == ref[i]


@pytest.mark.parametrize("axis,delta", [(1, False), (1, True), (0, True)])
def test_optimal_match(axis, delta):
    rng = np.random.RandomState(axis + 2 * delta)
    X = rng.dirichlet(np.ones(3), size=(50, 4))
    Z = X[:, [2, 0, 3, 1]] + rng.rand(50, 4, 3) * 0.05
    if axis == 0:
        X, Z = X[:6], Z[[3, 1, 0, 5, 4, 2]]
    _same(tm.optimal_match(X, Z, axis=axis, return_delta=delta),
          jm.optimal_match(X, Z, axis=axis, return_delta=delta))
    if axis == 1:
        assert list(tm.optimal_match(X, Z)[1]) == [1, 3, 0, 2]


def test_greed_match(capsys):
    rng = np.random.RandomState(1)
    X = rng.rand(20, 3, 3)
    Z = X[:, [1, 2, 0]]
    got = tm.greed_match(X, Z)
    printed = capsys.readouterr().out
    want = jm.greed_match(X, Z)
    assert capsys.readouterr().out == printed
    _same(got, want)


@pytest.mark.parametrize("mode", ["distance", "size"])
@pytest.mark.parametrize("verbose", [True, False])
def test_donor_select(capsys, mode, verbose):
    rng = np.random.RandomState(4)
    GT = rng.dirichlet(np.ones(3), size=(40, 6))
    GT[:, 5] = GT[:, 1] * 0.9 + 0.1 / 3        # a near-copy of donor 1
    ID = rng.dirichlet(np.ones(6) * 0.3, size=200)
    ID[:5, 2] = 1e-14                           # below the 1e-10 floor
    got = tm.donor_select(GT, ID, 4, mode=mode, verbose=verbose)
    printed = capsys.readouterr().out
    want = jm.donor_select(GT, ID, 4, mode=mode, verbose=verbose)
    assert capsys.readouterr().out == printed
    assert bool(printed) == verbose
    assert got.shape == (200, 4) and got.min() >= 1e-10
    np.testing.assert_array_equal(got, want)


def test_get_confusion():
    a = np.array(["d1", "d0", "d1", "doublet", "d0", "d1"])
    b = np.array([0, 1, 0, 2, 1, 1])
    _same(tm.get_confusion(a, b), jm.get_confusion(a, b))
    mat, u1, u2 = tm.get_confusion(a, b)
    assert mat.sum() == len(a) and list(u1) == ["d0", "d1", "doublet"]
