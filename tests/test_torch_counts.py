"""vireo_tpu_torch.ops.counts (dense rung) against vireo_tpu.ops.counts.

Contractions run in float64 on both sides over the same exact integer
counts; only the order of the float sums differs, so rtol 1e-12.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from vireo_tpu.ops.counts import counts_from_scipy as jax_counts_from_scipy
from vireo_tpu.ops.counts import dense_counts as jax_dense_counts
from vireo_tpu_torch.ops.counts import (DenseCounts, counts_from_scipy,
                                        exact_count_dtype)

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's entry points run on the card unless asked for the CPU
    (utils/device.py); these tests ask for it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIREO_PLATFORM", "cpu")
        yield

RTOL = 1e-12


def _pool(seed=7, V=97, C=131, vmax=None):
    rng = np.random.RandomState(seed)
    DP = (rng.rand(V, C) < 0.2) * (1 + rng.poisson(1.5, (V, C)))
    if vmax is not None:
        DP[0, 0] = vmax
    AD = rng.binomial(DP, 0.4)
    return sp.csc_matrix(AD.astype(float)), sp.csc_matrix(DP.astype(float))


@pytest.fixture
def pool():
    AD, DP = _pool()
    jc = jax_dense_counts(AD, DP, dtype=jnp.float64)
    tc = counts_from_scipy(AD, DP)
    return AD, DP, jc, tc


def test_contractions_match_jax(pool):
    AD, DP, jc, tc = pool
    rng = np.random.RandomState(1)
    W = rng.rand(AD.shape[1], 5)
    Wa, Wd = rng.randn(AD.shape[0], 5), rng.randn(AD.shape[0], 5)
    for j, t in zip(jc.suff_stats(jnp.asarray(W)),
                    tc.suff_stats(torch.as_tensor(W))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL)
    np.testing.assert_allclose(
        tc.cell_loglik(torch.as_tensor(Wa), torch.as_tensor(Wd)).numpy(),
        np.asarray(jc.cell_loglik(jnp.asarray(Wa), jnp.asarray(Wd))),
        rtol=RTOL, atol=1e-12)


def test_reductions_match_jax(pool):
    AD, DP, jc, tc = pool
    np.testing.assert_allclose(float(tc.binom_coeff_sum()),
                               float(jc.binom_coeff_sum()), rtol=RTOL)
    for j, t in zip(jc.row_sums(), tc.row_sums()):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(tc.n_vars_per_cell().numpy(),
                                  np.asarray(jc.n_vars_per_cell()))


def test_int8_placement_equals_jax_dense_rung():
    AD, DP = _pool(seed=2)
    jc = jax_counts_from_scipy(AD, DP, max_dense_elems=10)
    tc = counts_from_scipy(AD, DP)
    assert tc.ad.dtype == torch.int8 and jc.ad.dtype == jnp.int8
    np.testing.assert_array_equal(tc.ad.numpy(), np.asarray(jc.ad))
    np.testing.assert_array_equal(tc.dp.numpy(), np.asarray(jc.dp))


def test_union_pattern_and_exact_dtype():
    # AD with explicit zeros where DP is covered: the union pattern
    AD, DP = _pool(seed=4, vmax=200)
    AD = AD.tolil()
    AD[1, 1] = 0
    AD = AD.tocsr()
    tc = counts_from_scipy(AD, DP)
    assert tc.ad.dtype == exact_count_dtype(200) == torch.bfloat16
    np.testing.assert_array_equal(tc.dp.float().numpy(), DP.toarray())
    np.testing.assert_array_equal(tc.ad.float().numpy(), AD.toarray())


@pytest.mark.parametrize("row_chunk", [1, 7, 32, 1000])
def test_chunked_conversion_is_chunk_independent(pool, row_chunk):
    _, _, _, tc = pool
    ref = DenseCounts(tc.ad, tc.dp, row_chunk=10 ** 6)
    chunked = DenseCounts(tc.ad, tc.dp, row_chunk=row_chunk)
    rng = np.random.RandomState(row_chunk)
    W = torch.as_tensor(rng.rand(tc.n_cell, 3))
    Wa = torch.as_tensor(rng.randn(tc.n_var, 3))
    Wd = torch.as_tensor(rng.randn(tc.n_var, 3))
    for a, b in zip(ref.suff_stats(W), chunked.suff_stats(W)):
        torch.testing.assert_close(b, a, rtol=RTOL, atol=0)
    torch.testing.assert_close(chunked.cell_loglik(Wa, Wd),
                               ref.cell_loglik(Wa, Wd), rtol=RTOL,
                               atol=1e-12)
    torch.testing.assert_close(chunked.binom_coeff_sum(),
                               ref.binom_coeff_sum(), rtol=RTOL, atol=0)
