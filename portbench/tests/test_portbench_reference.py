"""The plain reference against the program on a tiny pool, both in
float64 on the CPU: the same seeded inits, fits, choice, refit, doublet
phase and sweep, to float64 round-off. The reference's counts hold a
heavy-tailed pool exactly too."""

import numpy as np
import pytest
import torch

from portbench.harness.pool import make_pool, to_host
from portbench.reference import vireo as ref
from portbench.reference.counts import Arith, RefCounts, to_tf32

POOL = dict(n_var=150, n_cell=500, n_donor=4, doublet_rate=0.08,
            density=0.3, mean_extra_depth=0.6)
HEAVY = dict(POOL, mean_extra_depth=3.0, max_depth=16, hot_share=0.05,
             hot_depth=[200, 2000], theta=[0.02, 0.5, 0.98])


@pytest.fixture(scope="module")
def pool():
    p = make_pool(seed=2**31 + 11, device=torch.device("cpu"), **POOL)
    return to_host(p)


@pytest.fixture(scope="module")
def heavy_pool():
    p = make_pool(seed=2**31 + 11, device=torch.device("cpu"), **HEAVY)
    return to_host(p)


@pytest.mark.parametrize("which,dtype", [("pool", torch.int8),
                                         ("heavy_pool", torch.int16)])
def test_counts_and_contractions(request, which, dtype):
    AD, DP = request.getfixturevalue(which)
    c = RefCounts(AD, DP, "cpu")
    assert c.ad.dtype == c.dp.dtype == dtype
    assert (DP.max() > 256) == (which == "heavy_pool")
    np.testing.assert_array_equal(c.ad.numpy(), AD.toarray())
    np.testing.assert_array_equal(c.dp.numpy(), DP.toarray())
    g = torch.Generator().manual_seed(0)
    W = torch.rand((500, 6), generator=g, dtype=torch.float64)
    S1, SS = c.stats(W, Arith("float64"))
    np.testing.assert_allclose(S1.numpy(), AD.toarray() @ W.numpy())
    np.testing.assert_allclose(SS.numpy(), DP.toarray() @ W.numpy())
    Wa, Wd = (torch.rand((150, 6), generator=g, dtype=torch.float64)
              for _ in range(2))
    np.testing.assert_allclose(
        c.loglik(Wa, Wd, Arith("float64")).numpy(),
        AD.toarray().T @ Wa.numpy() + DP.toarray().T @ Wd.numpy())


def test_binom_sum_of_a_heavy_pool(heavy_pool):
    from scipy.special import gammaln
    AD, DP = heavy_pool
    a, d = AD.toarray(), DP.toarray()
    val = np.minimum(gammaln(d + 1) - gammaln(a + 1) - gammaln(d - a + 1),
                     700.0)
    np.testing.assert_allclose(RefCounts(AD, DP, "cpu").binom_sum(),
                               val[d > 0].sum(), rtol=1e-12)


@pytest.mark.parametrize("value,dtype", [(127, torch.int8),
                                         (128, torch.int16),
                                         (32767, torch.int16)])
def test_counts_take_the_smallest_type(value, dtype):
    import scipy.sparse as sp
    DP = sp.csc_matrix(np.array([[value, 0.0], [3.0, 1.0]]))
    AD = sp.csc_matrix(np.array([[1.0, 0.0], [2.0, 1.0]]))
    c = RefCounts(AD, DP, "cpu")
    assert c.ad.dtype == c.dp.dtype == dtype
    np.testing.assert_array_equal(c.dp.numpy(), DP.toarray())


@pytest.mark.parametrize("value", [-1.0, 32768.0, 2.5])
def test_counts_it_cannot_hold_are_refused(value):
    import scipy.sparse as sp
    X = sp.csc_matrix(np.array([[value, 0.0], [3.0, 1.0]]))
    with pytest.raises(ValueError):
        RefCounts(X, abs(X), "cpu")


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.0000001,
                      1e-30], dtype=torch.float32)
    y = to_tf32(x)
    # ties to even; 10 mantissa bits kept
    assert y[0] == 1.0 and y[1] == 1.0 and y[2] == 1.0 + 2**-9
    assert (y.view(torch.int32) & 0x1FFF == 0).all()
    assert float(abs(y[3] + 3.0)) == 0.0


def test_vireo_wrap_matches_the_program(pool):
    from vireo_tpu_torch.engine.wrap import vireo_wrap
    AD, DP = pool
    got = vireo_wrap(AD, DP, n_donor=4, n_init=4, random_seed=7,
                     verbose=False)
    want = ref.vireo_wrap(RefCounts(AD, DP, "cpu"), 4, 4, 7,
                          Arith("float64"))
    np.testing.assert_allclose(got["LB_list"], want["LB_list"], rtol=1e-12)
    assert int(np.argmax(got["LB_list"])) == want["best"]
    np.testing.assert_allclose(got["LB_doublet"], want["LB_doublet"],
                               rtol=1e-12)
    for key in ("ID_prob", "doublet_prob", "doublet_LLR", "GT_prob"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9,
                                   atol=1e-11, err_msg=key)


def test_sweep_matches_the_program(pool):
    from vireo_tpu_torch.engine.select import sweep_n_donor
    AD, DP = pool
    got = sweep_n_donor(AD, DP, n_donor_list=(3, 4, 5), n_init=3,
                        random_seed=9, verbose=False)
    want = ref.sweep_n_donor(RefCounts(AD, DP, "cpu"), (3, 4, 5), 3, 9,
                             Arith("float64"))
    for K in (3, 4, 5):
        np.testing.assert_allclose(got[K], want[K], rtol=1e-12)
    assert got["best"] == want["best"]
