"""The plain reference against the program on a tiny pool, both in
float64 on the CPU: the same seeded inits, fits, choice, refit, doublet
phase and sweep, to float64 round-off."""

import numpy as np
import pytest
import torch

from portbench.harness.pool import make_pool, to_host
from portbench.reference import vireo as ref
from portbench.reference.counts import Arith, RefCounts, to_tf32

POOL = dict(n_var=150, n_cell=500, n_donor=4, doublet_rate=0.08,
            density=0.3, mean_extra_depth=0.6)


@pytest.fixture(scope="module")
def pool():
    p = make_pool(seed=2**31 + 11, device=torch.device("cpu"), **POOL)
    return to_host(p)


def test_counts_and_contractions(pool):
    AD, DP = pool
    c = RefCounts(AD, DP, "cpu")
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
