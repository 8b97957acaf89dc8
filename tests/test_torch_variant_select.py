"""Variant selection (models/variant_select.py) against the JAX package:
barcode entropies and the greedy selection identical (ties broken by the
same seeded draws), and the per-variant ELBO gain on every rung of the
port against JAX's on dense float64 counts, rtol 1e-9 (float64 on the
CPU, K2's plain version on the packed rungs)."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from vireo_tpu.models import variant_select as jvs
from vireo_tpu.ops.counts import dense_counts as jax_dense_counts
from vireo_tpu_torch.models import variant_select as tvs
from vireo_tpu_torch.ops import counts as tcounts
from vireo_tpu_torch.sim.synth import synth_pool_counts

torch.set_num_threads(1)


@pytest.mark.parametrize("X,y", [
    ([0, 1, 1, 2, 0], None),
    (["0", "1", "1", "2"], [1, 1, 0, 0]),
    ([5, 5, 5], [1, 2]),
])
def test_barcode_entropy_matches_jax(X, y):
    assert tvs.barcode_entropy(X, y) == jvs.barcode_entropy(X, y)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_variant_select_matches_jax(seed, capsys):
    """Many tied variants (genotypes of few categories over few donors),
    with and without the count filter: the same chosen list, barcodes,
    entropy and prints."""
    rng = np.random.RandomState(seed)
    V, K = 60, 7
    GT = rng.randint(0, 3, size=(V, K))
    GT[:10] = GT[10:20]                        # duplicated rows tie
    count = rng.poisson(30, V).astype(float)
    for var_count in (None, count):
        want = jvs.variant_select(GT, var_count, rand_seed=seed)
        out_j = capsys.readouterr().out
        got = tvs.variant_select(GT, var_count, rand_seed=seed)
        out_t = capsys.readouterr().out
        assert got == want and out_t == out_j
        assert "Randomly select 1 more variants" in out_t


def test_variant_select_stream_and_warning(capsys):
    """The numpy stream after the selection is JAX's, and two identical
    donors get the warning."""
    GT = np.array([[0, 0, 1], [1, 1, 2], [2, 2, 0]])
    np.random.seed(0)
    want = jvs.variant_select(GT, rand_seed=5)
    tail_j = np.random.rand()
    out_j = capsys.readouterr().out
    got = tvs.variant_select(GT, rand_seed=5)
    assert np.random.rand() == tail_j
    out_t = capsys.readouterr().out
    assert got == want and out_t == out_j
    assert "can't distinguish all samples" in out_t


def _heavy(d, seed=8):
    rng = np.random.RandomState(seed)
    AD, DP = d["AD"].toarray(), d["DP"].toarray()
    extra = ((DP > 0) & (rng.rand(*DP.shape) < 0.03)) \
        * rng.randint(150, 400, DP.shape)
    return (sp.csc_matrix(AD + rng.binomial(extra, 0.5)),
            sp.csc_matrix(DP + extra))


@pytest.mark.parametrize("rung,heavy,budget", [
    ("dense", False, None),
    ("packed", False, 1),
    ("int8-hybrid", True, 2),
    ("packed-hybrid", True, 1),
    ("coo", True, 0),
])
def test_variant_elbo_gain_matches_jax_on_every_rung(rung, heavy, budget):
    d = synth_pool_counts(n_var=150, n_cell=201, n_donor=4, density=0.2,
                          seed=2)
    AD, DP = _heavy(d) if heavy else (d["AD"], d["DP"])
    ID = np.random.RandomState(1).dirichlet(np.ones(4), AD.shape[1])
    want = np.asarray(jvs.variant_ELBO_gain(
        jax_dense_counts(AD, DP, dtype=jnp.float64), jnp.asarray(ID)))
    nbytes = None if budget is None else max(budget * AD.shape[0]
                                             * AD.shape[1], 1)
    counts = tcounts.counts_from_scipy(AD, DP, device="cpu",
                                       dense_budget=nbytes)
    assert tcounts.ladder_rung(AD.shape, float(DP.max()), nbytes
                               or 1 << 40) == rung
    for ID_in in (ID, torch.as_tensor(ID)):
        got = tvs.variant_ELBO_gain(counts, ID_in)
        assert got.dtype == torch.float64 and got.shape == (AD.shape[0],)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9)
