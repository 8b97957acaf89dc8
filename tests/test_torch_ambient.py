"""The ambient-RNA phase of the port (models/ambient.py and its wiring)
against the JAX package's, in float64 on the CPU.

The per-cell EM is compared directly (with and without donor masking,
with empty cells, whose psi is NaN on both sides), the chunked column
reader against JAX's, and the whole phase through
`vireo_wrap(check_ambient=True)` on every rung of the port against JAX's
dense float64 run (its doublet phase unfused, as the port's is off the
int8 dense rung): psi, its variance and the LLR within rtol 1e-9, NaN
rows equal. Through vireo_wrap the LLR, a difference of two
log-likelihoods of a cell each of magnitude up to ~1e3 here, also gets
atol 1e-9: a round-off of 1e-12 of each in relative terms, where the
sum orders of the rungs differ, moves a near-zero LLR by that much. The port's dense
rung is held by a float64 DenseCounts, whose doublet phase is unfused
too.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vireo_tpu.engine import wrap as jwrap
from vireo_tpu.models import ambient as jamb
from vireo_tpu.ops.counts import dense_counts as jax_dense_counts
from vireo_tpu_torch.engine import wrap as twrap
from vireo_tpu_torch.models import ambient as tamb
from vireo_tpu_torch.ops import counts as tcounts
from vireo_tpu_torch.sim.synth import synth_pool_counts

torch.set_num_threads(1)

RTOL = 1e-9


LLR_ATOL = 1e-9


def _close(got, want, what, atol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol,
                               equal_nan=True, err_msg=what)


def _em_inputs(seed=0, C=57, V=30, K=4, n_empty=3):
    """Cells x variants counts (the first `n_empty` cells without reads),
    theta in (0.01, 0.99) and Dirichlet psi0."""
    rng = np.random.RandomState(seed)
    dp = (rng.rand(C, V) < 0.4) * rng.poisson(6, (C, V))
    dp[:n_empty] = 0
    ad = rng.binomial(dp, 0.35)
    theta = rng.rand(V, K) * 0.98 + 0.01
    psi0 = rng.dirichlet([1.0] * K, size=C)
    return ad.astype(np.float64), dp.astype(np.float64), theta, psi0


@pytest.mark.parametrize("n_mask", [0, 1])
def test_fit_em_ambient_batch_matches_jax(n_mask):
    ad, dp, theta, psi0 = _em_inputs()
    want = jamb.fit_em_ambient_batch(
        jnp.asarray(ad), jnp.asarray(dp), jnp.asarray(theta),
        jnp.asarray(psi0), n_mask=n_mask)
    got = tamb.fit_em_ambient_batch(
        torch.as_tensor(ad), torch.as_tensor(dp), torch.as_tensor(theta),
        torch.as_tensor(psi0), n_mask=n_mask)
    for g, w, what in zip(got, want, ("psi", "var", "llr")):
        _close(g.numpy(), w, what)
    psi = got[0].numpy()
    assert np.isnan(psi[:3]).all() and np.isfinite(psi[3:]).all()
    # a chunked run gives every cell the same result
    chunked = tamb.fit_em_ambient_batch(
        torch.as_tensor(ad), torch.as_tensor(dp), torch.as_tensor(theta),
        torch.as_tensor(psi0), n_mask=n_mask, cell_chunk=10)
    for g, w in zip(chunked, got):
        _close(g.numpy(), w.numpy(), "chunked")


def test_cells_stop_on_their_own_test(monkeypatch):
    """A finished cell leaves the chunk with its result final: the chunk
    runs as long as its slowest cell, the others as long as they would
    alone."""
    ad, dp, theta, psi0 = _em_inputs(seed=3, n_empty=0)
    lens = []
    real = tamb._em_chunk

    def spy(*args):
        out = real(*args)
        lens.append(out[3])
        return out

    monkeypatch.setattr(tamb, "_em_chunk", spy)
    args = [torch.as_tensor(x) for x in (ad, dp, theta, psi0)]
    together = tamb.fit_em_ambient_batch(*args)
    alone = [tamb.fit_em_ambient_batch(*(x[c:c + 1] if i != 2 else x
                                         for i, x in enumerate(args)))
             for c in range(ad.shape[0])]
    assert lens[0] == max(lens[1:]) and len(set(lens[1:])) > 1
    for i in range(3):
        _close(together[i].numpy(),
               torch.cat([a[i] for a in alone]).numpy(), "alone")


def test_chunked_column_reader_matches_jax():
    rng = np.random.RandomState(0)
    V, C, K, n_sel = 40, 53, 3, 17
    dp = (rng.rand(V, C) < 0.5) * rng.poisson(8, (V, C))
    ad = rng.binomial(dp, 0.4)
    sel = np.sort(rng.choice(V, n_sel, replace=False))
    theta = rng.rand(n_sel, K) * 0.9 + 0.05
    psi0 = rng.dirichlet([1.0] * K, size=C)
    want = jamb._ambient_em_cols(
        jnp.asarray(ad, jnp.float64), jnp.asarray(dp, jnp.float64),
        jnp.asarray(sel), jnp.asarray(theta), jnp.asarray(psi0),
        cell_chunk=16)
    for store in (torch.float64, torch.int8):
        got = tamb._ambient_em_cols(
            torch.as_tensor(ad).to(store), torch.as_tensor(dp).to(store),
            torch.as_tensor(sel), torch.as_tensor(theta),
            torch.as_tensor(psi0), cell_chunk=16)
        for g, w, what in zip(got, want, ("psi", "var", "llr")):
            _close(g.numpy(), w, "%s (%s)" % (what, store))


@pytest.fixture(scope="module")
def pool():
    return synth_pool_counts(n_var=220, n_cell=300, n_donor=3,
                             doublet_rate=0.1, density=0.15, seed=4)


def _heavy(pool, seed=8):
    """The pool with ~3% of its nonzeros raised above both caps."""
    import scipy.sparse as sp
    rng = np.random.RandomState(seed)
    AD, DP = pool["AD"].toarray(), pool["DP"].toarray()
    extra = ((DP > 0) & (rng.rand(*DP.shape) < 0.03)) \
        * rng.randint(150, 400, DP.shape)
    return (sp.csc_matrix(AD + rng.binomial(extra, 0.5)),
            sp.csc_matrix(DP + extra))


KW = dict(n_donor=3, n_init=4, random_seed=6, verbose=False,
          check_ambient=True)


@pytest.fixture(scope="module")
def jax_runs(pool):
    """JAX's vireo_wrap(check_ambient=True) on dense float64 counts of
    the pool and of its heavy-tailed copy."""
    runs = {}
    for name, (ad, dp) in (("light", (pool["AD"], pool["DP"])),
                           ("heavy", _heavy(pool))):
        with pytest.MonkeyPatch.context() as mp:
            mp.delenv("VIREO_FUSED_DOUBLET", raising=False)
            runs[name] = (ad, dp, jwrap.vireo_wrap(
                jax_dense_counts(ad, dp, dtype=jnp.float64),
                dtype=jnp.float64, mesh=None, **KW))
    return runs


@pytest.mark.parametrize("rung,pool_name,budget,cls", [
    ("dense", "light", None, "DenseCounts"),
    ("packed", "light", 1, "PackedCounts"),
    ("int8-hybrid", "heavy", 2, "HybridCounts"),
    ("packed-hybrid", "heavy", 1, "HybridCounts"),
    ("coo", "heavy", 0, "SparseCounts"),
])
def test_vireo_wrap_ambient_matches_jax(jax_runs, rung, pool_name, budget,
                                        cls, capsys):
    AD, DP, rj = jax_runs[pool_name]
    if budget is None:
        counts = tcounts.DenseCounts(torch.as_tensor(AD.toarray()),
                                     torch.as_tensor(DP.toarray()))
    else:
        nbytes = max(budget * AD.shape[0] * AD.shape[1], 1)
        assert tcounts.ladder_rung(AD.shape, float(DP.max()), nbytes) == rung
        counts = tcounts.counts_from_scipy(AD, DP, device="cpu",
                                           dense_budget=nbytes)
    assert type(counts).__name__ == cls
    capsys.readouterr()
    rt = twrap.vireo_wrap(counts, dtype=torch.float64, **KW)
    printed = capsys.readouterr().out
    assert "SNPs selected for ambient RNA detection" in printed
    for key in ("ID_prob", "GT_prob"):
        _close(rt[key], rj[key], key)
    for key in ("ambient_Psi", "Psi_var"):
        _close(rt[key], rj[key], key)
    _close(rt["Psi_LLRatio"], rj["Psi_LLRatio"], "Psi_LLRatio", LLR_ATOL)
    assert rt["ambient_Psi"].shape == (AD.shape[1], 3)


def test_ambient_min_gain_knob_and_print(pool, capsys):
    """The gate's default is sqrt(n_cell) / 3 and `ambient_min_gain`
    overrides it; the print is JAX's line for line."""
    AD, DP = pool["AD"], pool["DP"]
    kw = dict(n_donor=3, n_init=2, random_seed=3, check_doublet=False,
              check_ambient=True, verbose=False)

    def gate_lines(out):
        return [x for x in out.splitlines() if "SNPs selected" in x]

    for gain in (None, 4.0, 1e9):
        jwrap.vireo_wrap(AD, DP, ambient_min_gain=gain, dtype=jnp.float64,
                         mesh=None, **kw)
        want = gate_lines(capsys.readouterr().out)
        rt = twrap.vireo_wrap(AD, DP, ambient_min_gain=gain, device="cpu",
                              **kw)
        got = gate_lines(capsys.readouterr().out)
        assert got == want and len(got) == 1
        if gain is None:
            assert ("ELBO_gain > %.1f" % (np.sqrt(AD.shape[1]) / 3)) in got[0]
        if gain == 1e9:
            assert got[0].startswith("[vireo] 0 out %d SNPs" % AD.shape[0])
        assert rt["ambient_Psi"].shape == (AD.shape[1], 3)


def test_checkpoint_resume_redraws_psi0_from_the_saved_stream(pool,
                                                              tmp_path):
    """psi0 is drawn after the doublet phase: a run resumed from either
    checkpoint draws it from the restored RNG position and gives the
    uninterrupted run's ambient fractions."""
    AD, DP = pool["AD"], pool["DP"]
    kw = dict(KW, device="cpu")
    plain = twrap.vireo_wrap(AD, DP, **kw)
    ck = str(tmp_path / "ck")
    full = twrap.vireo_wrap(AD, DP, checkpoint_dir=ck, **kw)
    after_refit = twrap.vireo_wrap(AD, DP, checkpoint_dir=ck, **kw)
    (tmp_path / "ck" / "vireo_ckpt_00000001.npz").unlink()
    after_warm = twrap.vireo_wrap(AD, DP, checkpoint_dir=ck, **kw)
    for other in (full, after_refit, after_warm):
        for key in ("ambient_Psi", "Psi_var", "Psi_LLRatio"):
            np.testing.assert_array_equal(other[key], plain[key])


def test_no_selected_variant_gives_jax_values():
    """With no variant past the gate every sum is empty: psi NaN, an
    infinite variance and an LLR of 0, as JAX gives them."""
    ad, dp, theta, psi0 = _em_inputs(V=0)
    want = jamb.fit_em_ambient_batch(jnp.asarray(ad), jnp.asarray(dp),
                                     jnp.asarray(theta), jnp.asarray(psi0))
    got = tamb.fit_em_ambient_batch(torch.as_tensor(ad), torch.as_tensor(dp),
                                    torch.as_tensor(theta),
                                    torch.as_tensor(psi0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.isinf(got[1].numpy()).all()
