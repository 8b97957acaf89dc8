"""K1: vireo_tpu_torch.ops.fused_em against the JAX Pallas kernel
vireo_tpu.ops.pallas_em.fused_estep_stats run in interpret mode.

The JAX side gets its inputs zero-padded with `pad_to` as
vireo_tpu/models/doublet.py::fused_doublet_estep pads them; the port's
side gets them unpadded. Tolerance: float32 rtol 1e-5. Both sides round
W and the id that feeds S to bf16 at the same places, so only the order
of the float32 sums differs.

The CUDA kernel itself runs only on a card; chip_smoke.py holds it
against the plain version there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vireo_tpu.ops.pallas_em import fused_estep_stats as jax_fused, pad_to
from vireo_tpu_torch.ops import fused_em, _build

torch.set_num_threads(1)

RTOL = 1e-5


def _inputs(V, C, K, seed):
    rng = np.random.RandomState(seed)
    dp = (rng.rand(V, C) < 0.3) * (1 + rng.poisson(2.0, (V, C)))
    ad = rng.binomial(dp, 0.3)
    # digamma-folded weights are log-rate differences: negative, O(1-5)
    Wa = rng.uniform(-1.0, 4.0, (V, K)).astype(np.float32)
    Wd = -rng.uniform(0.01, 4.0, (V, K)).astype(np.float32)
    prior = np.log(rng.dirichlet(np.ones(K)))[None, :].astype(np.float32)
    return ad.astype(np.int8), dp.astype(np.int8), Wa, Wd, prior


def _run_both(V, C, K, stats_cols, seed):
    ad, dp, Wa, Wd, prior = _inputs(V, C, K, seed)
    j = jax_fused(pad_to(jnp.asarray(ad), (32, 128)),
                  pad_to(jnp.asarray(dp), (32, 128)),
                  pad_to(jnp.asarray(Wa), (32, 1)),
                  pad_to(jnp.asarray(Wd), (32, 1)),
                  jnp.asarray(prior), cell_block=128, interpret=True,
                  stats_cols=stats_cols)
    t = fused_em.fused_estep_stats(
        torch.as_tensor(ad), torch.as_tensor(dp), torch.as_tensor(Wa),
        torch.as_tensor(Wd), torch.as_tensor(prior), stats_cols=stats_cols)
    return j, t


@pytest.mark.parametrize("V,C,K,stats_cols", [
    (250, 300, 3, None),      # the fit shape, ragged V and C
    (201, 509, 6, 3),         # the doublet shape: K + C(K,2) columns, Ks = K
])
def test_reference_matches_pallas_interpret(V, C, K, stats_cols):
    (jS1, jSS, jid, jll, jlb, jkl), (S1, SS, idp, ll, lb, kl) = \
        _run_both(V, C, K, stats_cols, seed=V + C)
    Ks = K if stats_cols is None else stats_cols
    assert S1.shape == (V, Ks) and idp.shape == (C, K)
    assert all(x.dtype == torch.float32 for x in (S1, SS, idp, ll, lb, kl))
    for j, t in ((jS1[:V], S1), (jSS[:V], SS), (jid[:C], idp),
                 (jll[:C], ll)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=RTOL * float(np.abs(j).max()))
    # the padded cells of the JAX side (zero counts, id = softmax(prior))
    # add about 1e-7 each to kl_id; the unpadded side has none
    np.testing.assert_allclose(float(lb), float(jlb), rtol=RTOL)
    np.testing.assert_allclose(float(kl), float(jkl), rtol=RTOL)


def test_cpu_wrapper_runs_plain_version_without_launch():
    ad, dp, Wa, Wd, prior = _inputs(40, 70, 4, seed=0)
    args = [torch.as_tensor(x) for x in (ad, dp, Wa, Wd, prior)]
    before = fused_em.LAUNCHES
    got = fused_em.fused_estep_stats(*args, stats_cols=2)
    ref = fused_em.fused_estep_stats_reference(*args, stats_cols=2)
    assert fused_em.LAUNCHES == before
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_wrapper_raises_off_cpu_and_cuda():
    """The wrapper runs the plain version for CPU tensors only; anything
    else either launches the kernel (CUDA) or raises."""
    ad, dp, Wa, Wd, prior = _inputs(8, 8, 2, seed=2)
    args = [torch.as_tensor(x).to("meta") for x in (ad, dp, Wa, Wd, prior)]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fused_em.fused_estep_stats(*args)


def test_weights_are_rounded_to_bf16_inside():
    """Weights already on the bf16 grid give bit-identical outputs: the
    plain version rounds W to bf16 before the products, as the kernel
    and the TPU kernel do."""
    ad, dp, Wa, Wd, prior = _inputs(30, 50, 3, seed=1)
    args = [torch.as_tensor(x) for x in (ad, dp, Wa, Wd, prior)]
    rounded = list(args)
    for i in (2, 3):
        rounded[i] = args[i].to(torch.bfloat16).to(torch.float32)
    assert not torch.equal(rounded[2], args[2])
    for a, b in zip(fused_em.fused_estep_stats_reference(*args),
                    fused_em.fused_estep_stats_reference(*rounded)):
        assert torch.equal(a, b)


def test_build_command_targets_sm90a_and_repo_source():
    src = _build.source_path("fused_estep")
    assert src.is_file() and src.name == "fused_estep.cu"
    assert src.parent == _build.CSRC_DIR
    cmd = _build.nvcc_command(src, "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1] == str(src)
    assert {"-std=c++17", "-O3", "-shared", "-fPIC"} <= set(cmd)
    assert _build.library_path("fused_estep").parent == _build.BUILD_DIR


def test_column_limit_holds_on_the_cpu_too():
    """fused_estep_stats refuses more than MAX_K assignment columns before
    it looks at the device, so the CPU runs the card's rule; MAX_K itself
    goes through."""
    V, C = 6, 9
    ad, dp, _, _, _ = _inputs(V, C, 1, seed=3)
    ad, dp = torch.as_tensor(ad), torch.as_tensor(dp)
    for K, ok in ((fused_em.MAX_K, True), (fused_em.MAX_K + 1, False)):
        Wa = torch.zeros((V, K))
        prior = torch.full((1, K), -float(np.log(K)))
        if ok:
            S1, _, idp, _, _, _ = fused_em.fused_estep_stats(
                ad, dp, Wa, Wa, prior, stats_cols=3)
            assert idp.shape == (C, K) and S1.shape == (V, 3)
        else:
            with pytest.raises(ValueError, match="at most %d"
                               % fused_em.MAX_K):
                fused_em.fused_estep_stats(ad, dp, Wa, Wa, prior)


def test_max_k_mirrors_the_kernel_source():
    """The Python constant is the .cu file's kMaxK (which the library's
    vireo_fused_estep_max_k returns), and it takes 40 donors' doublet
    space, K = 40 + C(40, 2) = 820."""
    import re
    text = _build.source_path("fused_estep").read_text()
    (value,) = re.findall(r"constexpr int kMaxK = (\d+);", text)
    assert int(value) == fused_em.MAX_K >= 820
    assert "return kMaxK;" in text
