"""vireo_tpu_torch.probes against the JAX probes of benchmarks/, on the
CPU, on the same numpy inputs.

The JAX scripts are not a package: each is loaded from its file for one
test, with VIREO_COMPILE_CACHE="" (so it switches on no persistent
cache) and `pl.pallas_call` wrapped with interpret=True for that test
only (monkeypatch).

Tolerances:
- kernel A (nibble unpack): bit for bit against JAX's `k_int8_ops` and
  `k_int32_ops`, and all three variants against numpy's p & 15, p >> 4.
  JAX's `k_bitcast_int4` fails (its int4 bitcast doubles the rows, not
  the columns), which `test_jax_bitcast_variant_fails` pins;
- kernel B (packed matmul, P5's three variants and P6): the port's plain
  version runs in float64; JAX sums n float32 products (n = 2 Ch cells
  for the nibble kernels, Ch bytes for `nounpack`), so Higham's bound
  |err| <= gamma_n sum|terms|, gamma_n = n u / (1 - n u), u = 2^-24;
- kernels C and D (P1-P3): float64 against JAX's float32 sums of n terms
  (n = the nonzeros for the gathers, a bin's nonzeros for the scatter):
  gamma_n sum|terms|; the library baseline, float32 on both sides,
  2 gamma_n sum|terms|;
- the padded JAX layout against the port's: byte for byte.

The CUDA kernels run only on a card; chip_smoke.py's `[probes]` phase
holds them against these plain versions there.
"""

import contextlib
import functools
import importlib.util
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vireo_tpu_torch.ops import _build
from vireo_tpu_torch.ops.packed import pack_nibbles
from vireo_tpu_torch.probes import coo_pallas_probe as tcoo
from vireo_tpu_torch.probes import int4_micro as tmicro
from vireo_tpu_torch.probes import nibbles
from vireo_tpu_torch.probes import pack_kernel_tune as ttune
from vireo_tpu_torch.probes import unpack_probe as tunpack

REPO = Path(__file__).resolve().parent.parent
F32_UNIT = 2.0 ** -24
K = 16


def _gamma(n):
    return n * F32_UNIT / (1 - n * F32_UNIT)


@pytest.fixture(autouse=True)
def _ask_for_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked for the CPU
    (utils/device.py); these tests ask for it."""
    monkeypatch.setenv("VIREO_PLATFORM", "cpu")


def _jax_probe(monkeypatch, name, **env):
    """benchmarks/<name>.py loaded as a fresh module, with its Pallas
    calls in interpret mode for this test only."""
    monkeypatch.setenv("VIREO_COMPILE_CACHE", "")
    for key, value in env.items():
        monkeypatch.setenv(key, str(value))
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    spec = importlib.util.spec_from_file_location(
        "jax_" + name, REPO / "benchmarks" / (name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# --- P4: kernel A ----------------------------------------------------

def _unpack_input():
    rng = np.random.RandomState(0)
    return rng.randint(0, 256, size=(256, 512)).astype(np.uint8).view(np.int8)


def _jax_unpack(mod, kernel, p):
    """The pallas_call of the JAX script's `run`, returning the planes."""
    vmem = pl.BlockSpec(memory_space=mod.pltpu.VMEM)
    shape = jax.ShapeDtypeStruct(p.shape, jnp.bfloat16)
    return pl.pallas_call(kernel, out_shape=(shape, shape), in_specs=[vmem],
                          out_specs=(vmem, vmem))(jnp.asarray(p))


def _bf16_bits(x):
    return np.asarray(x.view(torch.int16).numpy() if torch.is_tensor(x)
                      else np.asarray(x).view(np.int16))


@pytest.mark.parametrize("variant,kernel", [("int8", "k_int8_ops"),
                                            ("int32", "k_int32_ops")])
def test_unpack_matches_jax_bit_for_bit(monkeypatch, variant, kernel):
    mod = _jax_probe(monkeypatch, "unpack_probe")
    p = _unpack_input()
    want = _jax_unpack(mod, getattr(mod, kernel), p)
    got = nibbles.nibble_unpack(torch.from_numpy(p), variant)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bf16_bits(g), _bf16_bits(w))


@pytest.mark.parametrize("variant", nibbles.VARIANTS)
def test_unpack_variants_match_numpy(variant):
    p = _unpack_input()
    lo, hi = nibbles.nibble_unpack(torch.from_numpy(p), variant)
    u = p.view(np.uint8)
    np.testing.assert_array_equal(lo.float().numpy(), u & 15)
    np.testing.assert_array_equal(hi.float().numpy(), u >> 4)


def test_jax_bitcast_variant_fails(monkeypatch):
    """unpack_probe.py:55-62: pltpu.bitcast to int4 doubles the rows, so
    the [:, 0::2] split gives (512, 256) planes for (256, 512) refs."""
    mod = _jax_probe(monkeypatch, "unpack_probe")
    with pytest.raises(ValueError, match="Invalid shape for `swap`"):
        _jax_unpack(mod, mod.k_bitcast_int4, _unpack_input())


# --- P5, P6: kernel B ------------------------------------------------

V_MM, C_MM, BV, BC = 64, 256, 32, 64


def _jax_pool(V=V_MM, C=C_MM, bv=BV, bc=BC, seed=3):
    """int8 counts, float32 W and the JAX scripts' padded operands: int8
    packed bytes (Vp, Ch), We and Wo (Ch, K), packed as their `pack`."""
    rng = np.random.RandomState(seed)
    x8 = rng.randint(0, 13, size=(V, C)).astype(np.int8)
    w = rng.standard_normal((C, K)).astype(np.float32)
    Vp, Ch = -(-V // bv) * bv, -(-(C // 2) // bc) * bc
    v = x8[:, 0::2].astype(np.int32) | (x8[:, 1::2].astype(np.int32) << 4)
    v = np.where(v > 127, v - 256, v).astype(np.int8)
    p = np.pad(v, ((0, Vp - V), (0, Ch - C // 2)))
    we = np.pad(w[0::2], ((0, Ch - C // 2), (0, 0)))
    wo = np.pad(w[1::2], ((0, Ch - C // 2), (0, 0)))
    return x8, w, p, we, wo


def _sum_bound(p_port, we, wo, codec, n):
    """gamma_n sum|terms| of each output, in float64."""
    if codec == "raw_byte":
        mag = p_port.view(torch.int8).double().abs() @ we.double().abs()
    else:
        mag = nibbles.packed_mm_reference(p_port, we.abs(), wo.abs())
    return _gamma(n) * mag.numpy()


@pytest.mark.parametrize("variant,codec", ttune.VARIANTS)
def test_pack_kernel_tune_variants_match_jax(monkeypatch, variant, codec):
    mod = _jax_probe(monkeypatch, "pack_kernel_tune", MB_K=K)
    x8, w, p, we, wo = _jax_pool()
    kernel = {"base": mod.make_kernel(mod.unpack_base),
              "f32u": mod.make_kernel(mod.unpack_f32),
              "noup": mod.nounpack_kernel}[variant]
    want = np.asarray(mod.build(kernel, BV, BC, *p.shape)(
        jnp.asarray(p), jnp.asarray(we), jnp.asarray(wo)))[:V_MM]
    pp, twe, two = tmicro.from_jax_packed(p, we, wo, V_MM, C_MM)
    got = nibbles.packed_mm(pp, twe, two, codec)
    assert got.dtype == torch.float64 and got.shape == (V_MM, K)
    n = p.shape[1] * (1 if codec == "raw_byte" else 2)
    bound = _sum_bound(pp, twe, two, codec, n)
    assert np.all(np.abs(got.numpy() - want) <= bound)
    if codec != "raw_byte":     # the JAX script's own check
        ref = tmicro.dense_reference(torch.from_numpy(x8), torch.from_numpy(w))
        assert float((nibbles.packed_mm(pp, twe.bfloat16(), two.bfloat16(),
                                        codec) - ref).abs().max()) < 1.0


def test_int4_micro_packed_mm_matches_jax(monkeypatch):
    mod = _jax_probe(monkeypatch, "int4_micro", MB_K=K)
    _, _, p, we, wo = _jax_pool()
    want = np.asarray(mod.packed_mm(jnp.asarray(p), jnp.asarray(we),
                                    jnp.asarray(wo), block_v=BV,
                                    block_c=BC))[:V_MM]
    pp, twe, two = tmicro.from_jax_packed(p, we, wo, V_MM, C_MM)
    got = nibbles.packed_mm(pp, twe, two).numpy()
    assert np.all(np.abs(got - want)
                  <= _sum_bound(pp, twe, two, "nibble_int", 2 * p.shape[1]))


@pytest.mark.parametrize("C", [256, 255])
def test_from_jax_packed_is_the_port_layout(C):
    """JAX's padded int8 bytes and weights -> K2's unpadded uint8 layout:
    the port's own packing of the same counts, byte for byte. (JAX's
    `pack` needs an even C; an odd C stands for a pool cut by hand.)"""
    x8, w, p, we, wo = _jax_pool(C=256)
    x8, w = x8[:, :C], w[:C]
    if C % 2:   # the last cell's nibble and weight are zero
        p = p.copy()
        p[:, C // 2] &= 0x0F
        wo = wo.copy()
        wo[C // 2] = 0
    pp, twe, two = tmicro.from_jax_packed(p, we, wo, V_MM, C)
    assert pp.dtype == torch.uint8 and pp.shape == (V_MM, (C + 1) // 2)
    assert torch.equal(pp, pack_nibbles(torch.from_numpy(x8)))
    lo = (pp & 15).numpy()
    hi = (pp >> 4).numpy()
    np.testing.assert_array_equal(lo, x8[:, 0::2])
    np.testing.assert_array_equal(hi[:, :C // 2], x8[:, 1::2])
    for got, want in zip((twe, two), tmicro.split_weights(
            torch.from_numpy(w))):
        assert torch.equal(got, want)


# --- kernel B's host side: plan, k order, padding ----------------------

SMS = 132


@pytest.mark.parametrize("V,Cb,N,codec,sms,per_sm", [
    (30000, 50000, K, "nibble_int", SMS, 1),     # int4_micro's shape
    (30000, 50000, K, "raw_byte", SMS, 1),
    (1000, 50000, K, "nibble_float", SMS, 1),    # ragged V
    (333, 4999, 20, "nibble_int", 7, 2),         # odd C: 9997 cells
    (64, 48, K, "raw_byte", SMS, 1),             # C below one stage
    (129, 144, 3, "nibble_int", 1, 1),           # one SM
])
def test_mm_plan_tiles_the_k_axis_once(V, Cb, N, codec, sms, per_sm):
    """The slices tile [0, k_len) exactly once, on stage boundaries, each
    holding at least one stage; the units and grid follow from them."""
    plan = nibbles.mm_plan(V, Cb, N, codec, sms, per_sm)
    cells = 1 if codec == "raw_byte" else 2
    ks = nibbles.TILE[1] * cells
    assert plan["stage_k"] == ks
    assert plan["stages"] == -(-Cb // nibbles.TILE[1])
    bounds = plan["bounds"]
    assert len(bounds) == plan["n_slices"]
    assert bounds[0][0] == 0 and bounds[-1][1] == Cb * cells
    for (a0, a1), (b0, _) in zip(bounds, bounds[1:]):
        assert a1 == b0
    for k0, k1 in bounds:
        assert k0 % ks == 0 and k1 > k0
        assert k0 // ks + plan["slice_stages"] >= -(-k1 // ks)
    covered = sum(-(-k1 // ks) - k0 // ks for k0, k1 in bounds)
    assert covered == plan["stages"]
    tiles = -(-V // nibbles.TILE[0]) * -(-N // 16)
    assert plan["units"] == tiles * plan["n_slices"]
    assert plan["grid"] == min(plan["units"], sms * per_sm)
    assert plan["rounds"] == -(-plan["units"] // (sms * per_sm))


def test_mm_plan_balances_the_card():
    """At int4_micro's shape the busiest block walks within 5% of an even
    share of the stages (235 blocks each walking all 391 stages on 132
    SMs, two to an SM, would be 12% over)."""
    plan = nibbles.mm_plan(30000, 50000, K, "nibble_int", SMS, 1)
    even = -(-30000 // nibbles.TILE[0]) * plan["stages"] / SMS
    assert plan["rounds"] * plan["slice_stages"] <= 1.05 * even


def _slice_weights(rng, Cb, integer):
    if integer:
        return [torch.from_numpy(rng.randint(-2, 3, (Cb, K)).astype(
            np.float32)) for _ in range(2)]
    return [torch.from_numpy(rng.standard_normal((Cb, K)).astype(np.float32))
            for _ in range(2)]


@pytest.mark.parametrize("codec", nibbles.CODECS)
@pytest.mark.parametrize("integer", [True, False], ids=["integer", "normal"])
def test_slice_sums_in_order_equal_the_plain_version(codec, integer):
    """The kernel's split: the plain product of each slice, in float32,
    added slice by slice in order. Exactly the plain float32 version on
    integer weights (every partial sum an integer below 2^24); on normal
    weights both sum the same k_len float32 products in two orders, each
    within gamma_n sum|terms| of the exact sum (Higham), n = k_len, so
    they differ by at most 2 gamma_n sum|terms|."""
    rng = np.random.RandomState(7)
    V, Cb = 70, 1000
    p = torch.from_numpy(rng.randint(0, 256, (V, Cb)).astype(np.uint8))
    we, wo = _slice_weights(rng, Cb, integer)
    plan = nibbles.mm_plan(V, Cb, K, codec, 3, 1)
    assert plan["n_slices"] > 1
    cells = 1 if codec == "raw_byte" else 2
    whole = nibbles.packed_mm_reference(p, we, wo, codec,
                                        dtype=torch.float32)
    sliced = torch.zeros_like(whole)
    for k0, k1 in plan["bounds"]:
        j0, j1 = k0 // cells, k1 // cells
        sliced += nibbles.packed_mm_reference(
            p[:, j0:j1], we[j0:j1], wo[j0:j1], codec, dtype=torch.float32)
    if integer:
        assert torch.equal(sliced, whole)
    else:
        mag = _sum_bound(p, we, wo, codec, 1) / _gamma(1)     # sum|terms|
        n = Cb * cells
        assert np.all(np.abs((sliced - whole).double().numpy())
                      <= 2 * _gamma(n) * mag)


@pytest.mark.parametrize("Cb", [37, 48, 129])
def test_row_padding_leaves_the_plain_result_unchanged(Cb):
    rng = np.random.RandomState(Cb)
    p = torch.from_numpy(rng.randint(0, 256, (9, Cb)).astype(np.uint8))
    we, wo = _slice_weights(rng, Cb, False)
    q, qe, qo = nibbles.pad_rows(p, we, wo)
    assert q.shape[1] % 16 == 0 and q.shape[1] - Cb < 16
    assert qe.shape == qo.shape == (q.shape[1], K)
    if Cb % 16 == 0:
        assert q is p and qe is we and qo is wo
    for codec in nibbles.CODECS:
        assert torch.equal(nibbles.packed_mm_reference(q, qe, qo, codec),
                           nibbles.packed_mm_reference(p, we, wo, codec))


def _fragment_rows(p, codec, stages):
    """The A rows the kernel's fragments hold, k value L of each stage
    (128 bytes of each row) at column L: consumer lane column c reads
    bytes 32 c .. 32 c + 31 of its row in the stage
    (csrc/probe_nibbles.cu, `load_run`), and step s takes pairs 2 s
    (register half h = 0) and 2 s + 1 (h = 1) of that run
    (`Codec::pair`), at k 16 s + 8 h + 2 c + e."""
    V, Cb = p.shape
    ks = nibbles.TILE[1] * (1 if codec == "raw_byte" else 2)
    padded = torch.zeros((V, stages * nibbles.TILE[1]), dtype=torch.int64)
    padded[:, :Cb] = p.to(torch.int64)
    a = torch.zeros((V, stages * ks), dtype=torch.float64)
    for t in range(stages):
        for c in range(4):
            run = padded[:, t * 128 + 32 * c:t * 128 + 32 * c + 32]
            for s in range(ks // 16):
                for h in range(2):
                    j = 2 * s + h
                    if codec == "raw_byte":
                        pair = [run[:, 2 * j], run[:, 2 * j + 1]]
                        pair = [torch.where(x > 127, x - 256, x)
                                for x in pair]
                    else:
                        pair = [run[:, j] & 15, run[:, j] >> 4]
                    for e in range(2):
                        a[:, t * ks + 16 * s + 8 * h + 2 * c + e] = pair[e]
    return a


@pytest.mark.parametrize("codec", nibbles.CODECS)
@pytest.mark.parametrize("Cb", [300, 37])
def test_k_order_matches_the_fragment_reads(codec, Cb):
    """Bᵀ in `k_order` (mm_weights) against the A values the kernel's
    fragments build from the staged bytes gives the plain product,
    exactly on integer weights, for full and partial stages."""
    rng = np.random.RandomState(11)
    p = torch.from_numpy(rng.randint(0, 256, (5, Cb)).astype(np.uint8))
    we, wo = _slice_weights(rng, Cb, True)
    order = nibbles.k_order(codec)
    assert sorted(order.tolist()) == list(range(len(order)))
    stages = nibbles.mm_plan(5, Cb, K, codec, 1, 1)["stages"]
    b = nibbles.mm_weights(we, wo, codec, stages)
    assert b.dtype == torch.bfloat16
    got = _fragment_rows(p, codec, stages) @ b.double().t()
    assert torch.equal(got, nibbles.packed_mm_reference(p, we, wo, codec))


# --- P1-P3: kernels C and D ------------------------------------------

NNZ, C_COO = 8192, 1000


@pytest.fixture()
def coo_probes(monkeypatch):
    """Both COO probe modules, their `timed` returning the output."""
    mod = _jax_probe(monkeypatch, "coo_pallas_probe")
    for m in (mod, tcoo):
        monkeypatch.setattr(m, "timed", lambda fn, *args, n=3: fn(*args))
    return mod


@pytest.mark.parametrize("name,args,shape", [
    ("probe_gather", (NNZ, C_COO), (1, K)),
    ("probe_lane_gather", (NNZ, C_COO), (K, 1)),
    ("probe_scatter", (NNZ,), tcoo.TILE)])
def test_coo_probes_match_jax(coo_probes, name, args, shape):
    want = np.asarray(getattr(coo_probes, name)(*args))
    got = getattr(tcoo, name)(*args, device="cpu")
    assert got.dtype == torch.float64 and got.shape == shape == want.shape
    got = got.numpy()
    if name == "probe_scatter":     # the count of each bin
        rng = np.random.RandomState(0)
        r = rng.randint(0, 8, size=NNZ)
        c = rng.randint(0, 128, size=NNZ)
        n = np.zeros(tcoo.TILE)
        np.add.at(n, (r, c), 1)
    else:
        n = NNZ
    # every term is >= 0, so sum|terms| is the sum itself
    assert np.all(np.abs(got - want) <= _gamma(n) * got)


def test_coo_library_baseline_matches_jax(coo_probes):
    want = np.asarray(coo_probes.probe_xla_take(NNZ, C_COO))
    got = tcoo.probe_xla_take(NNZ, C_COO, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape == (K,)
    got = got.double().numpy()
    assert np.all(np.abs(got - want) <= 2 * _gamma(NNZ) * got)


def test_coo_gather_layouts_agree():
    """The two layouts of W give the same sums (P1 against P3)."""
    rng = np.random.RandomState(5)
    idx = torch.from_numpy(rng.randint(0, 300, 4000).astype(np.int32))
    val = torch.from_numpy(rng.rand(4000))
    w = torch.from_numpy(rng.rand(300, K))
    rows = tcoo.coo_gather(idx, val, w, "rows")
    cols = tcoo.coo_gather(idx, val, w.t().contiguous(), "cols")
    np.testing.assert_allclose(rows.numpy().ravel(), cols.numpy().ravel(),
                               rtol=1e-12)


# --- the entry points --------------------------------------------------

TINY = dict(MB_VARS=64, MB_CELLS=256, MB_K=K, MB_ITERS=1, PB_NNZ=4096,
            PB_CELLS=500)
# each entry point's lines, by their JAX script's leading words
LINES = {
    "unpack_probe": ["int8 shift/and ", "int32 roundtrip ",
                     "bitcast->bf16 mantissa "],
    "int4_micro": ["int8  fwd ", "bf16  fwd ",
                   "packed_mm max err vs int8 path: ", "pack4 fwd ",
                   "bytes_in_use "],
    "pack_kernel_tune": ["tile "],
    "coo_pallas_probe": ["{"] * 5,
}
MODULES = {"unpack_probe": tunpack, "int4_micro": tmicro,
           "pack_kernel_tune": ttune, "coo_pallas_probe": tcoo}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_entry_point_on_the_cpu_names_it(monkeypatch, name):
    for key, value in TINY.items():
        monkeypatch.setenv(key, str(value))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        MODULES[name].main()
    lines = out.getvalue().splitlines()
    assert [ln[:len(w)] for ln, w in zip(lines, LINES[name])] == LINES[name]
    assert len(lines) == len(LINES[name])
    for line in lines:
        assert "[cpu]" in line or '"device": "cpu"' in line, line
    # the plain versions ran: no kernel was launched
    assert not any(nibbles.LAUNCHES.values())
    assert not any(tcoo.LAUNCHES.values())


def test_coo_entry_point_prints_the_jax_keys(monkeypatch):
    """The port's JSON lines carry the JAX script's keys, and the device."""
    for key, value in TINY.items():
        monkeypatch.setenv(key, str(value))
    mod = _jax_probe(monkeypatch, "coo_pallas_probe")
    outs = []
    for main in (mod.main, tcoo.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main()
        outs.append([json.loads(ln) for ln in buf.getvalue().splitlines()])
    want, got = outs
    assert [set(g) for g in got] == [set(w) | {"device"} for w in want]
    assert got[-1]["backend"] == "cpu" and got[-1]["nnz"] == TINY["PB_NNZ"]


@pytest.mark.parametrize("name", sorted(MODULES))
def test_entry_point_without_a_card_raises(monkeypatch, name):
    monkeypatch.delenv("VIREO_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        MODULES[name].main()


# --- the wrappers ------------------------------------------------------

@pytest.mark.parametrize("call,error", [
    (lambda: nibbles.nibble_unpack(torch.zeros(4, dtype=torch.uint8),
                                   "int4"), ValueError),
    (lambda: nibbles.nibble_unpack(torch.zeros(4)), TypeError),
    (lambda: nibbles.packed_mm(torch.zeros((2, 3), dtype=torch.uint8),
                               torch.zeros(3, K), torch.zeros(3, K),
                               "nibble"), ValueError),
    (lambda: nibbles.packed_mm(torch.zeros((2, 3), dtype=torch.uint8),
                               torch.zeros(4, K), torch.zeros(4, K)),
     ValueError),
    (lambda: nibbles.packed_mm(torch.zeros((2, 3), dtype=torch.uint8),
                               torch.zeros(3, K, dtype=torch.int32),
                               torch.zeros(3, K, dtype=torch.int32)),
     TypeError),
    (lambda: tcoo.coo_gather(torch.zeros(4, dtype=torch.int64),
                             torch.zeros(4), torch.zeros(5, K)), TypeError),
    (lambda: tcoo.coo_gather(torch.zeros(4, dtype=torch.int32),
                             torch.zeros(4), torch.zeros(5, 8)), ValueError),
    (lambda: tcoo.coo_gather(torch.zeros(4, dtype=torch.int32),
                             torch.zeros(4), torch.zeros(5, K), "lanes"),
     ValueError),
    (lambda: tcoo.coo_scatter(torch.zeros(4, dtype=torch.int32),
                              torch.zeros(3, dtype=torch.int32),
                              torch.zeros(4)), ValueError),
    (lambda: tcoo.coo_scatter(*(torch.zeros(4, dtype=torch.int32,
                                            device="meta"),) * 2,
                              torch.zeros(4, device="meta")), ValueError),
    (lambda: nibbles.packed_mm_control(torch.zeros((2, 3), dtype=torch.uint8),
                                       torch.zeros(3, K), torch.zeros(3, K)),
     ValueError),
    (lambda: nibbles.mm_plan(0, 16, K, "nibble_int", SMS, 1), ValueError),
], ids=["unpack-variant", "unpack-dtype", "mm-codec", "mm-rows",
        "mm-weight-dtype", "gather-index-dtype", "gather-width",
        "gather-layout", "scatter-lengths", "scatter-device",
        "mm-control-cpu", "mm-plan-empty"])
def test_wrappers_refuse_what_the_kernels_do_not_take(call, error):
    with pytest.raises(error):
        call()


def test_launch_counters_name_each_variant():
    """One count for each kernel variant, codec and layout: the names of
    chip_smoke.py's kernel records."""
    assert set(nibbles.LAUNCHES) == {
        "nibble_unpack_int8", "nibble_unpack_int32", "nibble_unpack_bitcast",
        "packed_mm_nibble_int", "packed_mm_nibble_float",
        "packed_mm_raw_byte"}
    assert set(tcoo.LAUNCHES) == {
        "coo_gather_rows", "coo_gather_rows_smem", "coo_gather_cols",
        "coo_gather_cols_smem", "coo_scatter"}


def test_probe_kernel_sources():
    """Kernel B is built on the shared Hopper header; C and D stand
    alone."""
    assert {p.name for p in _build.compiled_files("probe_nibbles")} == {
        "hopper_gemm.cuh", "probe_nibbles.cu"}
    assert {p.name for p in _build.compiled_files("probe_coo")} == {
        "probe_coo.cu"}
