"""csrc/mt19937.cu on a card (ops/mt19937.py::kernel_stream): the stream
equals `np.random.rand` bit for bit and leaves numpy's generator where a
plain draw does, with one launch a call; a seeded init on a card takes
it at any size. Marked `cuda`: each test skips
without a card. No JAX here, so the file runs on the card's machine
without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_mt19937_cuda.py -q
"""

import numpy as np
import pytest
import torch

from vireo_tpu_torch.engine import wrap as twrap
from vireo_tpu_torch.models.vireo import VireoConfig
from vireo_tpu_torch.ops import mt19937 as tmt

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/mt19937.cu runs only there")
    return torch.device("cuda")


def _compare(card, rng, n):
    saved = rng.get_state()
    want = rng.rand(n)
    state_want = rng.get_state()
    rng.set_state(saved)
    before = tmt.LAUNCHES
    got = tmt.kernel_stream(tmt.take_state(n, rng, card), rng)
    state_got = rng.get_state()
    assert tmt.LAUNCHES == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.float64
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    np.testing.assert_array_equal(state_got[1], state_want[1])
    assert state_got[2:] == state_want[2:]


@pytest.mark.parametrize("seed,n,pre_words", [
    (2, 1000, 0),
    (7, 312 * 5, 0),
    (3, 987654, 0),
    (3, 12345, 1),
    (11, 624 * 3 + 7, 3),
    (5, 312 * 7, 0),     # p0 + 2n ends a 624 round: numpy's pos 624
    (5, 311, 1),         # within the keys: no round twisted
    (13, 3000001, 623),  # odd start, the last key drawn first
])
def test_kernel_bitmatches_numpy_rand(card, seed, n, pre_words):
    np.random.seed(seed)
    if pre_words:
        np.random.bytes(4 * pre_words)
    np.random.standard_normal()          # leaves a cached Gaussian
    _compare(card, np.random, n)


def test_kernel_with_randomstate_object(card):
    rng = np.random.RandomState(42)
    rng.rand(7)
    _compare(card, rng, 5000)
    _compare(card, rng, 4321)            # from where the first call left it


def test_small_card_init_takes_the_kernel(card):
    """A small seeded init is made by one launch on a card, equal to the
    host's draws."""
    cfg = VireoConfig(n_var=60, n_cell=40, n_donor=3)
    np.random.seed(5)
    before = tmt.LAUNCHES
    got = twrap._seeded_batched_init(cfg, 4, None, np.random, torch.float32,
                                     card)
    state_got = np.random.get_state()
    assert tmt.LAUNCHES == before + 1
    np.random.seed(5)
    want = twrap._host_batched_init(cfg, 4, None, np.random, torch.float32,
                                    card)
    for k in ("id_prob", "gt_prob", "beta_mu", "beta_sum"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    np.testing.assert_array_equal(state_got[1], np.random.get_state()[1])
    assert state_got[2:] == np.random.get_state()[2:]
