"""The pool generator: the cells' pools are the same bit for bit as
before the generator had a heavy tail, and a configuration that asks for
the tail gets it, held in int16."""

import hashlib
import json

import numpy as np
import pytest
import torch

from helpers import BENCH, TINY_POOL
from portbench.harness.pool import count_dtype, make_pool, to_host

SEED = 2**31 + 7
HEAVY = dict(n_var=200, n_cell=600, n_donor=4, doublet_rate=0.08,
             density=0.3, mean_extra_depth=3.0, max_depth=16,
             hot_share=0.05, hot_depth=[200, 2000],
             theta=[0.02, 0.5, 0.98])


def _config_pool(name):
    """A configuration's `pool` keys at 300 x 2000."""
    pool = json.loads((BENCH / "configs" / (name + ".json")).read_text())
    return dict(pool["pool"], n_var=300, n_cell=2000)


def _digest(pool):
    h = hashlib.sha256()
    for key in ("ad", "dp"):
        h.update(pool[key].contiguous().numpy().tobytes())
    return h.hexdigest()


# SHA-256 of AD's and DP's bytes, made by the generator before it had a
# heavy tail (seed SEED, row_chunk 128)
DIGESTS = {
    "pool16": "76a4781212436f93cb6703e05c3cea95d61f64532acdf4363b2e3c708fff1572",
    "ksweep16": "e696568b6351359de797cf1d5f4bca39bddc684e97df35e7853fce8eedb80fe8",
    "tiny": "89b2fcc67e8958b5e64f609bc49a5323d41f6a90295f56b4001dfeef9dd764bb",
}


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_todays_pools_are_unchanged(name):
    keys = dict(TINY_POOL) if name == "tiny" else _config_pool(name)
    pool = make_pool(seed=SEED, device=torch.device("cpu"), row_chunk=128,
                     **keys)
    assert pool["ad"].dtype == pool["dp"].dtype == torch.int8
    assert _digest(pool) == DIGESTS[name]


@pytest.fixture(scope="module")
def heavy():
    return make_pool(seed=SEED, device=torch.device("cpu"), row_chunk=64,
                     **HEAVY)


def test_the_heavy_pool(heavy):
    ad, dp = heavy["ad"], heavy["dp"]
    assert ad.dtype == dp.dtype == torch.int16
    assert int((dp > 256).sum()) > 0 and int(dp.max()) < 16 + 2000
    assert bool((ad >= 0).all()) and bool((ad <= dp).all())
    # hot entries are those deeper than the base depth's cap
    covered, hot = int((dp > 0).sum()), int((dp > 16).sum())
    assert covered > 30000
    assert abs(hot / covered - 0.05) < 0.005
    # their allele counts follow the entries' allele rates, not a cap
    assert int(ad[dp > 16].max()) > 200
    AD, DP = to_host(heavy)
    np.testing.assert_array_equal(AD.toarray(), ad.numpy())
    np.testing.assert_array_equal(DP.toarray(), dp.numpy())
    assert AD.nnz == int((ad > 0).sum())


def test_the_same_seed_gives_the_same_heavy_pool(heavy):
    again = make_pool(seed=SEED, device=torch.device("cpu"), row_chunk=64,
                      **HEAVY)
    other = make_pool(seed=SEED + 1, device=torch.device("cpu"),
                      row_chunk=64, **HEAVY)
    assert _digest(again) == _digest(heavy) != _digest(other)
    for key in ("donor", "donor2", "GT"):
        np.testing.assert_array_equal(again[key], heavy[key])


@pytest.mark.parametrize("keys,dtype", [
    (dict(), torch.int8),
    (dict(max_depth=127), torch.int8),
    (dict(max_depth=128), torch.int16),
    (dict(max_depth=16, hot_share=0.1, hot_depth=[1, 112]), torch.int8),
    (dict(max_depth=16, hot_share=0.1, hot_depth=[1, 113]), torch.int16),
    (dict(max_depth=16, hot_share=0.0, hot_depth=[1, 40000]), torch.int8),
    (dict(max_depth=767, hot_share=0.1, hot_depth=[0, 32001]), torch.int16),
])
def test_count_dtype(keys, dtype):
    assert count_dtype(**keys) == dtype


@pytest.mark.parametrize("keys", [
    dict(max_depth=768, hot_share=0.1, hot_depth=[0, 32001]),
    dict(max_depth=40000),
    dict(max_depth=0),
    dict(hot_share=0.1, hot_depth=None),
    dict(hot_share=1.5, hot_depth=[1, 2]),
    dict(hot_share=0.1, hot_depth=[5, 5]),
    dict(hot_share=0.1, hot_depth=[-1, 5]),
])
def test_a_pool_that_could_pass_int16_or_is_malformed_is_refused(keys):
    with pytest.raises(ValueError):
        make_pool(seed=SEED, device=torch.device("cpu"),
                  **dict(HEAVY, n_var=4, n_cell=8, **keys))
