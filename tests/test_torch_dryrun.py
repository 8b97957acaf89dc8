"""The port's multi-rank dry run (vireo_tpu_torch.parallel.dryrun, the
counterpart of __graft_entry__.py::dryrun_multichip) on the CPU: it
spawns its own gloo ranks and checks each sharded rung against the
single-rank fit at 60 fixed iterations, ELBO rel 1e-4 and every call
identical."""

import pytest
from torch.multiprocessing import ProcessRaisedException

from vireo_tpu_torch.parallel.dryrun import dryrun_multichip
from vireo_tpu_torch.parallel.launch import run_ranks


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VIREO_PLATFORM", "cpu")
        yield


@pytest.mark.parametrize("n_ranks,shape", [(2, None), (4, (2, 2)),
                                           (4, (1, 4))])
def test_dryrun_multichip_on_cpu_ranks(tmp_path, capsys, n_ranks, shape):
    summary = dryrun_multichip(n_ranks, shape, device="cpu",
                               workdir=str(tmp_path))
    assert set(summary) == {"coo_shard_path", "dense_int8", "packed_hybrid",
                            "vireo_wrap"}
    for rung in ("coo_shard_path", "dense_int8", "packed_hybrid"):
        s = summary[rung]
        assert s["agree"] == s["n_cell"] and s["rel"] <= 1e-9
    assert summary["packed_hybrid"]["resid_nnz"] > 0
    assert summary["vireo_wrap"]["agree"] == 1.0
    printed = capsys.readouterr().out
    assert "dryrun_multichip OK: all 4 rungs pass on %d ranks" % n_ranks \
        in printed


@pytest.mark.parametrize("fn,args,timeout,error,match", [
    ("operator:truediv", (1, 0), 120, ProcessRaisedException,
     "ZeroDivisionError"),
    ("time:sleep", (600,), 5, TimeoutError, "deadline"),
])
def test_launcher_fails_on_a_failed_or_late_rank(tmp_path, fn, args,
                                                 timeout, error, match):
    """The launcher raises a failed rank's traceback, and kills ranks
    that outlast its deadline and fails; no rank is left running."""
    import multiprocessing
    with pytest.raises(error, match=match):
        run_ranks(fn, 2, args=args, workdir=str(tmp_path), timeout=timeout)
    assert multiprocessing.active_children() == []
