"""The benchmark's readers of the program's spans, `inits_idle_s` and
`place_host_s`, on a synthetic Chrome trace reduced by the harness
(`portbench/harness/trace.py::reduce_trace`): the harness's spans with
the program's nested inside, and device operations with gaps between
them. Times in the trace are microseconds."""

import pytest

from portbench.harness.manifest import Manifest
from portbench.harness.run_cell import _Ctx
from portbench.harness.trace import reduce_trace

MAIN = 1


def _span(name, t0, t1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": t0,
            "dur": t1 - t0, "tid": MAIN}


def _kernel(t0, t1, corr):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": t0,
            "dur": t1 - t0, "tid": 7, "args": {"correlation": corr}}


def _job(t0, program=True):
    """One job from `t0`, 1000 us long: placement (union 100 us idle,
    rung 30 us idle, upload busy), the warm phase with its inits (plan
    200, stream 50, normalise 20 us idle, and 10 us idle under
    `vireo.inits` itself), a model build idle for 40 us under the
    harness's span alone, and a fit. Without the program's spans, only
    the harness's."""
    spans = [_span("portbench.job", t0, t0 + 1000),
             _span("data_placement", t0 + 10, t0 + 300),
             _span("warm_restarts", t0 + 300, t0 + 800),
             _span("inits", t0 + 310, t0 + 600),
             _span("model_build", t0 + 800, t0 + 900)]
    if program:
        spans += [_span("vireo.data_placement", t0 + 11, t0 + 299),
                  _span("vireo.place.union", t0 + 20, t0 + 120),
                  _span("vireo.place.rung", t0 + 130, t0 + 160),
                  _span("vireo.place.upload", t0 + 160, t0 + 298),
                  _span("vireo.warm_restarts", t0 + 301, t0 + 799),
                  _span("vireo.inits", t0 + 311, t0 + 599),
                  _span("vireo.inits.plan", t0 + 320, t0 + 520),
                  _span("vireo.inits.stream", t0 + 520, t0 + 570),
                  _span("vireo.inits.normalise", t0 + 570, t0 + 590),
                  _span("vireo.fit", t0 + 600, t0 + 790)]
    # busy: before the union, the upload, between the inits' steps, the
    # fit, the end of the job; idle gaps fall in each step named above
    kernels = [(t0, t0 + 20), (t0 + 120, t0 + 130), (t0 + 160, t0 + 310),
               (t0 + 320, t0 + 320), (t0 + 520, t0 + 520),
               (t0 + 570, t0 + 570), (t0 + 590, t0 + 800),
               (t0 + 840, t0 + 1000)]
    return spans, [_kernel(a, b, int(t0) + i)
                   for i, (a, b) in enumerate(kernels)]


def _summary(n_jobs, program=True, device=True):
    events = [_span("portbench.window", 0, 1000 * n_jobs)]
    for j in range(n_jobs):
        spans, kernels = _job(1000 * j, program)
        events += spans + (kernels if device else [])
    return reduce_trace(events, [])


def _read(metric, summary, n_jobs):
    ctx = _Ctx(Manifest(), [{"phases": {}}] * n_jobs, summary, {}, None)
    return Manifest().reader(metric).read(ctx)


@pytest.mark.parametrize("n_jobs", [1, 3])
def test_each_reader_adds_its_own_spans_per_job(n_jobs):
    s = _summary(n_jobs)
    idle = dict(s.idle_gaps)
    # the harness's model_build span alone: a gap neither reader counts
    assert idle["model_build"] == pytest.approx(40e-6 * n_jobs)
    assert idle["vireo.place.union"] == pytest.approx(100e-6 * n_jobs)
    assert _read("place_host_s", s, n_jobs) == pytest.approx(130e-6)
    assert _read("inits_idle_s", s, n_jobs) == pytest.approx(280e-6)


def test_gaps_under_the_harness_spans_alone_are_not_counted():
    """A program without the spans (the harness names every gap) reads
    nothing, and its traced run leaves both metrics out."""
    s = _summary(2, program=False)
    assert dict(s.idle_gaps)["inits"] > 0
    assert _read("inits_idle_s", s, 2) is None
    assert _read("place_host_s", s, 2) is None


def test_readers_read_nothing_without_device_operations():
    s = _summary(2, device=False)
    assert s.busy_s == 0
    assert _read("inits_idle_s", s, 2) is None
    assert _read("place_host_s", s, 2) is None


def test_the_readers_are_declared():
    spec = Manifest().spec
    declared = {m["name"]: m for m in spec["per_layer"]}
    assert declared["inits_idle_s"]["workloads"] == [
        w["name"] for w in spec["workloads"]]
    # the host placement it reads runs in the cells fed host counts
    assert declared["place_host_s"]["workloads"] == [
        w["name"] for w in spec["workloads"] if w["traffic"] == "from_host"]
    assert declared["place_host_s"]["layer"] == \
        declared["placement_s"]["layer"]
