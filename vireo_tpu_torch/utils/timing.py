"""Phase timers, program spans and a profiler hook (counterpart of
vireo_tpu/utils/timing.py).

`PhaseTimer` accumulates named phase durations and prints them in the
JAX package's summary format. `span` names a step of the program in a
torch.profiler trace (`vireo.<name>`) while a profiler records, and
costs one flag check otherwise. `profile_trace` wraps a block in
`torch.profiler` and writes a Chrome trace into a directory.
"""

import contextlib
import json
import os
import threading
import time

import torch

__all__ = ["PhaseTimer", "span", "profile_trace", "timing_env"]

_NO_SPAN = contextlib.nullcontext()


class _Open(threading.local):
    """The names of the spans open on this thread: a span is not
    reopened inside itself (a hybrid's base, a mesh rank's block), so
    each call of the counts' methods lies inside exactly one span of
    its name."""

    def __init__(self):
        self.names = set()


_open = _Open()


@contextlib.contextmanager
def _recorded(name):
    _open.names.add(name)
    try:
        with torch.profiler.record_function("vireo." + name):
            yield
    finally:
        _open.names.discard(name)


def span(name):
    """A context manager that records the block as `vireo.<name>` in
    the trace of a running torch profiler (on the calling thread); with
    no profiler, or inside a span of the same name, it does nothing."""
    if not torch.autograd._profiler_enabled() or name in _open.names:
        return _NO_SPAN
    return _recorded(name)


def timing_env():
    """Whether VIREO_TIMING asks for the phase summary (any value but
    0, empty, no or off), as the JAX package reads it."""
    return os.environ.get("VIREO_TIMING", "0").lower() \
        not in ("0", "", "no", "off")


class PhaseTimer:
    """Accumulates named phase durations; printable as one summary.

    `sync`, when given, is called at the end of each phase before its
    clock stops (the port passes a device synchronise, so a phase's
    time holds its own device work). Each phase is also a span of its
    name."""

    def __init__(self, sync=None):
        self.phases = {}
        self._order = []
        self._sync = sync

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
                if self._sync is not None:
                    self._sync()
        finally:
            dt = time.perf_counter() - t0
            if name not in self.phases:
                self._order.append(name)
                self.phases[name] = 0.0
            self.phases[name] += dt

    def summary(self):
        total = sum(self.phases.values())
        lines = ["[vireo] timing: total %.2fs" % total]
        for name in self._order:
            dt = self.phases[name]
            lines.append("  %-24s %8.2fs  %5.1f%%"
                         % (name, dt, 100 * dt / max(total, 1e-9)))
        return "\n".join(lines)

    def json(self):
        return json.dumps(self.phases)


@contextlib.contextmanager
def profile_trace(log_dir=None):
    """torch.profiler trace of the block (CPU, and the card where there
    is one) written as a Chrome trace into `log_dir` when it is set;
    no-op otherwise. The trace carries the program's `vireo.*` spans."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, "vireo_trace_%d.json" % os.getpid()))
