"""Phase timers, throughput counters and a profiler hook (counterpart of
vireo_tpu/utils/timing.py).

`PhaseTimer` accumulates named phase durations and prints them in the
JAX package's summary format. `profile_trace` wraps a block in
`torch.profiler` and writes a Chrome trace into a directory.
"""

import contextlib
import json
import os
import time

__all__ = ["PhaseTimer", "throughput", "profile_trace", "timing_env"]


def timing_env():
    """Whether VIREO_TIMING asks for the phase summary (any value but
    0, empty, no or off), as the JAX package reads it."""
    return os.environ.get("VIREO_TIMING", "0").lower() \
        not in ("0", "", "no", "off")


class PhaseTimer:
    """Accumulates named phase durations; printable as one summary.

    `sync`, when given, is called at the end of each phase before its
    clock stops (the port passes a device synchronise, so a phase's
    time holds its own device work)."""

    def __init__(self, sync=None):
        self.phases = {}
        self._order = []
        self._sync = sync

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.time()
        try:
            yield
            if self._sync is not None:
                self._sync()
        finally:
            dt = time.time() - t0
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


def throughput(n_iters, n_cells, seconds):
    """EM throughput counters as a dict (iters/s, cell-iters/s)."""
    return {
        "em_iters_per_s": n_iters / seconds if seconds > 0 else float("inf"),
        "cell_iters_per_s": n_iters * n_cells / seconds
        if seconds > 0 else float("inf"),
        "seconds": seconds,
    }


@contextlib.contextmanager
def profile_trace(log_dir=None):
    """torch.profiler trace of the block (CPU, and the card where there
    is one) written as a Chrome trace into `log_dir` when it is set;
    no-op otherwise."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, "vireo_trace_%d.json" % os.getpid()))
