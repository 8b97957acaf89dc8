"""The traced run: torch.profiler over the measured window, the harness's
spans and counters around the program's calls, and the reduction of the
trace to what the per-layer readers read.

Spans (torch.profiler user annotations, from the harness's files only):

- `portbench.window` around the measured window, `portbench.job` around
  each job;
- the entry's host spans (a `vireo_wrap` phase, the sweep's fit of one
  K), by class- or module-level wrappers that the entry names;
- `portbench.contraction` around each call of the two interface methods
  of the job's counts class, `suff_stats` and `cell_loglik`. The same
  wrapper records each call's kind, width N and shape, in call order.

A device operation (kernel, memcpy, memset) belongs to a contraction
call when the runtime call that launched it (the same `correlation`)
lies inside that call's span on the same thread.
"""

import contextlib
import functools
import json
import os
import tempfile

import torch

__all__ = ["Tracer", "TraceSummary", "reduce_trace"]

WINDOW = "portbench.window"
JOB = "portbench.job"
CONTRACTION = "portbench.contraction"
CONTRACTION_METHODS = ("suff_stats", "cell_loglik")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _span_call(fn, label):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with torch.profiler.record_function(label(*args, **kwargs)):
            return fn(*args, **kwargs)
    return call


def _span_context(fn, label):
    @functools.wraps(fn)
    @contextlib.contextmanager
    def call(*args, **kwargs):
        with torch.profiler.record_function(label(*args, **kwargs)):
            with fn(*args, **kwargs) as value:
                yield value
    return call


class Tracer:
    """Spans and the contraction record installed, and the profiler on,
    for the block. `counts_cls` is the class of the job's counts object;
    `annotations` the entry's (owner, attribute, label, is_context)."""

    def __init__(self, counts_cls, annotations, device_activity=True):
        self.counts_cls = counts_cls
        self.annotations = list(annotations)
        self.device_activity = device_activity
        self.calls = []
        self._saved = []
        self.summary = None

    def _contraction(self, kind, fn):
        calls = self.calls

        @functools.wraps(fn)
        def call(counts, *weights, **kwargs):
            calls.append((kind, int(weights[0].shape[1]), int(counts.n_var),
                          int(counts.n_cell)))
            with torch.profiler.record_function(CONTRACTION):
                return fn(counts, *weights, **kwargs)
        return call

    def _install(self, owner, attr, wrapped):
        self._saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, wrapped)

    def __enter__(self):
        for kind in CONTRACTION_METHODS:
            self._install(self.counts_cls, kind,
                          self._contraction(kind, getattr(self.counts_cls,
                                                          kind)))
        for owner, attr, label, is_context in self.annotations:
            fn = getattr(owner, attr)
            self._install(owner, attr, (_span_context if is_context
                                        else _span_call)(fn, label))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device_activity:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved = []
        if exc[0] is None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
            finally:
                os.unlink(path)
            self.summary = reduce_trace(events, self.calls)
        return False


def _union(intervals):
    """Merged, sorted (start, end) of `intervals`."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class TraceSummary:
    """What the readers take from a traced window; times in seconds.

    window_s, busy_s: the window's length and the union of its device
    operations; calls: per contraction call
    (kind, N, n_var, n_cell, device seconds, device operations);
    device_ops, idle_gaps: [name, seconds] by device operation and by
    what the host was doing (its innermost span) while the device
    idled, largest first."""

    def __init__(self, window_s, busy_s, calls, device_ops, idle_gaps,
                 kernel_counts):
        self.window_s = window_s
        self.busy_s = busy_s
        self.calls = calls
        self.device_ops = device_ops
        self.idle_gaps = idle_gaps
        self.kernel_counts = kernel_counts


def reduce_trace(events, calls):
    """A TraceSummary of Chrome-trace `events` and the contraction
    record `calls` (in call order)."""
    spans, launches, device = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "user_annotation":
            spans.append((s, s + d, e["name"], e.get("tid")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches.append((s, e.get("tid"), corr))
        elif cat in DEVICE_CATS:
            device.append((s, s + d, e["name"],
                           e.get("args", {}).get("correlation")))
    windows = [sp for sp in spans if sp[2] == WINDOW]
    if len(windows) != 1:
        raise RuntimeError("the trace holds %d window spans" % len(windows))
    w0, w1, _, main_tid = windows[0]
    device = [op for op in device if op[1] > w0 and op[0] < w1]
    busy = _union((max(s, w0), min(e, w1)) for s, e, _, _ in device)
    busy_us = sum(e - s for s, e in busy)

    # device operations of each contraction call
    ranges = sorted(sp for sp in spans if sp[2] == CONTRACTION)
    if len(ranges) != len(calls):
        raise RuntimeError("%d contraction spans for %d recorded calls"
                           % (len(ranges), len(calls)))
    owner = {}
    launches.sort()
    i = 0
    for k, (s, e, _, tid) in enumerate(ranges):
        while i < len(launches) and launches[i][0] < s:
            i += 1
        j = i
        while j < len(launches) and launches[j][0] <= e:
            if launches[j][1] == tid:
                owner[launches[j][2]] = k
            j += 1
    per_call = [[0.0, 0] for _ in calls]
    kernel_counts = {}
    for s, e, name, corr in device:
        k = owner.get(corr)
        if k is not None:
            per_call[k][0] += (e - s) * 1e-6
            per_call[k][1] += 1
            kernel_counts[name] = kernel_counts.get(name, 0) + 1
    out_calls = [tuple(c) + (t, n) for c, (t, n) in zip(calls, per_call)]

    by_name = {}
    for s, e, name, _ in device:
        by_name[name] = by_name.get(name, 0.0) + (min(e, w1) - max(s, w0))
    device_ops = sorted(([n, t * 1e-6] for n, t in by_name.items()),
                        key=lambda x: -x[1])

    # idle gaps, each named by the innermost host span over its middle
    host = sorted((sp for sp in spans if sp[3] == main_tid
                   and sp[2] != WINDOW), key=lambda sp: sp[0])
    gaps, edge = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    idle, stack, k = {}, [], 0
    for s, e in gaps:
        mid = 0.5 * (s + e)
        while k < len(host) and host[k][0] <= mid:
            while stack and stack[-1][1] < host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "between jobs"
        idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6
    idle_gaps = sorted(([n, t] for n, t in idle.items()),
                       key=lambda x: -x[1])
    return TraceSummary((w1 - w0) * 1e-6, busy_us * 1e-6, out_calls,
                        device_ops, idle_gaps, kernel_counts)
