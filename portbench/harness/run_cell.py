"""One run of one cell: set-up, the measured window, the metrics, the
comparison that decides `correct`, and the result line.

Set-up makes the cell's pool from the seed on the device
(`harness/pool.py`), takes it to the host as the scipy CSC pair that
`read_cellSNP` returns, and frees the device copy. The traffic's
`input` decides what a job gets: the host matrices (`host`), or the
counts that the program's `counts_from_scipy` placed once in set-up
(`placed`). One job runs as warm-up. The window then runs whole jobs
back to back, one caller, until `seconds` have passed; the job under
way finishes.

The program's placement is held to be judged: for host input, a
wrapper of `engine/wrap.py`'s `counts_from_scipy` keeps the counts of
the latest job, dropping the previous job's before the next job places
its own (so the window's peak memory is the program's).

Once the window has closed and its peak is read, the check runs the
window's job once more with its contractions kept (`sampled.py`); its
answer is judged with the window's.
"""

import contextlib
import gc
import sys
import time

import torch

from .manifest import Manifest
from .pool import make_pool, to_host
from .sampled import Sampled, widest_gap
from .trace import Tracer, JOB, WINDOW

__all__ = ["run_cell", "FORBIDDEN", "forbidden_modules"]

# top-level module names that no run may hold once its window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "vireo_tpu")


def forbidden_modules():
    """The loaded modules whose top-level name is forbidden."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


class _HeldPlacement:
    """Keeps the counts of the latest placement made through
    `engine.wrap.counts_from_scipy`."""

    def __init__(self):
        self.counts = None

    def __enter__(self):
        from vireo_tpu_torch.engine import select, wrap
        from vireo_tpu_torch.ops.counts import counts_from_scipy as real
        self._owners = (wrap, select)
        held = self

        def place(*args, **kwargs):
            held.counts = None
            held.counts = real(*args, **kwargs)
            return held.counts
        for owner in self._owners:
            owner.counts_from_scipy = place
        self._real = real
        return self

    def __exit__(self, *exc):
        for owner in self._owners:
            owner.counts_from_scipy = self._real
        return False


class _Ctx:
    """What a per-layer reader reads."""

    def __init__(self, manifest, jobs, trace, pool, peaks):
        self.jobs, self.trace, self.pool, self.peaks = jobs, trace, pool, peaks
        self._manifest = manifest

    def work(self, name):
        return self._manifest.work(name)


def _launches():
    """The program's own kernel launch counters (K0, K2, K3)."""
    from vireo_tpu_torch.ops import counts, packed
    return dict(counts.LAUNCHES, **{"packed_" + k: v
                                    for k, v in packed.LAUNCHES.items()})


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _placement_mismatch(counts, ref):
    """Entries where the program's placed counts differ from the
    reference's (AD and DP together)."""
    dense = counts.densify()
    n = 0
    for got, want in ((dense.ad, ref.ad), (dense.dp, ref.dp)):
        if tuple(got.shape) != tuple(want.shape):
            return float(want.numel())
        for r0 in range(0, want.shape[0], 2048):
            n += int((got[r0:r0 + 2048].to(torch.int16)
                      != want[r0:r0 + 2048].to(torch.int16)).sum())
    return float(n)


def run_cell(workload, seed, seconds, trace, device, t_start, root=None,
             log=print):
    """One run; returns (result dict, the checks' lines). `device` is
    the torch device the program runs on; `t_start` the host clock at
    process start."""
    from portbench.reference.counts import Arith, RefCounts

    manifest = Manifest(root)
    cell = manifest.cell(workload)
    config, traffic = cell["config"], cell["traffic"]
    entry = manifest.entry(config["entry"])
    fit_seed = int(seed) % (1 << 32)

    # ---- set-up
    t0 = time.perf_counter()
    pool = make_pool(seed=seed, device=device, **config["pool"])
    truth = {k: pool[k] for k in ("donor", "donor2", "GT")}
    AD, DP = to_host(pool)
    del pool
    _sync(device)
    shape = dict(n_var=int(DP.shape[0]), n_cell=int(DP.shape[1]),
                 nnz_ad=int(AD.nnz), nnz_dp=int(DP.nnz))
    log("[setup] pool %(n_var)d x %(n_cell)d, nnz AD %(nnz_ad)d, DP "
        "%(nnz_dp)d" % shape + ", made and taken to the host in %.3f s"
        % (time.perf_counter() - t0))

    held = _HeldPlacement()
    with held:
        if traffic["input"] == "placed":
            from vireo_tpu_torch.ops.counts import counts_from_scipy
            placed = counts_from_scipy(AD, DP, device=device)
            held.counts = placed
            inputs = (placed, None)
        elif traffic["input"] == "host":
            inputs = (AD, DP)
        else:
            raise ValueError("traffic input is host or placed, not %r"
                             % traffic["input"])
        t0 = time.perf_counter()
        entry.job(inputs, config, fit_seed)
        _sync(device)
        log("[setup] warm-up job %.3f s" % (time.perf_counter() - t0))
        setup_s = time.perf_counter() - t_start

        # ---- the window
        tracer = Tracer(type(held.counts), entry.annotations(),
                        device_activity=device.type == "cuda") \
            if trace else contextlib.nullcontext()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        jobs, results = [], []
        launches = _launches()
        with tracer, torch.profiler.record_function(WINDOW):
            w0 = time.perf_counter()
            while True:
                j0 = time.perf_counter()
                with torch.profiler.record_function(JOB):
                    result, phases = entry.job(inputs, config, fit_seed)
                    _sync(device)
                j1 = time.perf_counter()
                jobs.append(dict(seconds=j1 - j0, phases=phases))
                results.append(result)
                if j1 - w0 >= seconds:
                    break
            w1 = time.perf_counter()
        launches = {k: v - launches.get(k, 0)
                    for k, v in _launches().items()}
        peak = torch.cuda.max_memory_allocated(device) \
            if device.type == "cuda" else 0

        # ---- the check's job, once the peak is read: the window's job
        # once more, its contractions kept; the window's last placement
        # is judged before this job places its own
        t_check = time.perf_counter()
        ref_counts = RefCounts(AD, DP, device)
        numbers = {"placement": _placement_mismatch(held.counts,
                                                    ref_counts)}
        sampled = Sampled()
        sampled.install(type(held.counts))
        try:
            results.append(entry.job(inputs, config, fit_seed)[0])
        finally:
            sampled.remove()
        log("[check] the check's job %.3f s, %d contraction calls kept"
            % (time.perf_counter() - t_check, len(sampled.calls)))
    loaded = forbidden_modules()
    if loaded:
        raise RuntimeError("modules of JAX or the JAX package were loaded: "
                           + ", ".join(loaded))
    log("[window] %d jobs in %.3f s: %s" % (
        len(jobs), w1 - w0, " ".join("%.3f" % j["seconds"] for j in jobs)))
    for name in sorted({p for j in jobs for p in j["phases"]}):
        log("[window] phase %-15s %s" % (name, " ".join(
            "%.3f" % j["phases"].get(name, 0.0) for j in jobs)))
    log("[record] %s" % entry.record(result, truth))

    # ---- metrics
    card = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    values = {"answer_s": (w1 - w0) / len(jobs), "setup_s": setup_s,
              "peak_mem_gib": peak / 2**30}
    if trace:
        ctx = _Ctx(manifest, jobs, tracer.summary, shape,
                   manifest.peaks(card))
        chosen = cell["per_layer"]
        values = {m["name"]: manifest.reader(m["name"]).read(ctx)
                  for m in chosen}
    else:
        chosen = cell["end_to_end"]
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in chosen if values.get(m["name"]) is not None}

    # ---- correct: the program's outputs against the plain reference
    inputs = placed = None
    held.counts = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers["contraction"] = widest_gap(sampled.calls, ref_counts)
    sampled.calls = None
    ref = entry.reference(ref_counts, config, fit_seed, Arith("float64"),
                          device)
    # every job's answer is due: each number is the worst over the jobs
    for res in results:
        for k, v in entry.compare(res, ref).items():
            numbers[k] = max(v, numbers.get(k, v))
    log("[check] check %.3f s" % (time.perf_counter() - t_check))
    limits = cell["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    extra = {k: v for k, v in numbers.items() if k not in limits}
    if extra:
        log("[check] not compared: %s" % extra)

    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": card, "count": cell["chips"],
           "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(jobs),
           "failed": 0 if correct else len(jobs), "metrics": metrics,
           "device": dev}
    if trace:
        s = tracer.summary
        dev["busy_s"] = s.busy_s
        dev["window_s"] = s.window_s
        out["breakdown"] = {"device_ops": s.device_ops[:10],
                            "idle_gaps": s.idle_gaps[:10]}
        n_empty = sum(1 for c in s.calls if c[5] == 0)
        log("[trace] %d contraction calls, %d without a device operation; "
            "their device operations %s; the program's launch counters over "
            "the window %s" % (len(s.calls), n_empty, s.kernel_counts,
                               launches))
    out["checks"] = checks
    lines = ["[check] %s %.6g (limit %.6g)" % (k, c["value"], c["limit"])
             for k, c in checks.items()]
    lines.append("[check] correct %s" % correct)
    return out, lines
