"""The contractions of the check's job, kept to be judged.

Once the window has closed and its peak is read, the check runs the
window's job once more: the same call on the same inputs and seed, so
the same calls at the same widths reach the same kernels. While it
runs, a class-level wrapper of the counts' two contractions,
`suff_stats` and `cell_loglik`, keeps the first call at each width N:
its weights and its results, copied to the host. The plain reference
then repeats each kept call on the same weights (`widest_gap`).

The weights are the program's own state, so this check follows the
program one contraction at a time; the end-to-end comparison beside it
starts from the inputs alone. It sees a fault that hits a few columns
(a tile of restarts) or one width (one K of a sweep), which the
end-to-end numbers can take for a restart that float32 sends to
another optimum.
"""

import functools

import torch

__all__ = ["Sampled", "widest_gap"]

METHODS = ("suff_stats", "cell_loglik")
_ABSENT = object()


def _host(x):
    return x.detach().to("cpu", copy=True)


class Sampled:
    """While installed on a counts class, `calls` keeps
    {(method, N): (weights, results)} of the first call at each width,
    on the host."""

    def __init__(self):
        self.calls = {}
        self._saved = []

    def install(self, cls):
        if any(owner is cls for owner, _, _ in self._saved):
            return
        for name in METHODS:
            self._saved.append((cls, name, cls.__dict__.get(name, _ABSENT)))
            setattr(cls, name, self._keep(name, getattr(cls, name)))

    def _keep(self, name, real):
        calls = self.calls

        @functools.wraps(real)
        def call(counts, *weights, **kwargs):
            out = real(counts, *weights, **kwargs)
            key = (name, int(weights[0].shape[1]))
            if key not in calls:
                outs = out if isinstance(out, tuple) else (out,)
                calls[key] = (tuple(_host(w) for w in weights),
                              tuple(_host(o) for o in outs))
            return out
        return call

    def remove(self):
        for owner, name, real in reversed(self._saved):
            if real is _ABSENT:
                delattr(owner, name)
            else:
                setattr(owner, name, real)
        self._saved = []


def widest_gap(calls, ref_counts, arith=None):
    """The widest relative gap of the kept calls' results from the
    plain reference's in float64 on the same weights: in each result
    column, the largest entry's gap over the column's largest magnitude.
    With `arith`, the reference in that arithmetic takes the kept
    results' place (the control)."""
    from portbench.reference.counts import Arith
    f64 = Arith("float64")
    device = ref_counts.ad.device

    def run(name, weights, a):
        if name == "suff_stats":
            return ref_counts.stats(weights[0], a)
        return (ref_counts.loglik(weights[0], weights[1], a),)

    worst = 0.0
    for (name, _), (weights, outs) in sorted(calls.items()):
        weights = [w.to(device) for w in weights]
        want = run(name, weights, f64)
        got = run(name, weights, arith) if arith is not None else \
            [o.to(device) for o in outs]
        for g, w in zip(got, want):
            if tuple(g.shape) != tuple(w.shape):
                return float("inf")
            scale = w.abs().amax(0).clamp_min(torch.finfo(w.dtype).tiny)
            gap = float(((g.to(w.dtype) - w).abs().amax(0) / scale).max())
            # a NaN result is as far off as a result can be
            worst = max(worst, gap if gap == gap else float("inf"))
        del weights, want, got
    return worst
