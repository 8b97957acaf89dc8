"""Entry `vireo_wrap`: one job is the program's
`vireo_tpu_torch.engine.wrap.vireo_wrap` on the cell's input, with the
configuration's `fit` arguments and the run's seed; the reference is
`reference/vireo.py::vireo_wrap`, run on its own from the same inputs
and seed (its own restart choice, refit and doublet phase).

Donor labels are defined only up to a permutation, and restarts that
reach the same optimum in another order of labels have ELBOs a float32
sum cannot tell apart, so the numbers compared are free of labels or
matched to the reference's:

- `elbo_off`: the warm restarts whose ELBO (`LB_list`) lies further
  than `ELBO_OFF`, relatively, from the reference's for the same restart
  (the same seeded init on both sides): the inits, the placed counts and
  the warm fits. A count, as a restart now and then passes a saddle on
  another side in float32 than in float64 and ends at another optimum
  on either; the median and widest gaps are printed;
- `lb_doublet`: the relative gap of the refit's ELBO: the choice of the
  best restart and the refit;
- `llr_off`: the cells whose doublet log-likelihood ratio lies further
  than `LLR_OFF` from the reference's (the doublet phase; free of
  labels). A count, as where the program and the reference pick
  different restarts at one ELBO the refits can settle on genotypes
  that a few reads decide otherwise, which moves a few cells' ratios by
  nats; the median and widest gaps are printed;
- `calls`: the cells that both sides call with a probability of
  `CONFIDENT` or more, as the most probable singlet or doublet, and call
  differently, once the program's donors are matched to the
  reference's by their assigned cells (exact).

The harness compares the placement and the kept contractions besides
(`harness/run_cell.py`, `harness/sampled.py`).
"""

import numpy as np

__all__ = ["job", "annotations", "reference", "compare", "record"]

# a call both sides make with at least this probability is compared
CONFIDENT = 0.9
# a restart's relative ELBO gap, and a cell's LLR gap in nats, beyond
# which it counts as off
ELBO_OFF = 1e-3
LLR_OFF = 0.01


def job(inputs, config, seed):
    """One `vireo_wrap` call; returns (result, its phase seconds)."""
    from vireo_tpu_torch.engine.wrap import vireo_wrap
    AD, DP = inputs
    phases = {}
    res = vireo_wrap(AD, DP, random_seed=seed, verbose=False, timing=phases,
                     **config["fit"])
    keep = ("LB_list", "LB_doublet", "ID_prob", "doublet_prob",
            "doublet_LLR", "GT_prob")
    return {k: np.asarray(res[k]) for k in keep}, phases


def annotations():
    """Host spans of a traced run: each phase of `vireo_wrap`, and the
    seeded inits inside the warm phase."""
    from vireo_tpu_torch.engine import wrap
    from vireo_tpu_torch.utils.timing import PhaseTimer
    return [(PhaseTimer, "phase", lambda self, name: name, True),
            (wrap, "_seeded_batched_init", lambda *a, **kw: "inits", False)]


def reference(counts, config, seed, arith, device):
    from portbench.reference import vireo as ref
    fit = config["fit"]
    return ref.vireo_wrap(counts, fit["n_donor"], fit["n_init"], seed, arith,
                          max_iter_init=fit["max_iter_init"],
                          delay_fit_theta=fit["delay_fit_theta"],
                          device=device)


def _gaps(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.abs(b)


def _rel(a, b):
    return float(np.max(_gaps(a, b)))


def _calls(result, ref):
    """The calls (a donor, or K + the index of a donor pair) of the cells
    both sides call confidently, the program's donors relabelled to the
    reference's by the largest overlap of their assigned cells."""
    from itertools import combinations
    from scipy.optimize import linear_sum_assignment
    ID, ID_ref = result["ID_prob"], ref["ID_prob"]
    K = ID.shape[1]
    _, perm = linear_sum_assignment(-(ID.T.astype(np.float64) @ ID_ref))
    pairs = {p: i for i, p in enumerate(combinations(range(K), 2))}
    col = np.empty(K + len(pairs), np.int64)
    col[:K] = perm
    for (a, b), i in pairs.items():
        col[K + i] = K + pairs[tuple(sorted((perm[a], perm[b])))]
    probs = np.concatenate([ID, result["doublet_prob"]], 1)
    probs_ref = np.concatenate([ID_ref, ref["doublet_prob"]], 1)
    sure = (probs.max(1) >= CONFIDENT) & (probs_ref.max(1) >= CONFIDENT)
    return col[probs.argmax(1)][sure], probs_ref.argmax(1)[sure]


def compare(result, ref):
    calls, calls_ref = _calls(result, ref)
    gaps = _gaps(result["LB_list"], ref["LB_list"])
    llr = np.abs(np.asarray(result["doublet_LLR"], np.float64)
                 - ref["doublet_LLR"])
    return {
        "elbo_off": float(np.sum(gaps > ELBO_OFF)),
        "elbo_median": float(np.median(gaps)),
        "elbo_widest": float(gaps.max()),
        "lb_doublet": _rel(result["LB_doublet"], ref["LB_doublet"]),
        "llr_off": float(np.sum(llr > LLR_OFF)),
        "llr_median": float(np.median(llr)),
        "llr_widest": float(llr.max()),
        "other_best": float(np.argmax(result["LB_list"])
                            != np.argmax(ref["LB_list"])),
        "calls": float(np.sum(calls != calls_ref)),
    }


def record(result, truth):
    """Singlet accuracy against the generator's truth, for the record:
    donors matched to the truth by the largest overlap, over the true
    singlets that the program calls singlets."""
    from scipy.optimize import linear_sum_assignment
    ID, dbl = result["ID_prob"], result["doublet_prob"]
    K = ID.shape[1]
    called_single = ID.max(1) > dbl.max(1)
    single = truth["donor2"] < 0
    pick = single & called_single
    call = ID.argmax(1)[pick]
    overlap = np.zeros((K, K))
    np.add.at(overlap, (truth["donor"][pick], call), 1)
    rows, cols = linear_sum_assignment(-overlap)
    return {"singlet_accuracy": float(overlap[rows, cols].sum()
                                      / max(pick.sum(), 1)),
            "singlets_called": float(pick.sum() / max(single.sum(), 1))}
