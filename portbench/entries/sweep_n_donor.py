"""Entry `sweep_n_donor`: one job is the program's
`vireo_tpu_torch.engine.select.sweep_n_donor` (the ELBO sweep over the
number of donors) on the cell's input, with the configuration's `fit`
arguments and the run's seed; the reference is
`reference/vireo.py::sweep_n_donor`.

The numbers compared:

- `elbo_off`: the most restarts of one K whose ELBO lies further than
  `ELBO_OFF`, relatively, from the reference's for the same K and
  restart (a count, as in entry `vireo_wrap`; per K, so that a fault at
  one K's width shows; the median and widest gaps over every K are
  printed);
- `best_k`: how far the K the program picks lies from the reference's
  (0 or a number of donors; exact).

The harness compares the placement and the kept contractions besides
(`harness/run_cell.py`, `harness/sampled.py`).
"""

import numpy as np

__all__ = ["job", "annotations", "reference", "compare", "record"]

# a restart's relative ELBO gap beyond which it counts as off
ELBO_OFF = 1e-3


def job(inputs, config, seed):
    from vireo_tpu_torch.engine.select import sweep_n_donor
    AD, DP = inputs
    fit = dict(config["fit"])
    res = sweep_n_donor(AD, DP, random_seed=seed, verbose=False,
                        n_donor_list=tuple(fit.pop("n_donor_list")), **fit)
    return res, {}


def annotations():
    """Host spans of a traced run: the seeded inits and the fit of each
    K."""
    from vireo_tpu_torch.engine import select, wrap
    return [(wrap, "_seeded_batched_init",
             lambda cfg, *a, **kw: "inits K=%d" % cfg.n_donor, False),
            (select, "fit_vb",
             lambda counts, state, priors, cfg, **kw: "fit K=%d" % cfg.n_donor,
             False)]


def reference(counts, config, seed, arith, device):
    from portbench.reference import vireo as ref
    fit = config["fit"]
    return ref.sweep_n_donor(counts, fit["n_donor_list"], fit["n_init"], seed,
                             arith, max_iter_init=fit["max_iter_init"],
                             delay_fit_theta=fit["delay_fit_theta"],
                             device=device)


def compare(result, ref):
    gaps = [np.abs(np.asarray(result[k], np.float64) - ref[k]) / np.abs(ref[k])
            for k in ref if k != "best"]
    every = np.concatenate(gaps)
    return {"elbo_off": float(max(np.sum(g > ELBO_OFF) for g in gaps)),
            "elbo_median": float(np.median(every)),
            "elbo_widest": float(every.max()),
            "best_k": float(abs(result["best"] - ref["best"]))}


def record(result, truth):
    return {"best_k": int(result["best"]),
            "true_k": int(truth["GT"].shape[1])}
