"""cellSNP reader and result writer (counterpart of
vireo_tpu/io/matrices.py, Python paths only).

`write_donor_id` keeps the reference's hard-call thresholds
(prob_max < 0.9 -> unassigned, doublet >= 0.9 -> doublet,
n_vars < 10 -> unassigned) and every format string.
"""

import gzip
from itertools import combinations

import numpy as np

from .vcf import load_VCF

__all__ = ["read_mtx", "read_cellSNP", "write_donor_id"]


def read_mtx(path):
    """MatrixMarket reader -> scipy CSC (np.loadtxt over a coordinate
    body; scipy's reader for every other layout)."""
    import scipy.sparse as sp
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError("not a MatrixMarket file: %s" % path)
        hdr = header.lower()
        if "coordinate" not in hdr or "general" not in hdr \
                or not ("real" in hdr or "integer" in hdr):
            import scipy.io as sio
            return sp.csc_matrix(sio.mmread(path))
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        n_row, n_col, _ = (int(x) for x in line.split())
        body = np.loadtxt(f, dtype=np.float64, ndmin=2)
    if body.size == 0:
        body = np.zeros((0, 3))
    rows = body[:, 0].astype(np.int64) - 1
    cols = body[:, 1].astype(np.int64) - 1
    return sp.csc_matrix((body[:, 2], (rows, cols)), shape=(n_row, n_col))


def read_cellSNP(dir_name, layers=("AD", "DP")):
    """Read a cellSNP output folder (io_utils.py:42-59)."""
    cell_dat = load_VCF(dir_name + "/cellSNP.base.vcf.gz",
                        load_sample=False, biallelic_only=False)
    for _layer in layers:
        cell_dat[_layer] = read_mtx(
            dir_name + "/cellSNP.tag.%s.mtx" % _layer)
    cell_dat['samples'] = np.genfromtxt(
        dir_name + "/cellSNP.samples.tsv", dtype=str)
    return cell_dat


def _write_tsv(fh, columns, row_iter):
    fh.write("\t".join(columns) + "\n")
    for cells in row_iter:
        fh.write("\t".join(cells) + "\n")


def _matrix_rows(names, mat, fmt):
    for i, name in enumerate(names):
        yield [name] + [fmt % v for v in mat[i, :]]


def write_donor_id(out_dir, donor_names, cell_names, n_vars, res_vireo):
    """Write donor_ids.tsv, summary.tsv, prob_singlet.tsv.gz,
    prob_doublet.tsv.gz and _log.txt (io_utils.py:91-170)."""
    singlet_p = res_vireo['ID_prob']
    pair_p = res_vireo['doublet_prob']

    top_singlet = np.max(singlet_p, axis=1)
    top_pair = np.max(pair_p, axis=1)
    best_singlet = np.array(donor_names, "U100")[np.argmax(singlet_p, 1)]
    pair_names = [",".join(x) for x in combinations(donor_names, 2)]
    best_pair = np.array(pair_names, "U100")[np.argmax(pair_p, 1)]

    hard_call = best_singlet.copy()
    hard_call[top_singlet < 0.9] = "unassigned"
    hard_call[top_pair >= 0.9] = "doublet"
    hard_call[np.asarray(n_vars) < 10] = "unassigned"

    with open(out_dir + "/_log.txt", "w") as fh:
        fh.write("logLik: %.3e\n" % (res_vireo['LB_doublet']))
        fh.write("thetas: \n%s\n" % (res_vireo['theta_shapes']))

    call_levels, call_freq = np.unique(hard_call, return_counts=True)
    with open(out_dir + "/summary.tsv", "w") as fh:
        _write_tsv(fh, ["Var1", "Freq"],
                   (["%s" % lv, "%d" % n]
                    for lv, n in zip(call_levels, call_freq)))
    print("[vireo] final donor size:")
    print("\t".join([str(x) for x in call_levels]))
    print("\t".join([str(x) for x in call_freq]))

    llr = res_vireo['doublet_LLR']
    with open(out_dir + "/donor_ids.tsv", "w") as fh:
        _write_tsv(
            fh, ["cell", "donor_id", "prob_max", "prob_doublet", "n_vars",
                 "best_singlet", "best_doublet", "doublet_logLikRatio"],
            ([cell_names[i], hard_call[i], "%.2e" % top_singlet[i],
              "%.2e" % top_pair[i], "%d" % n_vars[i], best_singlet[i],
              best_pair[i], "%.3f" % llr[i]]
             for i in range(len(cell_names))))

    with gzip.open(out_dir + "/prob_singlet.tsv.gz", "wt",
                   compresslevel=4) as fh:
        _write_tsv(fh, ["cell"] + list(donor_names),
                   _matrix_rows(cell_names, singlet_p, "%.2e"))
    with gzip.open(out_dir + "/prob_doublet.tsv.gz", "wt",
                   compresslevel=4) as fh:
        _write_tsv(fh, ["cell"] + pair_names,
                   _matrix_rows(cell_names, pair_p, "%.2e"))
