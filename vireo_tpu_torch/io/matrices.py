"""cellSNP and VarTrix readers, donor-VCF matching and the result
writer (counterpart of vireo_tpu/io/matrices.py).

The MatrixMarket files, the variants' VCF and the two probability
tables go through the native library (io/fast.py) when it loads, and
through the pure-Python paths below otherwise; both give the same
matrices, metadata and bytes. `write_donor_id` keeps the reference's
hard-call thresholds (prob_max < 0.9 -> unassigned, doublet >= 0.9 ->
doublet, n_vars < 10 -> unassigned) and every format string.
"""

import gzip
from concurrent.futures import ThreadPoolExecutor
from itertools import combinations

import numpy as np

from .vcf import load_VCF, match_SNPs

__all__ = ["match_donor_VCF", "read_mtx", "read_cellSNP", "read_vartrix",
           "write_donor_id", "make_whitelists"]


def read_mtx(path):
    """MatrixMarket reader -> scipy CSC: the native parser when it loads,
    else np.loadtxt over a coordinate body; scipy's reader for every
    other layout (which the native parser refuses too)."""
    import scipy.sparse as sp
    from .fast import read_mtx_fast
    fast = read_mtx_fast(path)
    if fast is not None:
        return fast
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


def match_donor_VCF(cell_dat, donor_vcf):
    """Subset the cell data and the donor VCF, in place, to the variants
    they share (`match_SNPs`, in the cell data's order)."""
    mm_idx = match_SNPs(cell_dat['variants'], donor_vcf['variants'])
    idx1 = np.where(mm_idx != None)[0]  # noqa: E711
    if len(idx1) == 0:
        print("[vireo] warning: no variants matched to donor VCF, "
              "please check chr format!")
    else:
        print("[vireo] %d out %d variants matched to donor VCF"
              % (len(idx1), len(cell_dat['variants'])))
    idx2 = mm_idx[idx1].astype(int)

    cell_dat['AD'] = cell_dat['AD'][idx1, :]
    cell_dat['DP'] = cell_dat['DP'][idx1, :]
    cell_dat["variants"] = [cell_dat["variants"][x] for x in idx1]
    for _key in cell_dat["FixedINFO"].keys():
        cell_dat["FixedINFO"][_key] = [
            cell_dat["FixedINFO"][_key][x] for x in idx1]

    donor_vcf["variants"] = [donor_vcf["variants"][x] for x in idx2]
    for _key in donor_vcf["FixedINFO"].keys():
        donor_vcf["FixedINFO"][_key] = [
            donor_vcf["FixedINFO"][_key][x] for x in idx2]
    for _key in donor_vcf["GenoINFO"].keys():
        donor_vcf["GenoINFO"][_key] = [
            donor_vcf["GenoINFO"][_key][x] for x in idx2]

    return cell_dat, donor_vcf


def _load_variants(vcf_file):
    """A VCF's variant ids and fixed columns, natively when possible."""
    from .fast import load_variants_fast
    dat = load_variants_fast(vcf_file)
    if dat is None:
        dat = load_VCF(vcf_file, load_sample=False, biallelic_only=False)
    return dat


def read_cellSNP(dir_name, layers=("AD", "DP")):
    """Read a cellSNP output folder (io_utils.py:42-59)."""
    cell_dat = _load_variants(dir_name + "/cellSNP.base.vcf.gz")
    for _layer in layers:
        cell_dat[_layer] = read_mtx(
            dir_name + "/cellSNP.tag.%s.mtx" % _layer)
    cell_dat['samples'] = np.genfromtxt(
        dir_name + "/cellSNP.samples.tsv", dtype=str)
    return cell_dat


def read_vartrix(alt_mtx, ref_mtx, cell_file, vcf_file=None):
    """Read VarTrix outputs (alt and ref count matrices, barcodes, and
    optionally the variants' VCF); DP = REF + ALT."""
    if vcf_file is not None:
        cell_dat = _load_variants(vcf_file)
        cell_dat['variants'] = np.array(cell_dat['variants'])
    else:
        cell_dat = {}
    cell_dat['AD'] = read_mtx(alt_mtx)
    cell_dat['DP'] = read_mtx(ref_mtx) + cell_dat['AD']
    cell_dat['samples'] = np.genfromtxt(cell_file, dtype=str)
    return cell_dat


def _write_tsv(fh, columns, row_iter):
    fh.write("\t".join(columns) + "\n")
    for cells in row_iter:
        fh.write("\t".join(cells) + "\n")


def _matrix_rows(names, mat, fmt, tail=None):
    """Rows of (name, formatted matrix entries[, tail(i)])."""
    for i, name in enumerate(names):
        cells = [name] + [fmt % v for v in mat[i, :]]
        if tail is not None:
            cells += tail(i)
        yield cells


def _write_matrix_gz(path, columns, names, mat, fmt="%.2e"):
    """A names + formatted-matrix table as gzip (level 4): the native
    writer's one pass when it loads, else the Python row loop; the
    decompressed bytes are the same."""
    from .fast import write_matrix_tsv_fast
    if write_matrix_tsv_fast(path, columns, names, mat, fmt, gzip_level=4):
        return
    with gzip.open(path, "wt", compresslevel=4) as fh:
        _write_tsv(fh, columns, _matrix_rows(names, mat, fmt))


def write_donor_id(out_dir, donor_names, cell_names, n_vars, res_vireo):
    """Write donor_ids.tsv, summary.tsv, prob_singlet.tsv.gz,
    prob_doublet.tsv.gz and _log.txt (io_utils.py:91-170), and
    prop_ambient.tsv when the result holds ambient fractions. The two
    probability tables are written in threads, beside each other and
    the other files (the native writer's ctypes call releases the GIL)."""
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

    pool = ThreadPoolExecutor(2)
    tables = [pool.submit(_write_matrix_gz, out_dir + "/" + name,
                          ["cell"] + list(cols), cell_names, mat)
              for name, cols, mat in (
                  ("prob_singlet.tsv.gz", donor_names, singlet_p),
                  ("prob_doublet.tsv.gz", pair_names, pair_p))]

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

    for t in tables:
        t.result()
    pool.shutdown()

    if res_vireo.get('ambient_Psi') is not None:
        ratio = res_vireo['Psi_LLRatio']
        with open(out_dir + "/prop_ambient.tsv", "w") as fh:
            _write_tsv(fh, ["cell"] + list(donor_names) + ['logLik_ratio'],
                       _matrix_rows(cell_names, res_vireo['ambient_Psi'],
                                    "%.4e",
                                    tail=lambda i: ['%.2f' % ratio[i]]))


def make_whitelists(donor_id_file, out_prefix):
    """Per-donor barcode whitelists for umi_tools (io_utils.py:172-185):
    one file per called donor, barcodes without their '-N' suffix."""
    table = np.genfromtxt(donor_id_file, dtype='str', delimiter='\t')[1:, :]
    table = table[table[:, 1] != 'unassigned', :]
    table = table[table[:, 1] != 'doublet', :]

    for _donor in np.unique(table[:, 1]):
        idx = table[:, 1] == _donor
        barcodes = table[idx, 0]
        with open(out_prefix + "_%s.txt" % _donor, "w") as fid:
            for _line in barcodes:
                fid.write(_line.split('-')[0] + '\n')
