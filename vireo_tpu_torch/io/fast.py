"""Readers and writer backed by the native library (counterpart of
vireo_tpu/io/fast.py).

Cell VCF -> CSR AD/DP, a base VCF's variant ids, MatrixMarket bodies,
and formatted-matrix TSVs, each in one C++ pass; each returns None (the
writer False) when the native library is unavailable, and the callers
then use the pure-Python readers. The outputs are the layouts of those
readers (the reference's vcf_utils.py:80-205 and io_utils.py:42-59).
"""

import ctypes

import numpy as np

from ._native import lib as _native_lib

__all__ = ["native_available", "load_cell_vcf_fast", "load_variants_fast",
           "read_mtx_fast", "write_matrix_tsv_fast"]

_FIXED_KEYS = ["CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO"]


def native_available():
    return _native_lib() is not None


def _split_blob(blob):
    if not blob:
        return []
    return blob.decode("utf-8", "replace").split("\n")


def _fixed_info(fixed_lines):
    cols = [ln.split("\t") for ln in fixed_lines]
    return {k: [c[i] for c in cols] for i, k in enumerate(_FIXED_KEYS)}


def load_cell_vcf_fast(vcf_file, tags=("AD", "DP"), axes=(-1, -1),
                       biallelic_only=True):
    """A cell VCF as {'AD': csr, 'DP': csr, samples, variants, FixedINFO,
    contigs, comments} in one native pass: `load_VCF` followed by
    `read_sparse_GeneINFO` for numeric FORMAT tags. None when the native
    library is unavailable."""
    nat = _native_lib()
    if nat is None:
        return None
    from scipy.sparse import csr_matrix

    view_p = nat.cellvcf_load(
        vcf_file.encode(), ",".join(tags).encode(),
        ",".join(str(a) for a in axes).encode(), int(biallelic_only))
    try:
        v = view_p.contents
        if v.error:
            raise IOError(v.error.decode())
        n_var, n_samp, nnz = v.n_var, v.n_samp, v.nnz
        indptr = np.ctypeslib.as_array(v.indptr, shape=(n_var + 1,)).copy()
        indices = np.ctypeslib.as_array(v.indices, shape=(max(nnz, 1),))
        indices = indices[:nnz].copy()
        vals = np.ctypeslib.as_array(
            v.values, shape=(max(len(tags) * nnz, 1),))
        vals = vals[:len(tags) * nnz].copy()
        variants = _split_blob(v.variants)
        samples = _split_blob(v.samples)
        comments = _split_blob(v.comments)
        fixed_lines = _split_blob(v.fixed)
    finally:
        nat.cellvcf_free(view_p)

    RV = {}
    for i, tag in enumerate(tags):
        RV[tag] = csr_matrix(
            (vals[i * nnz:(i + 1) * nnz], indices, indptr),
            shape=(n_var, n_samp))
    RV["samples"] = samples
    RV["variants"] = variants
    RV["comments"] = comments
    RV["contigs"] = [x for x in comments if x.startswith("##contig=")]
    RV["FixedINFO"] = _fixed_info(fixed_lines)
    return RV


def load_variants_fast(vcf_file, biallelic_only=False):
    """Variant ids, comments, contigs and FixedINFO only (`load_VCF` with
    load_sample=False); None when the native library is unavailable."""
    nat = _native_lib()
    if nat is None:
        return None
    view_p = nat.cellvcf_load(vcf_file.encode(), b"", b"",
                              int(biallelic_only))
    try:
        v = view_p.contents
        if v.error:
            raise IOError(v.error.decode())
        variants = _split_blob(v.variants)
        comments = _split_blob(v.comments)
        fixed_lines = _split_blob(v.fixed)
    finally:
        nat.cellvcf_free(view_p)
    return {
        "variants": variants,
        "comments": comments,
        "contigs": [x for x in comments if x.startswith("##contig=")],
        "FixedINFO": _fixed_info(fixed_lines),
    }


def read_mtx_fast(path):
    """A MatrixMarket coordinate file as a scipy CSC matrix through the
    native parser; None when the library is unavailable or the file is
    not a numeric coordinate/general one.

    The native pass builds canonical CSC directly (a counting sort by
    column). A file with duplicate (row, col) entries makes it return
    -2, and then the COO parse goes through scipy's summing builder."""
    nat = _native_lib()
    if nat is None:
        return None
    from scipy.sparse import csc_matrix
    path = str(path)

    def ptr(a, ctype):
        return a.ctypes.data_as(ctypes.POINTER(ctype))

    shape = (ctypes.c_int64 * 3)()
    nnz = nat.mmread_csc(path.encode(), shape, None, None, None)
    if nnz < 0:
        return None
    n_col = int(shape[1])
    indptr = np.zeros(n_col + 1, np.int64)
    indices = np.zeros(max(nnz, 1), np.int32)
    vals = np.zeros(max(nnz, 1), np.float64)
    got = nat.mmread_csc(path.encode(), shape, ptr(indptr, ctypes.c_int64),
                         ptr(indices, ctypes.c_int32),
                         ptr(vals, ctypes.c_double))
    if got == shape[2]:
        M = csc_matrix((vals[:got], indices[:got], indptr),
                       shape=(int(shape[0]), n_col))
        M.has_sorted_indices = True      # the native sort guarantees it
        return M
    if got != -2:                        # a parse error
        return None

    nnz = nat.mmread_coo(path.encode(), shape, None, None, None)
    if nnz < 0:
        return None
    rows = np.zeros(max(nnz, 1), np.int32)
    cols = np.zeros(max(nnz, 1), np.int32)
    vals = np.zeros(max(nnz, 1), np.float64)
    got = nat.mmread_coo(path.encode(), shape, ptr(rows, ctypes.c_int32),
                         ptr(cols, ctypes.c_int32),
                         ptr(vals, ctypes.c_double))
    if got != shape[2]:
        return None
    return csc_matrix((vals[:got], (rows[:got], cols[:got])),
                      shape=(int(shape[0]), int(shape[1])))


def write_matrix_tsv_fast(path, columns, names, mat, fmt, gzip_level=0):
    """Write a header, then one row per name: the name and `fmt` of each
    entry of that row of `mat`, tab-separated, through the native writer.
    Its bytes are those of the Python `fmt % v` loop (glibc and CPython
    both print correctly rounded %.*e with two-digit exponents).
    `gzip_level` > 0 gzips in the same pass. Returns False when the
    native library is unavailable or the write failed."""
    nat = _native_lib()
    if nat is None:
        return False
    mat = np.ascontiguousarray(mat, np.float64)
    header = "\t".join(columns)
    blob = "\n".join(str(n) for n in names)
    rc = nat.write_matrix_tsv(
        str(path).encode(), header.encode(), blob.encode(),
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        mat.shape[0], mat.shape[1], fmt.encode(), int(gzip_level))
    return rc == 0
