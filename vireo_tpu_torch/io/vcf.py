"""Host-side VCF engine: streaming parse, per-sample FORMAT data,
genotype-probability decode, variant matching and VCF writing (pure
Python counterpart of vireo_tpu/io/vcf.py, same dict layouts and edge
cases), with the reference's helpers `write_VCF_to_hdf5` (h5py,
imported when called), `match_VCF_samples` and `snp_gene_match` (a
DataFrame-like gene table; the port imports no pandas).

Not ported yet (ROADMAP.md, queue 1): the JAX package's native reader
(`vireo_tpu/io/fast.py`).
"""

import gzip
import shutil
import subprocess

import numpy as np

from ..ops.matching import match, optimal_match

__all__ = ["parse_sample_info", "load_VCF", "read_sparse_GeneINFO",
           "GenoINFO_maker", "write_VCF", "parse_donor_GPb", "match_SNPs",
           "write_VCF_to_hdf5", "match_VCF_samples", "snp_gene_match"]


def _parse_samples_sparse(sample_dat, formats, tags):
    """Non-missing FORMAT entries as CSR-style string triplets: one flat
    string list per tag plus (indices, indptr) over (sample, variant),
    shape (n_sample, n_var). A uniform FORMAT across variants is
    required."""
    tag_set = set(tags)
    if any(set(f) != tag_set for f in formats):
        raise ValueError("Error: require the same format for all variants.")
    missing = {".", ":".join(["."] * len(tags))}

    columns = [[] for _ in tags]
    indices, indptr = [], [0]
    for fmt, row in zip(formats, sample_dat):
        where = [fmt.index(t) for t in tags]
        for sample_i, entry in enumerate(row[1:]):
            if entry in missing:
                continue
            parts = entry.split(":")
            for col, w in zip(columns, where):
                col.append(parts[w])
            indices.append(sample_i)
        indptr.append(len(indices))

    out = dict(zip(tags, columns))
    out["indices"] = indices
    out["indptr"] = indptr
    out["shape"] = (len(sample_dat[0]) - 1, len(sample_dat))
    # every tag is present on every kept entry in sparse mode
    return out, np.full(len(tags), len(indices), np.int64)


def _parse_samples_dense(sample_dat, formats, tags):
    """Per-variant lists of per-sample values, '.'-filled where a
    variant's FORMAT lacks the tag."""
    out = {t: [] for t in tags}
    counts = np.zeros(len(tags), np.int64)
    for fmt, row in zip(formats, sample_dat):
        parts = [e.split(":") for e in row[1:]]
        for ti, tag in enumerate(tags):
            if tag in fmt:
                w = fmt.index(tag)
                out[tag].append([p[w] for p in parts])
                counts[ti] += 1
            else:
                out[tag].append(["."] * len(parts))
    return out, counts


def parse_sample_info(sample_dat, sparse=True, format_list=None):
    """Parse per-sample FORMAT columns.

    sample_dat: list over variants of [FORMAT, sample1, sample2, ...].
    Returns (dict of per-tag values, per-tag variant counts), or None
    for no variants, and warns when any tag covers < 10% of variants.
    """
    if not sample_dat:
        return None

    formats = [row[0].split(":") for row in sample_dat]
    tags = list(format_list) if format_list is not None else formats[0]

    parse = _parse_samples_sparse if sparse else _parse_samples_dense
    RV, n_SNP_tagged = parse(sample_dat, formats, tags)

    if (n_SNP_tagged < 0.1 * len(sample_dat)).any():
        print('[vireo] Warning: too few variants with tags!',
              '\t'.join("%s: %d" % (t, n) for t, n
                        in zip(tags, n_SNP_tagged)))
    return RV, n_SNP_tagged


def _open_text(path):
    opener = gzip.open if str(path).endswith((".gz", ".bgz")) else open
    return opener(path, "rt")


def load_VCF(vcf_file, biallelic_only=False, load_sample=True, sparse=True,
             format_list=None):
    """Stream a (gzip/bgzip) VCF into the reference's dict layout:
    variant ids CHROM_POS_REF_ALT, fixed columns keyed by the #CHROM
    header, contig and comment header lines, and with `load_sample`
    the sample names, the parsed FORMAT data (`GenoINFO`) and the
    per-tag variant counts (`n_SNP_tagged`)."""
    fixed_keys, samples = [], []
    contigs, comments = [], []
    records = []

    with _open_text(vcf_file) as fh:
        for line in fh:
            line = line.rstrip()
            if not line.startswith("#"):
                row = line.split("\t")
                if biallelic_only and (len(row[3]) > 1 or len(row[4]) > 1):
                    continue
                records.append(row)
            elif line.startswith("#CHROM"):
                header = line.lstrip("#").split("\t")
                fixed_keys = header[:8]
                if load_sample:
                    samples = header[9:]
            else:
                # contig declarations appear in both lists, as in the
                # reference
                if line.startswith("##contig="):
                    contigs.append(line)
                comments.append(line)

    columns = (list(map(list, zip(*records))) if records
               else [[] for _ in fixed_keys])
    RV = {
        "variants": ["_".join((r[0], r[1], r[3], r[4])) for r in records],
        "FixedINFO": {k: columns[i] for i, k in enumerate(fixed_keys)},
        "contigs": contigs,
        "comments": comments,
    }
    if load_sample:
        RV["samples"] = samples
        RV["GenoINFO"], RV["n_SNP_tagged"] = parse_sample_info(
            [r[8:] for r in records], sparse, format_list)
    return RV


def write_VCF_to_hdf5(VCF_dat, out_file):
    """Dump a parsed VCF dict to HDF5 (vcf_utils.py:162-189)."""
    import h5py
    with h5py.File(out_file, 'w') as f:
        for key in ["contigs", "samples", "variants", "comments"]:
            f.create_dataset(key, data=np.bytes_(VCF_dat[key]),
                             compression="gzip", compression_opts=9)
        fixed = f.create_group("FixedINFO")
        for _key in VCF_dat['FixedINFO']:
            fixed.create_dataset(
                _key, data=np.bytes_(VCF_dat['FixedINFO'][_key]),
                compression="gzip", compression_opts=9)
        geno = f.create_group("GenoINFO")
        for _key in VCF_dat['GenoINFO']:
            geno.create_dataset(
                _key, data=np.bytes_(VCF_dat['GenoINFO'][_key]),
                compression="gzip", compression_opts=9)


def read_sparse_GeneINFO(GenoINFO, keys=('AD', 'DP'), axes=(-1, -1)):
    """CSR (n_var, n_sample) matrices from sparse GenoINFO triplets; a
    missing value '.' reads as 0."""
    from scipy.sparse import csr_matrix
    M, N = np.array(GenoINFO['shape']).astype('int')
    indptr = np.array(GenoINFO['indptr']).astype('int')
    indices = np.array(GenoINFO['indices']).astype('int')

    RV = {}
    for i, key in enumerate(keys):
        _dat = [x.split(",")[axes[i]] for x in GenoINFO[key]]
        data = np.array([x if x != '.' else '0' for x in _dat], dtype=float)
        RV[key] = csr_matrix((data, indices, indptr), shape=(N, M))
    return RV


def GenoINFO_maker(GT_prob, AD_reads, DP_reads):
    """GT/AD/DP/PL FORMAT fields from genotype probabilities and
    expected counts: hard calls by argmax, PL = round(-10 log10 p) of
    the posterior floored at 1e-10, AD/DP the rounded expected reads."""
    prob = np.clip(np.asarray(GT_prob, np.float64), 1e-10, None)
    hard = np.array(['0/0', '1/0', '1/1'])[np.argmax(prob, axis=2)]
    phred = np.round(-10.0 * np.log10(prob)).astype(int).astype(str)
    ad = np.round(np.asarray(AD_reads)).astype(int).astype(str)
    dp = np.round(np.asarray(DP_reads)).astype(int).astype(str)

    return {
        'GT': hard.tolist(),
        'AD': ad.tolist(),
        'DP': dp.tolist(),
        'PL': [[",".join(cat) for cat in row] for row in phred],
    }


_FORMAT_HEADERS = {
    "GT": '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n',
    "AD": ('##FORMAT=<ID=AD,Number=1,Type=Integer,Description='
           '"Read depth for each allele">\n'),
    "DP": '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read Depth">\n',
    "PL": ('##FORMAT=<ID=PL,Number=G,Type=Integer,Description='
           '"Phred-scaled genotype likelihoods">\n'),
}


def write_VCF(out_file, VCF_dat, GenoTags=('GT', 'AD', 'DP', 'PL')):
    """Write a VCF with the FORMAT headers of `GenoTags`, then compress
    it in place with bgzip, or gzip where bgzip is not installed."""
    GenoTags = list(GenoTags)
    out_file_use = out_file[:-3] if out_file.endswith(".gz") else out_file

    if "samples" not in VCF_dat:
        VCF_dat["samples"] = []
        if GenoTags != []:
            print("No sample available: GenoTags will be ignored.")

    with open(out_file_use, "w") as fid:
        for line in VCF_dat['comments']:
            tag_found = any(line.startswith("##FORMAT=<ID=" + tag)
                            for tag in GenoTags) \
                if line.startswith("##FORMAT=<ID=") else False
            if not tag_found:
                fid.write(line + "\n")

        for tag in GenoTags:
            if tag in _FORMAT_HEADERS:
                fid.write(_FORMAT_HEADERS[tag])

        VCF_COLUMN = ["CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER",
                      "INFO", "FORMAT"]
        fid.write("#" + "\t".join(VCF_COLUMN + list(VCF_dat['samples']))
                  + "\n")

        for i in range(len(VCF_dat['variants'])):
            line = [VCF_dat['FixedINFO'][x][i] for x in VCF_COLUMN[:8]]
            line.append(":".join(GenoTags))
            for s in range(len(VCF_dat['samples'])):
                line.append(":".join(
                    VCF_dat['GenoINFO'][_tag][i][s] for _tag in GenoTags))
            fid.write("\t".join(line) + "\n")

    tool = "bgzip" if shutil.which("bgzip") is not None else "gzip"
    subprocess.run([tool, "-f", out_file_use], check=True)


def parse_donor_GPb(GT_dat, tag='GT', min_prob=0.0):
    """Decode GT/GP/PL codes into a (n_var, n_donor, 3) probability
    tensor: missing codes are uniform, PL decodes as
    10^(-0.1 (PL - min) - 0.025); each code string is decoded once."""
    if tag not in ('GT', 'GP', 'PL'):
        print("[parse_donor_GPb] Error: no support tag: %s" % tag)
        return None

    memo = {}

    def decode(code):
        hit = memo.get(code)
        if hit is not None:
            return hit
        if code in (".", "./.", ".|."):
            prob = np.array([1 / 3, 1 / 3, 1 / 3])
        elif tag == 'GT':
            prob = np.zeros(3)
            prob[int(float(code[0]) + float(code[-1]))] = 1
        elif tag == 'GP':
            prob = np.array(code.split(','), float)
        else:  # PL
            phred = np.array(code.split(','), float)
            prob = 10 ** (-0.1 * (phred - phred.min()) - 0.025)
        memo[code] = prob
        return prob

    n_var = len(GT_dat)
    n_donor = len(GT_dat[0]) if n_var else 0
    GT_prob = np.zeros((n_var, n_donor, 3))
    for i in range(n_var):
        row = GT_dat[i]
        for j in range(n_donor):
            GT_prob[i, j, :] = decode(row[j])

    GT_prob += min_prob
    GT_prob /= GT_prob.sum(axis=2, keepdims=True)
    return GT_prob


def match_SNPs(SNP_ids1, SNPs_ids2):
    """Index of each id of SNP_ids1 in SNPs_ids2 (None where missing);
    when nothing matches, retried with a 'chr' prefix on the first list,
    then on the second."""
    mm_idx = match(SNP_ids1, SNPs_ids2)
    if np.mean(mm_idx == None) == 1:  # noqa: E711
        _SNP_ids1 = ["chr" + x for x in SNP_ids1]
        mm_idx = match(_SNP_ids1, SNPs_ids2)
    if np.mean(mm_idx == None) == 1:  # noqa: E711
        _SNP_ids2 = ["chr" + x for x in SNPs_ids2]
        mm_idx = match(SNP_ids1, _SNP_ids2)
    return mm_idx


def _genoprob_from_vcf(path, tag):
    """One VCF's (variant ids, sample ids, genotype-probability tensor)."""
    dat = load_VCF(path, biallelic_only=True, sparse=False,
                   format_list=[tag])
    return (np.array(dat['variants']), np.array(dat['samples']),
            parse_donor_GPb(dat['GenoINFO'][tag], tag))


def match_VCF_samples(VCF_file1, VCF_file2, GT_tag1, GT_tag2):
    """Align donors across two VCFs: intersect their variants
    (chr-prefix tolerant), then Hungarian-match donor columns on mean
    absolute genotype-probability distance.

    Behavior contract (returned keys and progress prints) follows the
    reference vcf_utils.py:353-420.
    """
    vars1, donors1, probs1 = _genoprob_from_vcf(VCF_file1, GT_tag1)
    print('Shape for Geno Prob in VCF1:', probs1.shape)
    vars2, donors2, probs2 = _genoprob_from_vcf(VCF_file2, GT_tag2)
    print('Shape for Geno Prob in VCF2:', probs2.shape)

    # variant j of VCF2 pairs with variant hit[j] of VCF1 (None = miss)
    hit = match_SNPs(vars2, vars1)
    in2 = np.flatnonzero(hit != None)  # noqa: E711
    in1 = hit[in2].astype(int)
    print("n_variants in VCF1, VCF2 and matched: %d, %d, %d"
          % (len(vars1), len(vars2), len(in2)))

    row, col, delta = optimal_match(probs1[in1], probs2[in2], axis=1,
                                    return_delta=True)
    print("aligned donors:")
    print(donors1[row])
    print(donors2[col])

    return {
        'matched_GPb_diff': delta[np.ix_(row, col)],
        'matched_donors1': donors1[row],
        'matched_donors2': donors2[col],
        'full_GPb_diff': delta,
        'full_donors1': donors1,
        'full_donors2': donors2,
        'matched_n_var': len(in2),
    }


def _signed_gene_distances(pos, starts, stops):
    """Signed distance from one position to every [start, stop] gene
    interval: negative inside the body, else the distance to the nearer
    end (vcf_utils.py:447-455 semantics, including its sign-of-zero
    behavior at exact boundaries)."""
    d_start = starts - pos
    d_stop = stops - pos
    nearer = np.minimum(np.abs(d_start), np.abs(d_stop))
    return np.sign(d_start) * np.sign(d_stop) * nearer


def snp_gene_match(varFixedINFO, gene_df, gene_key='gene', multi_gene=True,
                   gaps=[0, 1000, 10000, 100000], verbose=False):
    """Annotate each SNP with its overlapping gene(s), or the nearest
    gene within escalating distance tiers (vcf_utils.py:423-491).

    Tier semantics: gap 0 keeps every overlapped gene when `multi_gene`,
    otherwise (and for all non-zero tiers) only the nearest hit; a SNP
    with no gene within the largest gap gets an empty list and flag
    len(gaps). Gene tables are sliced once per chromosome and the
    signed distances computed once per SNP (the tier scan reuses them).
    """
    chroms = varFixedINFO['CHROM']
    gene_list = [None] * len(chroms)
    flag_list = [len(gaps)] * len(chroms)

    by_chrom = {}
    for i, chrom in enumerate(chroms):
        by_chrom.setdefault(chrom, []).append(i)

    for chrom, snp_idx in by_chrom.items():
        if verbose:
            print('processing:', chrom)
        sub = gene_df[gene_df['chrom'] == chrom]
        starts = sub['start'].values
        stops = sub['stop'].values
        names = sub[gene_key].values

        for i in snp_idx:
            dist = _signed_gene_distances(int(varFixedINFO['POS'][i]),
                                          starts, stops)
            hits = np.array([], int)
            for tier, gap in enumerate(gaps):
                hits = np.flatnonzero(dist < gap)
                if len(hits):
                    if gap > 0 or not multi_gene:
                        hits = hits[[np.argmin(dist[hits])]]
                    flag_list[i] = tier
                    break
            gene_list[i] = names[hits]

    return gene_list, flag_list
