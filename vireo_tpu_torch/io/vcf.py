"""Host-side VCF reading, variant ids only (counterpart of
vireo_tpu/io/vcf.py::load_VCF with load_sample=False).

Parsing per-sample FORMAT data (cell VCF input, donor VCFs) is a later
item of ROADMAP.md.
"""

import gzip

__all__ = ["load_VCF"]


def _open_text(path):
    opener = gzip.open if str(path).endswith((".gz", ".bgz")) else open
    return opener(path, "rt")


def load_VCF(vcf_file, biallelic_only=False, load_sample=False):
    """Stream a (gzip/bgzip) VCF into the reference's dict layout:
    variant ids CHROM_POS_REF_ALT, fixed columns keyed by the #CHROM
    header, contig and comment header lines."""
    if load_sample:
        raise NotImplementedError(
            "per-sample VCF parsing is not supported by the PyTorch port "
            "yet (ROADMAP.md, queue 1: donor-prior branches)")
    fixed_keys = []
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
                fixed_keys = line.lstrip("#").split("\t")[:8]
            else:
                if line.startswith("##contig="):
                    contigs.append(line)
                comments.append(line)

    columns = (list(map(list, zip(*records))) if records
               else [[] for _ in fixed_keys])
    return {
        "variants": ["_".join((r[0], r[1], r[3], r[4])) for r in records],
        "FixedINFO": {k: columns[i] for i, k in enumerate(fixed_keys)},
        "contigs": contigs,
        "comments": comments,
    }
