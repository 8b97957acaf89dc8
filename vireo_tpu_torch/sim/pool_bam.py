"""BAM-level pool synthesis (counterpart of vireo_tpu/sim/pool_bam.py;
the reference's simulate/synth_pool.py workflow).

The reference simulator samples per-donor cell barcodes, relabels reads
with donor-suffixed barcodes, pairs a fraction of cells into synthetic
doublets, fetches reads at the SNP positions of a region VCF (sharded
into position ranges), deduplicates by read name, merges and
sorts/indexes the pooled BAM, and emits a ground-truth table
(synth_pool.py:23-95, 98-190, 194-404).

The pipeline runs against a small BAM-IO backend interface: the default
backend is pysam (+ sort/index), an optional dependency of this host
preprocessing step; the barcode bookkeeping, position-range sharding,
fetch, relabeling and dedupe logic are exercised by the tests through an
in-memory backend. Count-level synthesis lives in sim/synth.py.
"""

import numpy as np

__all__ = ["sample_barcodes", "pool_barcodes", "pool_bams",
           "load_region_positions", "shard_regions", "fetch_reads",
           "relabel_dedupe_write", "relabel_write", "main"]


def sample_barcodes(barcode_lists, n_cells, rng=None):
    """Subsample `n_cells[i]` barcodes from each donor's barcode list.

    Mirrors synth_pool.py:23-36. Returns a list of arrays.
    """
    if rng is None:
        rng = np.random
    out = []
    for i, bl in enumerate(barcode_lists):
        bl = np.asarray(bl)
        n = int(n_cells[i])
        if n > len(bl):
            raise ValueError(
                "donor %d has %d barcodes, requested %d" % (i, len(bl), n))
        idx = rng.choice(len(bl), size=n, replace=False)
        out.append(bl[np.sort(idx)])
    return out


def pool_barcodes(barcodes_per_donor, doublet_rate=0.0, rng=None):
    """Assign pooled identities, pairing cells into doublets.

    Replicates the reference's doublet accounting
    (synth_pool.py:39-95): with doublet rate d over n kept cells, the
    number of barcode pairs merged is round(n / (1 + 1/d)); merged
    cells keep the first cell's barcode. Singlet barcodes get an 'S'
    suffix convention in the truth table, doublets 'D'.

    Returns (mapping, truth_rows):
      mapping: dict old_barcode -> (new_barcode, donor_ids tuple)
      truth_rows: list of (new_barcode, donor_label, is_doublet)
    """
    if rng is None:
        rng = np.random

    flat = []
    for d, bcs in enumerate(barcodes_per_donor):
        for b in bcs:
            flat.append((b, d))
    n = len(flat)
    n_doublet_pairs = int(round(n / (1.0 + 1.0 / doublet_rate))) \
        if doublet_rate > 0 else 0

    order = rng.permutation(n)
    pair_members = order[:2 * n_doublet_pairs]
    mapping = {}
    truth_rows = []

    for k in range(n_doublet_pairs):
        i, j = pair_members[2 * k], pair_members[2 * k + 1]
        b1, d1 = flat[i]
        b2, d2 = flat[j]
        new_bc = b1 + "D"
        mapping[b1] = (new_bc, (d1, d2))
        mapping[b2] = (new_bc, (d1, d2))
        truth_rows.append((new_bc, "%d,%d" % tuple(sorted((d1, d2))), True))

    for idx in order[2 * n_doublet_pairs:]:
        b, d = flat[idx]
        new_bc = b + "S"
        mapping[b] = (new_bc, (d,))
        truth_rows.append((new_bc, "%d" % d, False))

    return mapping, truth_rows


def load_region_positions(region_vcf):
    """(chroms, positions) of the SNPs in a region VCF — the positions
    at which reads are fetched (synth_pool.py:313-318)."""
    from ..io.vcf import load_VCF
    dat = load_VCF(region_vcf, load_sample=False)
    chroms = list(dat["FixedINFO"]["CHROM"])
    positions = [int(p) for p in dat["FixedINFO"]["POS"]]
    return chroms, positions


def shard_regions(chroms, positions, n_shards):
    """Split the SNP list into `n_shards` contiguous position-range
    chunks — the reference's Pool fan-out unit per (bam, range)
    (synth_pool.py:326-353). Returns a list of (chroms, positions)."""
    n = len(positions)
    n_shards = max(1, min(n_shards, n)) if n else 1
    bounds = np.linspace(0, n, n_shards + 1).astype(int)
    return [(chroms[a:b], positions[a:b])
            for a, b in zip(bounds[:-1], bounds[1:]) if b > a]


def relabel_dedupe_write(reads, barcode_map, cell_tag, sink, seen):
    """Core of the read pipeline (synth_pool.py:124-141,355-376):
    keep reads whose cell tag maps to a pooled barcode, rewrite the
    tag, and drop duplicate read names (`seen` persists across the
    fetches of one input BAM, so a read overlapping several SNPs is
    written once). Returns the number written."""
    written = 0
    for read in reads:
        if not read.has_tag(cell_tag):
            continue
        new_bc = barcode_map.get(read.get_tag(cell_tag))
        if new_bc is None:
            continue
        name = read.query_name
        if name in seen:
            continue
        seen.add(name)
        read.set_tag(cell_tag, new_bc)
        sink.write(read)
        written += 1
    return written


def relabel_write(reads, barcode_map, cell_tag, sink):
    """Relabel + filter WITHOUT deduplication — the per-shard worker
    body of the parallel fan-out (the reference's fetch workers also
    write duplicates into their temp BAMs and dedupe at merge,
    synth_pool.py:326-376)."""
    written = 0
    for read in reads:
        if not read.has_tag(cell_tag):
            continue
        new_bc = barcode_map.get(read.get_tag(cell_tag))
        if new_bc is None:
            continue
        read.set_tag(cell_tag, new_bc)
        sink.write(read)
        written += 1
    return written


def fetch_reads(bam, regions, barcode_map, cell_tag, sink, seen):
    """Fetch reads overlapping each SNP position (the reference's
    [POS-1, POS) window, synth_pool.py:124) through the relabel +
    dedupe pipeline."""
    written = 0
    for chroms, positions in regions:
        for chrom, pos in zip(chroms, positions):
            written += relabel_dedupe_write(
                bam.fetch(chrom, pos - 1, pos), barcode_map, cell_tag,
                sink, seen)
    return written


def _fetch_shard(backend, bam_path, shard, barcode_map, cell_tag,
                 tmp_path):
    """One parallel task: own BAM handle + own temp sink for one
    position-range shard (pysam handles are not thread-safe)."""
    chroms, positions = shard
    inf = backend.open(bam_path)
    sink = backend.create(tmp_path, template=inf)
    written = 0
    for chrom, pos in zip(chroms, positions):
        written += relabel_write(inf.fetch(chrom, pos - 1, pos),
                                 barcode_map, cell_tag, sink)
    sink.close()
    inf.close()
    return written


class _PysamBackend:
    """Real BAM IO via pysam + samtools-equivalent sort/index."""

    def __init__(self):
        import pysam
        self.pysam = pysam

    def open(self, path):
        return self.pysam.AlignmentFile(path, "rb")

    def create(self, path, template):
        return self.pysam.AlignmentFile(path, "wb", template=template)

    def read_all(self, path):
        with self.pysam.AlignmentFile(path, "rb") as f:
            yield from f.fetch(until_eof=True)

    def remove(self, path):
        import os
        os.remove(path)

    def finalize(self, path, out_prefix):
        self.pysam.sort("-o", out_prefix + ".sorted.bam", path)
        self.pysam.index(out_prefix + ".sorted.bam")
        return out_prefix + ".sorted.bam"


def pool_bams(bam_files, barcode_lists, n_cells, out_prefix,
              doublet_rate=0.0, cell_tag="CB", region_vcf=None, nproc=4,
              rng=None, backend=None):
    """Merge donor BAMs into a synthetic pooled BAM with relabeled
    barcodes, read-name deduplication and a cell_info.tsv ground-truth
    table (reference pipeline synth_pool.py:194-404).

    `region_vcf`: when given, reads are fetched only at its SNP
    positions, sharded into `nproc` contiguous position ranges per BAM
    and the shards of each BAM EXECUTED CONCURRENTLY on a thread pool
    (pysam releases the GIL on file IO; the reference fans the same
    (bam, position-range) unit over a multiprocessing.Pool,
    synth_pool.py:287-294,326-353). Each shard writes its own temp
    BAM; a serial merge pass dedupes by read name into the pooled
    output — the reference's temp-BAM + dedupe-merge structure.
    Otherwise each BAM is scanned whole. `backend` abstracts the BAM
    IO (defaults to pysam; tests inject an in-memory double).
    """
    if backend is None:
        try:
            backend = _PysamBackend()
        except ImportError as e:
            raise ImportError(
                "pool_bams requires pysam (and samtools) for read-level "
                "BAM surgery; install them or use "
                "vireo_tpu_torch.sim.synth.synth_pool_counts for count-level "
                "synthesis with ground truth.") from e

    if rng is None:
        rng = np.random
    kept = sample_barcodes(barcode_lists, n_cells, rng=rng)
    mapping, truth = pool_barcodes(kept, doublet_rate, rng=rng)

    with open(out_prefix + ".cell_info.tsv", "w") as fid:
        fid.write("barcode\tdonors\tis_doublet\n")
        for bc, donors, is_dbl in truth:
            fid.write("%s\t%s\t%d\n" % (bc, donors, int(is_dbl)))

    regions = None
    if region_vcf is not None:
        chroms, positions = load_region_positions(region_vcf)
        regions = shard_regions(chroms, positions, nproc)

    out_bam = out_prefix + ".pooled.bam"
    outf = None
    total = 0
    for d, bam_path in enumerate(bam_files):
        inf = backend.open(bam_path)
        if outf is None:
            outf = backend.create(out_bam, template=inf)
        donor_map = {b: mapping[b][0] for b in kept[d] if b in mapping}
        seen = set()   # read names already written from THIS input BAM
        if regions is not None and nproc > 1 and len(regions) > 1:
            # parallel fan-out: one task per position-range shard
            from concurrent.futures import ThreadPoolExecutor
            inf.close()
            tmp = ["%s.tmp_f%d_s%d.bam" % (out_prefix, d, s)
                   for s in range(len(regions))]
            with ThreadPoolExecutor(max_workers=nproc) as ex:
                list(ex.map(
                    lambda s: _fetch_shard(backend, bam_path, regions[s],
                                           donor_map, cell_tag, tmp[s]),
                    range(len(regions))))
            for p in tmp:          # serial dedupe merge, shard order
                for read in backend.read_all(p):
                    name = read.query_name
                    if name in seen:
                        continue
                    seen.add(name)
                    outf.write(read)
                    total += 1
                backend.remove(p)
            continue
        if regions is not None:
            total += fetch_reads(inf, regions, donor_map, cell_tag,
                                 outf, seen)
        else:
            total += relabel_dedupe_write(
                inf.fetch(until_eof=True), donor_map, cell_tag, outf,
                seen)
        inf.close()
    if outf is None:
        return None
    outf.close()
    return backend.finalize(out_bam, out_prefix)


def main(argv=None):
    """CLI entry point mirroring the reference simulator's flags
    (synth_pool.py:194-267): `python -m vireo_tpu_torch.sim.pool_bam -s
    d0.bam,d1.bam -b bc0.tsv,bc1.tsv -o out [-r snps.vcf.gz ...]`."""
    import argparse
    import os
    import sys

    p = argparse.ArgumentParser(
        prog="vireo-synth-pool",
        description="Synthesize a multiplexed pool BAM from per-donor "
                    "BAMs with known cell->donor ground truth.")
    p.add_argument("--samFiles", "-s", dest="sam_files", default=None,
                   help="Input bam/sam files, comma separated.")
    p.add_argument("--barcodeFiles", "-b", dest="barcode_files",
                   default=None,
                   help="Input barcode files, comma separated.")
    p.add_argument("--regionFile", "-r", dest="region_file", default=None,
                   help="SNP list VCF; reads are fetched at its "
                        "positions.")
    p.add_argument("--noregionFile", action="store_true", default=False,
                   help="Scan whole BAMs instead of SNP positions "
                        "(mutually exclusive with --regionFile).")
    p.add_argument("--doubletRate", "-d", dest="doublet_rate",
                   type=float, default=None,
                   help="Doublet rate [default: n/100000].")
    p.add_argument("--outDir", "-o", dest="out_dir", default=None,
                   help="Output directory (pooled BAM + cell_info.tsv).")
    p.add_argument("--nproc", "-p", type=int, default=4,
                   help="Concurrent fetch tasks per BAM [default: 4].")
    p.add_argument("--nCELL", type=int, dest="n_cell", default=None,
                   help="Cells subsampled from each sample.")
    p.add_argument("--minorSAMPLE", type=float, dest="minor_sample",
                   default=1.0,
                   help="Ratio size of the first (minor) sample "
                        "[default: 1.0].")
    p.add_argument("--randomSEED", type=int, dest="random_seed",
                   default=None, help="numpy random seed.")
    args = p.parse_args(argv)

    if args.noregionFile and args.region_file:
        p.error("--regionFile and --noregionFile are mutually exclusive")
    for flag, val in (("--samFiles", args.sam_files),
                      ("--barcodeFiles", args.barcode_files),
                      ("--outDir", args.out_dir)):
        if val is None:
            print("Error: need %s." % flag)
            sys.exit(1)

    bam_files = args.sam_files.split(",")
    barcode_files = args.barcode_files.split(",")
    if len(barcode_files) != len(bam_files):
        print("Error: barcodes files are not equal to sam files.")
        sys.exit(1)
    os.makedirs(args.out_dir, exist_ok=True)

    barcode_lists = []
    for path in barcode_files:
        with open(path) as fid:
            barcode_lists.append([x.rstrip() for x in fid])

    n_cells = [len(b) for b in barcode_lists]
    if args.n_cell is not None:
        n_cells = [args.n_cell] * len(barcode_lists)
        n_cells[0] = round(args.minor_sample * args.n_cell)

    rng = np.random.RandomState(args.random_seed) \
        if args.random_seed is not None else np.random
    doublet_rate = args.doublet_rate
    if doublet_rate is None:
        doublet_rate = sum(n_cells) / 100000.0

    out = pool_bams(
        bam_files, barcode_lists, n_cells,
        os.path.join(args.out_dir, "pool"), doublet_rate=doublet_rate,
        region_vcf=args.region_file, nproc=args.nproc, rng=rng)
    print("[vireo-synth] pooled BAM: %s" % out)
    return out


if __name__ == "__main__":       # pragma: no cover
    main()
