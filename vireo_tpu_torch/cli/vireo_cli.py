"""`vireo` command-line entry point of the PyTorch port: the
genotype-free cellSNP path (counterpart of vireo_tpu/cli/vireo_cli.py).

Same flags and the same outputs (donor_ids.tsv, summary.tsv,
prob_singlet.tsv.gz, prob_doublet.tsv.gz, _log.txt). The flags of the
paths not ported yet exit with an error naming their ROADMAP.md item.

    python -m vireo_tpu_torch.cli.vireo_cli -c CELLSNP_DIR -N K -o OUT
"""

import os
import sys
import time
import argparse

import numpy as np

from ..version import __version__

# flag -> (is it set?, ROADMAP.md queue-1 item that ports it)
_NOT_PORTED = (
    ("--donorFile", lambda o: o.donor_file is not None,
     "donor-prior branches"),
    ("--vartrixData", lambda o: o.vartrix_data is not None,
     "donor-prior branches"),
    ("--extraDonor > 0", lambda o: bool(o.n_extra_donor),
     "donor-prior branches"),
    ("--callAmbientRNAs", lambda o: o.check_ambient, "ambient"),
    ("--checkpointDir", lambda o: o.checkpoint_dir is not None,
     "checkpoints"),
    ("--mesh VxC", lambda o: "x" in (o.mesh or "").lower(), "multi-GPU"),
)


def build_parser():
    parser = argparse.ArgumentParser(
        prog="vireo", description="vireo-tpu-torch donor demultiplexing "
        "v%s" % __version__)
    parser.add_argument("--cellData", "-c", dest="cell_data", default=None,
                        help="The cellSNP folder with sparse matrices "
                             "(cell VCF input is not ported yet).")
    parser.add_argument("--nDonor", "-N", type=int, dest="n_donor",
                        default=None, help="Number of donors to demultiplex")
    parser.add_argument("--outDir", "-o", dest="out_dir", default=None,
                        help="Directory for output files "
                             "[default: $cellFilePath/vireo]")
    parser.add_argument("--vartrixData", dest="vartrix_data", default=None,
                        help="Not ported yet.")
    parser.add_argument("--donorFile", "-d", dest="donor_file", default=None,
                        help="Not ported yet.")
    parser.add_argument("--genoTag", "-t", dest="geno_tag", default='PL',
                        help="The tag for donor genotype (used with "
                             "--donorFile) [default: %(default)s]")
    parser.add_argument("--noDoublet", dest="no_doublet",
                        action="store_true", default=False,
                        help="If use, not checking doublets.")
    parser.add_argument("--nInit", "-M", type=int, dest="n_init", default=50,
                        help="Number of random initializations "
                             "[default: %(default)s]")
    parser.add_argument("--extraDonor", type=int, dest="n_extra_donor",
                        default=0, help="Not ported yet beyond 0.")
    parser.add_argument("--extraDonorMode", dest="extra_donor_mode",
                        default="distance",
                        help="Method for searching from extra donors "
                             "[default: %(default)s]")
    parser.add_argument("--forceLearnGT", dest="force_learnGT",
                        default=False, action="store_true",
                        help="If use, treat donor GT as prior only.")
    parser.add_argument("--ASEmode", dest="ASE_mode", default=False,
                        action="store_true",
                        help="If use, turn on SNP-specific allelic ratio.")
    parser.add_argument("--noPlot", dest="no_plot", default=False,
                        action="store_true",
                        help="Accepted; the port writes no plots yet.")
    parser.add_argument("--randSeed", type=int, dest="rand_seed",
                        default=None,
                        help="Seed for random initialization "
                             "[default: %(default)s]")
    parser.add_argument("--cellRange", type=str, dest="cell_range",
                        default=None,
                        help="Range of cells to process, e.g. 0-10000 "
                             "[default: all]")
    parser.add_argument("--callAmbientRNAs", dest="check_ambient",
                        default=False, action="store_true",
                        help="Not ported yet.")
    parser.add_argument("--ambientMinGain", type=float,
                        dest="ambient_min_gain", default=None,
                        help="Used with --callAmbientRNAs.")
    parser.add_argument("--nproc", "-p", type=int, dest="nproc", default=1,
                        help="Accepted for compatibility; restarts are "
                             "batched on device [default: %(default)s]")
    parser.add_argument("--checkpointDir", dest="checkpoint_dir",
                        default=None, help="Not ported yet.")
    parser.add_argument("--timing", dest="timing", default=False,
                        action="store_true",
                        help="Print the seconds of each phase")
    parser.add_argument("--mesh", dest="mesh", default="auto",
                        help="'auto' or 'off' (one device); a 'VxC' mesh "
                             "is not ported yet [default: %(default)s]")
    return parser


def main(argv=None):
    start_time = time.time()
    if argv is None:
        argv = sys.argv[1:]
    if len(argv) == 0:
        print("Welcome to vireo-tpu-torch v%s!\n" % __version__)
        print("use -h or --help for help on argument.")
        sys.exit(1)
    options = build_parser().parse_args(argv)

    for flag, is_set, item in _NOT_PORTED:
        if is_set(options):
            sys.exit("Error: %s is not supported by the PyTorch port yet "
                     "(ROADMAP.md, queue 1: %s)." % (flag, item))
    if options.cell_data is None:
        print("Error: need cell data as a cellSNP output folder.")
        sys.exit(1)
    if not os.path.isdir(os.path.abspath(options.cell_data)):
        sys.exit("Error: cell VCF input is not supported by the PyTorch "
                 "port yet (ROADMAP.md, queue 1: donor-prior branches); "
                 "pass a cellSNP folder.")
    if options.n_donor is None:
        sys.exit("Error: --nDonor is required without --donorFile.")

    from ..engine.wrap import vireo_wrap
    from ..io.matrices import write_donor_id, read_cellSNP

    if options.out_dir is None:
        print("Warning: no outDir provided, we use $cellFilePath/vireo.")
        out_dir = os.path.dirname(os.path.abspath(options.cell_data)) \
            + "/vireo"
    elif os.path.dirname(options.out_dir) == "":
        out_dir = "./" + options.out_dir
    else:
        out_dir = options.out_dir
    os.makedirs(out_dir, exist_ok=True)

    print("[vireo] Loading cell folder ...")
    cell_dat = read_cellSNP(options.cell_data)

    if options.cell_range is not None:
        lo, hi = (int(x) for x in options.cell_range.split("-"))
        cell_dat['AD'] = cell_dat['AD'][:, lo:hi]
        cell_dat['DP'] = cell_dat['DP'][:, lo:hi]
        cell_dat['samples'] = cell_dat['samples'][lo:hi]

    if cell_dat['AD'].shape[0] == 0:
        print("Error: cell data contains no variants.")
        sys.exit(1)

    n_donor = options.n_donor
    donor_names = ['donor%d' % x for x in range(n_donor)]
    n_vars = np.array((cell_dat['DP'] > 0).sum(axis=0)).reshape(-1)

    print("[vireo] Demultiplex %d cells to %d donors with %d variants."
          % (cell_dat['AD'].shape[1], n_donor, cell_dat['AD'].shape[0]))
    res_vireo = vireo_wrap(
        cell_dat['AD'], cell_dat['DP'], n_donor=n_donor, n_init=options.n_init,
        check_doublet=not options.no_doublet, random_seed=options.rand_seed,
        ASE_mode=options.ASE_mode, nproc=options.nproc,
        timing=options.timing or None)

    write_donor_id(out_dir, donor_names, cell_dat['samples'], n_vars,
                   res_vireo)
    print("[vireo] plots and GT_donors.vireo.vcf.gz are not written by the "
          "PyTorch port yet (ROADMAP.md, queue 1: plots and donor VCF "
          "writer).")

    run_time = time.time() - start_time
    print("[vireo] All done: %d min %.1f sec"
          % (int(run_time / 60), run_time % 60))
    print()


if __name__ == "__main__":
    main()
