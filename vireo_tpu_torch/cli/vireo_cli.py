"""`vireo` command-line entry point of the PyTorch port (counterpart of
vireo_tpu/cli/vireo_cli.py).

Same flags, inputs (a cellSNP folder, a cell VCF, VarTrix files), donor
genotype modes (none, all known, a superset or a subset of the pool's
donors in `--donorFile`, extra donors) and outputs (donor_ids.tsv,
summary.tsv, prob_singlet.tsv.gz, prob_doublet.tsv.gz, _log.txt,
GT_donors.vireo.vcf.gz; prop_ambient.tsv with --callAmbientRNAs; the
genotype-distance figures unless --noPlot). Where matplotlib is not
installed the figures are skipped with a one-line note and the run ends
as usual. --timing or VIREO_TIMING=1 prints the per-phase summary of
vireo_wrap and of the writers.

    python -m vireo_tpu_torch.cli.vireo_cli -c CELLSNP_DIR -N K -o OUT
    python -m vireo_tpu_torch.cli.vireo_cli -c CELLSNP_DIR -d donors.vcf.gz \
        -t GT -o OUT

On several GPUs (or CPU ranks), one process per rank, launched by
torch.distributed.run; `--mesh VxC` splits the variants V ways and the
cells C ways (V x C ranks), `auto` the cells over every rank of a large
pool (parallel/mesh.py). Every rank reads the input; rank 0 prints and
writes every file, and each rank prints its peak device memory and its
kernels' launches.

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m vireo_tpu_torch.cli.vireo_cli -c CELLSNP_DIR -N K -o OUT --mesh 1x2
"""

import contextlib
import os
import sys
import time
import argparse

import numpy as np

from ..version import __version__
from ..utils.timing import PhaseTimer, timing_env


def build_parser():
    parser = argparse.ArgumentParser(
        prog="vireo", description="vireo-tpu-torch donor demultiplexing "
        "v%s" % __version__)
    parser.add_argument("--cellData", "-c", dest="cell_data", default=None,
                        help="The cell genotype file in VCF format or "
                             "cellSNP folder with sparse matrices.")
    parser.add_argument("--nDonor", "-N", type=int, dest="n_donor",
                        default=None,
                        help="Number of donors to demultiplex; can be "
                             "larger than provided in donor_file")
    parser.add_argument("--outDir", "-o", dest="out_dir", default=None,
                        help="Directory for output files "
                             "[default: $cellFilePath/vireo]")
    parser.add_argument("--vartrixData", dest="vartrix_data", default=None,
                        help="The cell genotype files in vartrix outputs "
                             "(three/four files, comma separated): "
                             "alt.mtx,ref.mtx,barcodes.tsv,SNPs.vcf.gz")
    parser.add_argument("--donorFile", "-d", dest="donor_file", default=None,
                        help="The donor genotype file in VCF format.")
    parser.add_argument("--genoTag", "-t", dest="geno_tag", default='PL',
                        help="The tag for donor genotype: GT, GP, PL "
                             "[default: %(default)s]")
    parser.add_argument("--noDoublet", dest="no_doublet",
                        action="store_true", default=False,
                        help="If use, not checking doublets.")
    parser.add_argument("--nInit", "-M", type=int, dest="n_init", default=50,
                        help="Number of random initializations "
                             "[default: %(default)s]")
    parser.add_argument("--extraDonor", type=int, dest="n_extra_donor",
                        default=0,
                        help="Number of extra donors in pre-cluster "
                             "[default: %(default)s]")
    parser.add_argument("--extraDonorMode", dest="extra_donor_mode",
                        default="distance",
                        help="Method for searching from extra donors: "
                             "size or distance [default: %(default)s]")
    parser.add_argument("--forceLearnGT", dest="force_learnGT",
                        default=False, action="store_true",
                        help="If use, treat donor GT as prior only.")
    parser.add_argument("--ASEmode", dest="ASE_mode", default=False,
                        action="store_true",
                        help="If use, turn on SNP-specific allelic ratio.")
    parser.add_argument("--noPlot", dest="no_plot", default=False,
                        action="store_true",
                        help="If use, turn off plotting GT distance.")
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
                        help="If use, detect ambient RNAs in each cell")
    parser.add_argument("--ambientMinGain", type=float,
                        dest="ambient_min_gain", default=None,
                        help="Min per-SNP ELBO gain for the ambient-RNA "
                             "EM [default: sqrt(n_cell)/3]")
    parser.add_argument("--nproc", "-p", type=int, dest="nproc", default=1,
                        help="Accepted for compatibility; restarts are "
                             "batched on device [default: %(default)s]")
    parser.add_argument("--checkpointDir", dest="checkpoint_dir",
                        default=None,
                        help="Directory for phase checkpoints; an "
                             "interrupted run restarted with the same "
                             "arguments resumes after the last completed "
                             "phase [default: off]")
    parser.add_argument("--timing", dest="timing", default=False,
                        action="store_true",
                        help="Print a per-phase timing summary "
                             "(also VIREO_TIMING=1)")
    parser.add_argument("--mesh", dest="mesh", default="auto",
                        help="Device mesh of the ranks launched by "
                             "torch.distributed.run: 'auto' (the cells "
                             "over every rank for big pools), 'off', or "
                             "'VxC' for a vars-x-cells mesh, e.g. '2x4' "
                             "[default: %(default)s]")
    return parser


def _resolve_cli_mesh(spec):
    """--mesh auto|off|VxC -> the vireo_wrap mesh argument: "auto", None
    or (V, C) (vireo_tpu/cli/vireo_cli.py:116-125)."""
    from ..engine.wrap import parse_mesh_spec
    return parse_mesh_spec(spec or "auto")


def _load_cells(options):
    """The cell data from a VarTrix triple or quadruple, a cellSNP folder
    or a cell VCF."""
    from ..io.matrices import read_cellSNP, read_vartrix
    from ..io.vcf import load_VCF, read_sparse_GeneINFO
    if options.vartrix_data is not None:
        print("[vireo] Loading vartrix files ...")
        vartrix_files = options.vartrix_data.split(",")
        if len(vartrix_files) < 3 or len(vartrix_files) > 4:
            print("Error: vartrixData requires 3 or 4 comma separated files")
            sys.exit(1)
        elif len(vartrix_files) == 3:
            vartrix_files.append(None)
        return read_vartrix(*vartrix_files)
    if os.path.isdir(os.path.abspath(options.cell_data)):
        print("[vireo] Loading cell folder ...")
        return read_cellSNP(options.cell_data)
    print("[vireo] Loading cell VCF file ...")
    from ..io.fast import load_cell_vcf_fast
    cell_dat = load_cell_vcf_fast(options.cell_data, tags=("AD", "DP"),
                                  biallelic_only=True)
    if cell_dat is not None:
        return cell_dat
    cell_vcf = load_VCF(options.cell_data, biallelic_only=True)
    cell_dat = read_sparse_GeneINFO(cell_vcf['GenoINFO'], keys=['AD', 'DP'])
    for _key in ['samples', 'variants', 'FixedINFO', 'contigs', 'comments']:
        cell_dat[_key] = cell_vcf[_key]
    return cell_dat


def _load_donors(options, cell_dat):
    """(cell_dat, donor_vcf, donor_GPb) matched on their shared variants;
    the CLI's three error exits."""
    from ..io.matrices import match_donor_VCF
    from ..io.vcf import load_VCF, parse_donor_GPb
    if "variants" not in cell_dat.keys():
        print("Error: No variants information is loaded, please "
              "provide base.vcf.gz")
        sys.exit(1)

    print("[vireo] Loading donor VCF file ...")
    donor_vcf = load_VCF(options.donor_file, biallelic_only=True,
                         sparse=False, format_list=[options.geno_tag])
    if (donor_vcf['n_SNP_tagged'][0] <
            (0.1 * len(donor_vcf['GenoINFO'][options.geno_tag]))):
        print("Error: No " + options.geno_tag + " tag in donor "
              "genotype; please try another tag for genotype, e.g., GT")
        print("        %s" % options.donor_file)
        sys.exit(1)

    cell_dat, donor_vcf = match_donor_VCF(cell_dat, donor_vcf)
    if len(donor_vcf['GenoINFO'][options.geno_tag]) == 0:
        print("Error: No matching variants found between cell data "
              "and donor VCF.")
        sys.exit(1)
    donor_GPb = parse_donor_GPb(donor_vcf['GenoINFO'][options.geno_tag],
                                options.geno_tag)
    return cell_dat, donor_vcf, donor_GPb


def main(argv=None):
    start_time = time.time()
    if argv is None:
        argv = sys.argv[1:]
    if len(argv) == 0:
        print("Welcome to vireo-tpu-torch v%s!\n" % __version__)
        print("use -h or --help for help on argument.")
        sys.exit(1)
    options = build_parser().parse_args(argv)
    try:
        mesh = _resolve_cli_mesh(options.mesh)
    except ValueError as e:
        sys.exit("Error: --mesh: %s" % e)

    import torch
    import torch.distributed as dist
    from ..parallel.mesh import initialize_distributed
    started = not dist.is_initialized() and initialize_distributed()
    world = dist.get_world_size() if dist.is_initialized() else 1
    if isinstance(mesh, tuple) and mesh[0] * mesh[1] != world:
        sys.exit("Error: --mesh %dx%d needs %d ranks, this run has %d: "
                 "launch it with python -m torch.distributed.run "
                 "--nproc-per-node %d -m vireo_tpu_torch.cli.vireo_cli ..."
                 % (mesh[0], mesh[1], mesh[0] * mesh[1], world,
                    mesh[0] * mesh[1]))
    rank = dist.get_rank() if dist.is_initialized() else 0
    # rank 0 prints and writes; the others run silent
    quiet = open(os.devnull, "w") if rank else None
    try:
        with contextlib.redirect_stdout(quiet) if quiet else \
                contextlib.nullcontext():
            _run(options, start_time, mesh, rank == 0)
        if world > 1:
            from ..ops import counts, fused_em, packed
            dev = torch.cuda.current_device() \
                if torch.cuda.is_initialized() else None
            peak = torch.cuda.max_memory_allocated(dev) / 2**30 \
                if dev is not None else float("nan")
            print("[vireo] rank %d of %d: peak device memory %.3f GiB, "
                  "kernel launches K0 %d %d K1 %d K2 %d K3 %d"
                  % (rank, world, peak, counts.LAUNCHES["dense_suff_stats"],
                     counts.LAUNCHES["dense_cell_loglik"], fused_em.LAUNCHES,
                     packed.LAUNCHES["suff_stats"],
                     packed.LAUNCHES["cell_loglik"]), flush=True)
    finally:
        if quiet:
            quiet.close()
        if started:
            dist.destroy_process_group()


def _run(options, start_time, mesh, root):
    """The run after the arguments: every rank computes, `root` writes."""
    from ..engine.wrap import vireo_wrap
    from ..io.matrices import write_donor_id
    from ..io.vcf import write_VCF, GenoINFO_maker
    from ..ops.matching import optimal_match

    if options.out_dir is None:
        print("Warning: no outDir provided, we use $cellFilePath/vireo.")
        input_path = options.cell_data
        if input_path is None and options.vartrix_data is not None:
            input_path = options.vartrix_data.split(",")[0]
        out_dir = os.path.dirname(os.path.abspath(input_path)) + "/vireo"
    elif os.path.dirname(options.out_dir) == "":
        out_dir = "./" + options.out_dir
    else:
        out_dir = options.out_dir
    if root:
        os.makedirs(out_dir, exist_ok=True)

    if options.cell_data is None and options.vartrix_data is None:
        print("Error: need cell data in vcf file, or cellSNP output "
              "folder, or vartrix's alt.mtx,ref.mtx,barcodes.tsv.")
        sys.exit(1)
    cell_dat = _load_cells(options)

    if options.cell_range is not None:
        lo, hi = (int(x) for x in options.cell_range.split("-"))
        cell_dat['AD'] = cell_dat['AD'][:, lo:hi]
        cell_dat['DP'] = cell_dat['DP'][:, lo:hi]
        cell_dat['samples'] = cell_dat['samples'][lo:hi]

    if cell_dat['AD'].shape[0] == 0:
        print("Error: cell data contains no variants.")
        sys.exit(1)

    # donor genotypes: all known, a subset or a superset of the pool's
    n_donor = options.n_donor
    donor_vcf = donor_GPb = None
    if options.donor_file is not None:
        cell_dat, donor_vcf, donor_GPb = _load_donors(options, cell_dat)
        if n_donor is None or n_donor == donor_GPb.shape[1]:
            n_donor = donor_GPb.shape[1]
            donor_names = donor_vcf['samples']
            learn_GT = False
        elif n_donor < donor_GPb.shape[1]:
            learn_GT = False
            donor_names = ['donor%d' % x for x in range(n_donor)]
        else:
            learn_GT = True
            donor_names = (donor_vcf['samples'] +
                           ['donor%d' % x
                            for x in range(donor_GPb.shape[1], n_donor)])
    elif n_donor is None:
        sys.exit("Error: --nDonor is required without --donorFile.")
    else:
        learn_GT = True
        donor_names = ['donor%d' % x for x in range(n_donor)]

    n_vars = np.array((cell_dat['DP'] > 0).sum(axis=0)).reshape(-1)

    if options.force_learnGT:
        learn_GT = True

    n_extra_donor = 0
    if learn_GT:
        if options.n_extra_donor is None or options.n_extra_donor == "None":
            n_extra_donor = int(round(np.sqrt(n_donor)))
        else:
            n_extra_donor = options.n_extra_donor

    n_init = options.n_init if learn_GT else 1

    print("[vireo] Demultiplex %d cells to %d donors with %d variants."
          % (cell_dat['AD'].shape[1], n_donor, cell_dat['AD'].shape[0]))
    res_vireo = vireo_wrap(
        cell_dat['AD'], cell_dat['DP'], n_donor=n_donor, GT_prior=donor_GPb,
        learn_GT=learn_GT, n_init=n_init, n_extra_donor=n_extra_donor,
        extra_donor_mode=options.extra_donor_mode,
        check_doublet=not options.no_doublet, random_seed=options.rand_seed,
        ASE_mode=options.ASE_mode, check_ambient=options.check_ambient,
        ambient_min_gain=options.ambient_min_gain, nproc=options.nproc,
        checkpoint_dir=options.checkpoint_dir,
        timing=options.timing or None, mesh=mesh)
    if not root:
        return

    # the writers' phases, printed under the same knob as vireo_wrap's
    tail_timer = PhaseTimer()
    if donor_GPb is not None and n_donor < donor_GPb.shape[1]:
        idx = optimal_match(res_vireo['GT_prob'], donor_GPb)[1]
        donor_names = [donor_vcf['samples'][x] for x in idx]

    with tail_timer.phase("result_writers"):
        write_donor_id(out_dir, donor_names, cell_dat['samples'], n_vars,
                       res_vireo)
    # the GT distance figures, over the variants with more than 3 reads a
    # donor (vireo_tpu/cli/vireo_cli.py:300-312)
    if options.no_plot is False and options.vartrix_data is None:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            print("[vireo] matplotlib is not installed: the GT distance "
                  "plots are not written (--noPlot skips them).")
        else:
            from ..plot.base_plot import plot_GT
            with tail_timer.phase("plots"):
                dp_sum = np.asarray(cell_dat['DP'].sum(axis=1)).reshape(-1)
                idx = dp_sum > (3 * n_donor)
                if learn_GT and donor_GPb is not None:
                    plot_GT(out_dir, res_vireo['GT_prob'][idx, :, :],
                            donor_names, donor_GPb[idx, :, :],
                            donor_vcf['samples'])
                else:
                    plot_GT(out_dir, res_vireo['GT_prob'][idx, :, :],
                            donor_names)

    # the donors' learnt genotypes
    if learn_GT and 'variants' in cell_dat.keys():
        with tail_timer.phase("donor_vcf"):
            donor_vcf_out = cell_dat
            donor_vcf_out['samples'] = donor_names
            donor_vcf_out['GenoINFO'] = GenoINFO_maker(
                res_vireo['GT_prob'], cell_dat['AD'] @ res_vireo['ID_prob'],
                cell_dat['DP'] @ res_vireo['ID_prob'])
            write_VCF(out_dir + "/GT_donors.vireo.vcf.gz", donor_vcf_out)
    if options.timing or timing_env():
        print(tail_timer.summary())

    run_time = time.time() - start_time
    print("[vireo] All done: %d min %.1f sec"
          % (int(run_time / 60), run_time % 60))
    print()


if __name__ == "__main__":
    main()
