"""Command-line interface: `varigraph-tpu construct|genotype`.

Mirrors the reference's subcommands and flags (main.cpp:76-235 construct,
:238-445 genotype) with additions of its own (--seed, --engine, batching,
device mesh, multi-host).
"""

from __future__ import annotations

import argparse
import os
import sys

from . import __version__
from .config import VarigraphConfig
from .utils.log import log
from .utils.timing import report


def _add_construct(sub):
    p = sub.add_parser(
        "construct",
        help="Construct a genome graph from the reference genome and variants.",
    )
    p.add_argument("-r", "--reference", required=True, metavar="FILE",
                   help="input FASTA reference file")
    p.add_argument("-v", "--vcf", required=True, metavar="FILE",
                   help="VCF file for index building")
    p.add_argument("--save-graph", default="graph.vgt", metavar="FILE",
                   help="save Genome Graph index to file [graph.vgt]")
    p.add_argument("--vcf-ploidy", type=int, default=2, metavar="INT",
                   help="ploidy of genotypes in VCF file (2-8) [2]")
    p.add_argument("-k", "--kmer", type=int, default=27, metavar="INT",
                   help="k-mer size (maximum: 28) [27]")
    p.add_argument("--fast", action="store_true",
                   help="enable 'fast mode' (skip all-zero-GT samples)")
    p.add_argument("--use-unique-kmers", action="store_true",
                   help="use only unique k-mers for indexing")
    p.add_argument("--seed", type=int, default=0,
                   help="deterministic seed for Bloom-filter hashing [0]")
    p.add_argument("-t", "--threads", type=int, default=10, metavar="INT")
    p.add_argument("-D", "--debug", action="store_true")
    return p


def _add_genotype(sub):
    p = sub.add_parser(
        "genotype",
        help="Perform genotyping and phasing based on k-mer counting.",
    )
    p.add_argument("--load-graph", default="graph.vgt", metavar="FILE",
                   help="load Genome Graph index from file [graph.vgt]")
    p.add_argument("-s", "--samples", required=True, metavar="FILE",
                   help="samples configuration file: sample r1.fq.gz r2.fq.gz")
    p.add_argument("-g", "--genotype", default="het", choices=["hom", "het"],
                   help="sample genotype: hom or het [het]")
    p.add_argument("--sample-ploidy", type=int, default=2, metavar="INT",
                   help="sample ploidy (2-8) [2]")
    p.add_argument("-n", "--number", type=int, default=15, metavar="INT",
                   help="the haploid number for genotyping [15]")
    p.add_argument("--granularity", type=float, default=1.0, metavar="FLOAT",
                   help="chromosome window length per task (Mb) [1]")
    p.add_argument("-m", "--mode", default="rec", choices=["fre", "rec"],
                   help="transition probability: haplotype frequency (fre) or "
                        "recombination rate (rec) [rec]")
    p.add_argument("--sv", action="store_true",
                   help="structural variation genotyping only")
    p.add_argument("--min-support", type=float, default=0.0, metavar="FLOAT",
                   help="minimum site quality (GQ) for genotype [0]")
    p.add_argument("--use-depth", action="store_true",
                   help="use sequencing depth as the homozygous k-mer depth")
    p.add_argument("--seed", type=int, default=0,
                   help="deterministic seed for haplotype sampling [0]")
    p.add_argument("--engine", default=None, choices=["jax", "np"],
                   help="genotyping engine: device (jax) or host oracle (np)")
    p.add_argument("--out-dir", default=".", metavar="DIR",
                   help="output directory for <sample>.varigraph.vcf.gz [.]")
    p.add_argument("--save-counts", default="", metavar="FILE",
                   help="save the counted-reads state after counting "
                        "(single-sample runs)")
    p.add_argument("--load-counts", default="", metavar="FILE",
                   help="load a counted-reads state and skip counting "
                        "(single-sample runs)")
    p.add_argument("-t", "--threads", type=int, default=10, metavar="INT",
                   help="host threads (parallel FASTQ decompression) [10]")
    p.add_argument("-D", "--debug", action="store_true")
    # device batching (the reference's --buffer MB knob, main.cu:264,505,
    # reshaped for fixed-shape device batches)
    p.add_argument("--batch-size", type=int, default=0, metavar="INT",
                   help="reads per device batch (0 = auto) [16384]")
    p.add_argument("--max-read-len", type=int, default=0, metavar="INT",
                   help="padded read length per device batch; longer reads "
                        "split with k-1 overlap (0 = auto) [160]")
    p.add_argument("--mesh-devices", type=int, default=0, metavar="INT",
                   help="devices in the counting mesh (0 = all local)")
    # multi-host (jax.distributed; no reference counterpart, SURVEY.md 5.8)
    p.add_argument("--coordinator", default="", metavar="HOST:PORT",
                   help="multi-host coordinator address (default: autodetect)")
    p.add_argument("--num-processes", type=int, default=0, metavar="INT",
                   help="number of host processes (default: autodetect)")
    p.add_argument("--process-id", type=int, default=-1, metavar="INT",
                   help="this process's rank (default: autodetect)")
    return p


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="varigraph-tpu",
        description="Accelerator genotyping and phasing based on k-mer "
                    "counting (JAX).",
    )
    parser.add_argument("--version", action="version", version=__version__)
    sub = parser.add_subparsers(dest="command")
    _add_construct(sub)
    _add_genotype(sub)
    args = parser.parse_args(argv)

    if args.command is None:
        parser.print_help(sys.stderr)
        return 1

    log(f"You are now running varigraph-tpu (v{__version__}).", func="main")
    log("Execution started ...", func="main")

    # Honor JAX_PLATFORMS from the environment explicitly, also when jax was
    # imported and configured before this point (as in-process callers and
    # the tests do), so a CPU-pinned run never initializes another backend
    # (and jax.distributed derives its topology from the pinned platform).
    plat = os.environ.get("JAX_PLATFORMS")
    if plat:
        import jax

        jax.config.update("jax_platforms", plat)

    cfg = VarigraphConfig()
    if args.command == "construct":
        cfg.ref_file = args.reference
        cfg.vcf_file = args.vcf
        cfg.output_graph_file = args.save_graph
        cfg.vcf_ploidy = max(args.vcf_ploidy, 2)
        cfg.kmer_len = max(args.kmer, 5)
        cfg.fast_mode = args.fast
        cfg.use_unique_kmers = args.use_unique_kmers
        cfg.seed = args.seed
        cfg.threads = max(args.threads, 1)
        cfg.debug = args.debug
        cfg.validate_construct()
        cfg.log_construct()

        from .index.build import construct_graph_index
        from .index.serialize import save_graph

        gi = construct_graph_index(cfg)
        save_graph(gi, cfg.output_graph_file)
    else:
        cfg.input_graph_file = args.load_graph
        cfg.samples_config_file = args.samples
        cfg.sample_type = args.genotype
        cfg.sample_ploidy = max(args.sample_ploidy, 2)
        cfg.haploid_num = args.number
        cfg.granularity_bp = int(args.granularity * 1e6)
        cfg.transition_pro_type = args.mode
        cfg.sv_genotype_only = args.sv
        cfg.min_supporting_gq = args.min_support
        cfg.use_depth = args.use_depth
        cfg.seed = args.seed
        cfg.save_counts_file = args.save_counts
        cfg.load_counts_file = args.load_counts
        if args.engine:
            cfg.engine = args.engine
        cfg.threads = max(args.threads, 1)
        if args.batch_size > 0:
            cfg.read_batch_size = args.batch_size
        if args.max_read_len > 0:
            cfg.max_read_len = args.max_read_len
        cfg.mesh_devices = max(args.mesh_devices, 0)
        cfg.debug = args.debug
        cfg.coordinator = args.coordinator
        cfg.num_processes = args.num_processes
        cfg.process_id = args.process_id
        cfg.validate_genotype()
        cfg.log_genotype()

        if cfg.coordinator or cfg.num_processes > 1:
            from .parallel.dist import initialize_distributed

            initialize_distributed(
                coordinator=cfg.coordinator or None,
                num_processes=cfg.num_processes or None,
                process_id=cfg.process_id if cfg.process_id >= 0 else None,
            )

        from .genotype.pipeline import run_genotype

        run_genotype(cfg, out_dir=args.out_dir)

    log("Done ...", func="main")
    sys.stderr.write(report("varigraph-tpu") + "\n")
    return 0


def run() -> int:
    """Entry point with the reference's log-and-exit(1) error policy."""
    try:
        return main()
    except (ValueError, FileNotFoundError, OSError) as e:
        log(f"Error: {e}", func="main")
        return 1


if __name__ == "__main__":
    sys.exit(run())
