"""Genotype-phase orchestration (reference Varigraph::fastq_genotype,
src/varigraph.cpp:153-209): load graph -> per sample: count reads on device,
estimate the coverage model, run the HMM engine, write the VCF, reset."""

from __future__ import annotations

import os

from ..config import VarigraphConfig
from ..index.serialize import load_graph
from ..index.structs import GraphIndex
from ..utils.log import log


def _rss_gb() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def _rss_now_gb() -> float:
    """Current VmRSS (ru_maxrss is the sticky peak)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1e6
    except OSError:
        pass
    return _rss_gb()
from .counting import count_reads
from .coverage import estimate_hap_coverage
from .engine_np import genotype_np, graph2node
from .vcfout import write_vcf


def parse_sample_config(path: str) -> list[tuple[str, list[str]]]:
    """Parse 'sample r1.fq.gz r2.fq.gz ...' lines (varigraph.cpp:104-146)."""
    log(f"Starting to parse the samples configuration file: {path}")
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) <= 1:
                raise ValueError(
                    "The samples configuration file is missing sequencing file "
                    f"information ({line})."
                )
            sample, files = parts[0], parts[1:]
            for f in files:
                if not os.path.exists(f) or os.path.getsize(f) == 0:
                    raise FileNotFoundError(
                        f"File '{f}' does not exist or is empty."
                    )
            out.append((sample, files))
    log(f"Number of samples: {len(out)}")
    return out


def keys_digest(keys) -> str:
    """SHA-256 of the table's sorted key array: identifies the graph a
    counts checkpoint belongs to."""
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(keys, np.uint64)).hexdigest()


def save_counts(gi: GraphIndex, path: str, read_base: int) -> None:
    """Persist the counted-reads state (the analog of the reference's unused
    FastqKmer::save_index checkpoint, src/fastq_kmer.cpp:200-298)."""
    import numpy as np

    log(f"Reads index saved to file: {path}", func="save_counts")
    with open(path, "wb") as fh:
        np.savez_compressed(fh, cov=np.asarray(gi.table.cov),
                            keys_sha256=keys_digest(gi.table.keys_np()),
                            read_base=np.uint64(read_base))


def load_counts(gi: GraphIndex, path: str) -> int:
    """Load a counted-reads checkpoint; returns the stored read-base total.
    Rejects a checkpoint counted against another graph's table."""
    import jax.numpy as jnp
    import numpy as np

    log(f"Reads index loaded from file: {path}", func="load_counts")
    z = np.load(path)
    cov = z["cov"]
    if len(cov) != gi.table.size:
        raise ValueError(
            f"counts checkpoint does not match the graph (table size "
            f"{gi.table.size} vs {len(cov)})"
        )
    if "keys_sha256" not in z.files or \
            str(z["keys_sha256"]) != keys_digest(gi.table.keys_np()):
        raise ValueError(
            "counts checkpoint does not match the graph (its table keys "
            "differ)"
        )
    gi.table.cov = jnp.asarray(cov)
    return int(z["read_base"])


import time as _time


def genotype_one_sample(
    gi: GraphIndex,
    cfg: VarigraphConfig,
    sample_name: str,
    fastq_files: list[str],
    out_dir: str = ".",
    counts_in: str | None = None,
    counts_out: str | None = None,
) -> str:
    """Count + genotype one sample; returns the output VCF path.

    Multi-host: each process streams its round-robin share of the sample's
    FASTQ files, per-host counts merge with one cross-host collective, and
    only process 0 writes the VCF (all hosts still hold identical state for
    the next sample)."""
    import jax

    multi_host = jax.process_count() > 1
    _t0 = _time.perf_counter()
    if counts_in:
        read_base = load_counts(gi, counts_in)
    else:
        files = fastq_files
        if multi_host:
            from ..parallel.dist import assign_files_to_process

            files = assign_files_to_process(fastq_files)
        read_base = count_reads(
            gi.table, files, gi.kmer_len, cfg.read_batch_size,
            cfg.max_read_len, n_devices=cfg.mesh_devices,
            io_threads=cfg.threads,
        )
        if multi_host:
            from ..parallel.dist import merge_counts_across_hosts

            gi.table.cov, read_base = merge_counts_across_hosts(
                gi.table.cov, read_base
            )
        if counts_out and (not multi_host or jax.process_index() == 0):
            # process 0 only: every host holds the identical merged state,
            # and N concurrent writers to one path is a write race
            save_counts(gi, counts_out, read_base)
    log(f"phase timing: counting {_time.perf_counter()-_t0:.2f}s "
        f"(rss now {_rss_now_gb():.1f} / peak {_rss_gb():.1f} GB)", func="genotype_one_sample")
    read_depth = read_base / float(gi.genome_size)

    _t0 = _time.perf_counter()
    cov_u8 = gi.table.cov_u8()
    freq = gi.table.freq_np()
    hap_words = gi.table.hap_words_np()  # packed; never unpacked globally
    hap_cov = estimate_hap_coverage(
        cov_u8, freq, hap_words, gi.nhap, gi.vcf_ploidy, cfg.sample_ploidy,
        read_depth, cfg.use_depth,
    )
    log(f"phase timing: coverage model {_time.perf_counter()-_t0:.2f}s "
        f"(rss now {_rss_now_gb():.1f} / peak {_rss_gb():.1f} GB)", func="genotype_one_sample")
    log(f"Size of the sequenced data: {read_base / 1e9:.2f} Gb")
    log(f"Depth of the sequenced data: {read_depth:.2f}")
    log(f"Coverage of haplotype k-mers: {hap_cov:.2f}")

    log("Genotyping ...", func="genotype")
    log("Applying forward and backward algorithm ...", func="genotype")
    if cfg.debug and cfg.engine != "np":
        log("Debug mode: using the host oracle engine for verbose traces.",
            func="genotype")
        cfg.engine = "np"
    _t0 = _time.perf_counter()
    host_arrays = (cov_u8, freq, hap_words, gi.table.refflag_np())
    if cfg.engine == "np":
        results = genotype_np(gi, cfg, hap_cov, cfg.seed, host_arrays)
    else:
        from .engine_jax import genotype_jax

        results = genotype_jax(gi, cfg, hap_cov, cfg.seed, host_arrays)
    log(f"phase timing: scoring {_time.perf_counter()-_t0:.2f}s "
        f"(rss now {_rss_now_gb():.1f} / peak {_rss_gb():.1f} GB)", func="genotype_one_sample")

    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{sample_name}.varigraph.vcf.gz")
    _t0 = _time.perf_counter()
    if not multi_host or jax.process_index() == 0:
        write_vcf(gi, results, sample_name, out_path, cfg.min_supporting_gq)
        log(f"phase timing: vcf write {_time.perf_counter()-_t0:.2f}s",
            func="genotype_one_sample")
    return out_path


def run_genotype(cfg: VarigraphConfig, out_dir: str = ".") -> list[str]:
    """Full genotype phase over all samples in the config file."""
    samples = parse_sample_config(cfg.samples_config_file)
    gi = load_graph(cfg.input_graph_file)
    # loaded k / ploidy override the CLI (varigraph.cpp:86-89)
    cfg.kmer_len = gi.kmer_len
    cfg.vcf_ploidy = gi.vcf_ploidy

    log("Merging k-mer information from Genome Graph into Nodes ...",
        func="graph2node")
    graph2node(gi)

    outputs = []
    single = len(samples) == 1
    for sample_name, fastq_files in samples:
        log(f"Processing sample: {sample_name}", func="fastq_genotype")
        outputs.append(
            genotype_one_sample(
                gi, cfg, sample_name, fastq_files, out_dir,
                counts_in=getattr(cfg, "load_counts_file", None) if single else None,
                counts_out=getattr(cfg, "save_counts_file", None) if single else None,
            )
        )
        log(f"Sample: {sample_name} has been processed.", func="fastq_genotype")
        gi.table.reset_cov()
    return outputs
