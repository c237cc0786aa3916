"""varigraph-tpu: a pangenome genotyping engine on JAX accelerators.

A from-scratch JAX/XLA re-design of the capabilities of varigraph
(JiaoLab2021/varigraph v1.0.8, C++/CUDA): alignment-free genotyping of known
population variants via a haplotype-annotated k-mer index and a
forward-backward HMM over genome-graph nodes.

Two-phase pipeline (reference: main.cpp:34-58):
  construct  -- reference FASTA + population VCF -> haplotype-annotated k-mer
                index held as dense device arrays (sorted hash keys + payload),
                saved to a single graph file.
  genotype   -- sample FASTQ streams are k-merized on device, counted against
                the index, and scored with a batched Poisson/geometric HMM over
                haplotype combinations; emits <sample>.varigraph.vcf.gz.

Design notes:
  * the k-mer index is dense sorted arrays (not a hash map); read k-mers are
    counted against it with a sort-merge join (ops/table.count_merge).
  * the rolling canonical k-mer sketch is a parallel associative scan.
  * genotyping windows become a batch dimension: the HMM forward/backward is a
    lax.scan over nodes, vmapped over windows.
  * multi-device: read batches are data-parallel over a jax.sharding.Mesh and
    per-shard count deltas merge with psum (the reference is single-process,
    thread-pooled C++ -- see SURVEY.md section 2.4).

Determinism: unlike the reference (random_device-seeded Bloom-filter seeds and
Dirichlet draws -- counting_bloom_filter.cpp:80-87, haplotype_select.cpp:3),
every stochastic choice here is driven by an explicit integer seed.
"""

__version__ = "0.1.0"

import os

import jax

# 64-bit integer support is required for the 56-bit k-mer encoding
# (hash64(kmer) << 8 | span, reference src/kmer.cpp:43).
jax.config.update("jax_enable_x64", True)

# persistent compilation cache: JAX honours JAX_COMPILATION_CACHE_DIR itself;
# otherwise keep the cache at a fixed path in the checkout, so every process
# of a run (construct, genotype, tests) reuses what another one compiled
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     ".jax_cache"),
    )
