"""Multi-host initialization (jax.distributed) and global mesh helpers.

The reference is strictly single-process (SURVEY.md section 2.8); this is the
new first-class distributed layer.  Topology: every host streams its own
slice of the FASTQ inputs (files are assigned round-robin per process), the
k-mer table is replicated (or hash-sharded, parallel/mesh.py) across all
devices, and per-shard count deltas merge with psum over the global mesh.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

from ..utils.log import log


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Initialize jax.distributed for multi-host runs.

    With no arguments, relies on the environment (a cluster runtime that JAX
    autodetects); elsewhere pass all three.  Call once per process before
    any device computation.
    """
    kwargs = {}
    if coordinator is not None:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    log(
        f"distributed initialized: process {jax.process_index()}/"
        f"{jax.process_count()}, {jax.local_device_count()} local / "
        f"{jax.device_count()} global devices"
    )


def global_mesh(axis: str = "data") -> Mesh:
    """1-D mesh over all global devices (all hosts)."""
    return Mesh(np.array(jax.devices()), (axis,))


def assign_files_to_process(files: list[str]) -> list[str]:
    """Round-robin FASTQ file assignment per host process."""
    pid = jax.process_index()
    n = jax.process_count()
    return [f for i, f in enumerate(files) if i % n == pid]


def merge_results_across_hosts(results: dict) -> dict:
    """Union the per-process window-scoring results (each process scores its
    round-robin share of windows, engine_jax.genotype_jax); every host
    returns the identical merged dict, so downstream state stays in sync and
    process 0 can write the VCF.

    Payload rides one two-step allgather (sizes, then pickled bytes padded
    to the max) -- ~100 B/site, tens of MB at genome scale, once per
    sample."""
    import pickle

    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    blob = np.frombuffer(pickle.dumps(results), np.uint8)
    lens = np.asarray(multihost_utils.process_allgather(
        jnp.asarray([blob.size], jnp.int64)
    )).reshape(-1)
    padded = np.zeros(int(lens.max()), np.uint8)
    padded[: blob.size] = blob
    blobs = np.asarray(multihost_utils.process_allgather(jnp.asarray(padded)))
    merged: dict = {}
    for i in range(jax.process_count()):
        merged.update(pickle.loads(blobs[i, : int(lens[i])].tobytes()))
    log(f"merged scoring results from {jax.process_count()} hosts "
        f"({len(merged)} records)", func="merge_results_across_hosts")
    return merged


def merge_counts_across_hosts(cov, read_base: int):
    """Sum per-host coverage accumulators and read-base totals across all
    processes; every host returns the identical merged state.

    One collective at the end of counting (each host streams only its own
    file assignment; coverage addition is commutative).  Saturation applies
    at the u8 view, after merging, like the reference's single-threaded
    accumulation into the global map (src/fastq_kmer.cpp:126-141)."""
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    gathered = multihost_utils.process_allgather(cov)  # [n_proc, M]
    merged = jnp.asarray(gathered).sum(axis=0, dtype=jnp.uint32)
    bases = multihost_utils.process_allgather(
        jnp.asarray([read_base], jnp.uint64)
    )
    total_bases = int(np.asarray(bases).sum())
    log(
        f"merged counts from {jax.process_count()} hosts "
        f"({total_bases / 1e9:.2f} Gb total)",
        func="merge_counts_across_hosts",
    )
    return merged, total_bases
