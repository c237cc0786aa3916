"""Exact genome k-mer frequency counting by streaming sort-merge join.

Used on one device for genomes whose counting Bloom filter would exceed
index/build._CBF_DEVICE_MAX counters (reference sizing: a 1 Gbp genome wants
a 9.6 GB filter, a 3 Gbp one ~29 GB -- src/construct_index.cpp:154-156,
src/counting_bloom_filter.cpp:70-77).

The reference needs the Bloom filter because a hash map over ~10^9 genome
k-mers doesn't fit in RAM; the filter trades memory for ~1% false
positives and random per-run seeds.  Here the trade is unnecessary: the
graph's candidate k-mers (the only keys whose genome frequency is ever
queried, ~29M at 1 Gbp) fit on-device as a sorted array, and ONE streaming
pass of the sketched genome through the superbatch sort-merge join
(ops/table.count_merge_super) yields their EXACT, deterministic
frequencies.

Counts are capped at 255 to match the reference's saturating uint8
(include/construct_index.hpp:46-47); the keep rule and frequency merge in
index/build.index_graph consume them unchanged.  Small-genome runs keep the
real CBF (ops/cbf.CountingBloomFilter) for behavioral parity with the
reference binary.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .table import _SENTINEL, count_merge_super
from ..utils.log import log


@functools.partial(jax.jit, static_argnames=("k",), donate_argnums=(0,))
def _count_codes_stack(cov: jnp.ndarray, keys: jnp.ndarray,
                       stack: jnp.ndarray, k: int) -> jnp.ndarray:
    """Sketch a [G, B, L] stack of genome code batches and join all their
    k-mers against the sorted key array in one dispatch."""
    from .kmer import sketch_codes

    def body(_, codes):
        values, emit = sketch_codes(codes, k)
        values, emit = values[..., k - 1:], emit[..., k - 1:]
        return None, jnp.where(emit, values, _SENTINEL).reshape(-1)

    _, vals = jax.lax.scan(body, None, stack)
    return count_merge_super(cov, keys, vals.reshape(-1))


class ExactGenomeCounter:
    """Drop-in for the CountingBloomFilter interface used by index_graph:
    count(hashes) -> per-hash genome frequency (exact, capped 255).

    find() and occupancy() exist for interface compatibility; occupancy
    reports the fraction of queried k-mers present in the genome (the CBF's
    counter-occupancy metric has no analog here)."""

    # genome code batches fused per device dispatch; 32 x [16384, 160]
    # batches = ~70M query slots = 560 MB of u64 per join
    ADD_STACK = 32

    def __init__(self, fasta_map: dict[str, str], n: int, k: int,
                 p: float = 0.01, seed: int = 0):
        # n/p/seed accepted for signature parity with the CBF classes; the
        # exact counter needs none of them (no filter, no hash seeds)
        self._fasta_map = fasta_map
        self._k = k
        self._present_frac = None

    def count(self, hashes) -> np.ndarray:
        """One streaming pass of the genome against the (deduplicated,
        sorted) query hashes.  Like PasswiseGenomeCBF, every call re-scans
        the genome: batch all queries into ONE call, as index_graph does."""
        from ..index.build import segment_genome_batches

        hashes = np.asarray(hashes, dtype=np.uint64).reshape(-1)
        if len(hashes) > 1 and np.all(hashes[1:] > hashes[:-1]):
            uniq, inverse = hashes, slice(None)  # index_graph's sorted-unique
        else:
            uniq, inverse = np.unique(hashes, return_inverse=True)
        keys = jnp.asarray(uniq)
        cov = jnp.zeros((len(uniq),), jnp.uint32)
        k = self._k

        g = self.ADD_STACK
        grp: list[np.ndarray] = []
        n_batches = 0
        n_joins = 0

        def flush(grp):
            nonlocal cov, n_joins
            while len(grp) < g:
                grp.append(np.full_like(grp[0], 4))
            # upload, wait for it, dispatch, wait for the join (the same
            # staging as genotype/counting; ROADMAP D1)
            dev = jnp.asarray(np.stack(grp))
            np.asarray(jax.device_get(dev[0, 0, :1]))  # force the transfer
            cov = _count_codes_stack(cov, keys, dev, k)
            np.asarray(jax.device_get(cov[:1]))
            n_joins += 1

        import time as _time

        t_last = _time.time()
        for chrom, seq in self._fasta_map.items():
            for batch in segment_genome_batches(seq, k):
                grp.append(batch)
                n_batches += 1
                if len(grp) == g:
                    flush(grp)
                    grp = []
                    if _time.time() - t_last > 30:
                        log(f"genome count progress: {n_batches} batches "
                            f"joined", func="ExactGenomeCounter")
                        t_last = _time.time()
        if grp:
            flush(grp)
        log(f"exact genome count: {n_batches} genome batches joined against "
            f"{len(uniq) / 1e6:.1f}M candidate k-mers in {n_joins} dispatches",
            func="ExactGenomeCounter")
        counts = np.asarray(jnp.minimum(cov, 255).astype(jnp.uint8))
        self._present_frac = float(np.count_nonzero(counts)) / max(len(uniq), 1)
        return counts[inverse]

    def find(self, hashes) -> np.ndarray:
        return self.count(hashes) > 0

    def occupancy(self) -> float:
        return self._present_frac or 0.0
