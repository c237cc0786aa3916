"""Counting Bloom filter over a device counter array.

Re-design of reference include/counting_bloom_filter.hpp + src/
counting_bloom_filter.cpp for batched device execution:

  * sizing formulas identical to the reference (:70-77):
      m  = ceil(n * ln p / ln(1 / 2^ln2))
      kh = round(m * ln 2 / n)          (round = half away from zero)
  * per-key positions = (h1 + h2 of Murmur3 x64_128) mod m, one per seed
    (:90-98), with the seed truncated to its low 32 bits as the reference
    implicitly does.
  * `add` saturates counters at 255 (:28-36).  Batched formulation: each
    update round scatter-adds a uint32 histogram of positions and clamps,
    which is exactly equivalent to per-element saturating increments
    (min(255, v+a1+a2) == min(255, min(255, v+a1)+a2)).
  * `count` = min counter over the kh positions (:51-67); `find` = all
    counters nonzero (:40-48).

Determinism: seeds are drawn from a seeded PCG64 stream instead of
std::random_device (:80-87), so construct runs are reproducible.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from .murmur3 import murmur3_x64_128_u64key

_U64 = jnp.uint64


def cbf_size(n: int, p: float) -> int:
    """m = ceil(n * ln p / ln(1 / 2^ln2)) (counting_bloom_filter.cpp:70-72)."""
    return int(math.ceil((n * math.log(p)) / math.log(1.0 / math.pow(2.0, math.log(2.0)))))


def cbf_num_hashes(n: int, m: int) -> int:
    """kh = round(m * ln2 / n), round half away from zero (:75-77)."""
    return int(math.floor(m * math.log(2.0) / n + 0.5))


def make_seeds(num_hashes: int, seed: int) -> np.ndarray:
    """Deterministic uint64 hash seeds in [1, 2^64)."""
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.integers(1, np.iinfo(np.uint64).max, size=num_hashes, dtype=np.uint64)


@functools.partial(jax.jit, static_argnames=("m",))
def _positions(hashes: jnp.ndarray, seeds: jnp.ndarray, m: int) -> jnp.ndarray:
    """[N] u64 hashes x [kh] seeds -> [kh, N] u64 filter positions."""
    if m & (m - 1) == 0:  # power-of-two size: bit-and addressing
        mask = _U64(m - 1)
        return jax.vmap(lambda s: murmur3_x64_128_u64key(hashes, s) & mask)(seeds)
    out = jax.vmap(lambda s: murmur3_x64_128_u64key(hashes, s) % _U64(m))(seeds)
    return out


# Saturating-add size ladder:
#   m <= 2^30: full dense u32 histogram + one full-array combine (4 GiB
#     transient).
#   m <= 2^31: still ONE full-size scatter histogram (8 GiB; the scatter
#     index fits int32) but the saturating combine walks [_ADD_CHUNK]-row
#     slices in place -- the full-array u32 combine would need ~20 GiB.
#   m >= 2^32: single-device runs skip the filter and count exactly
#     (ops/exact_count.ExactGenomeCounter, wired in index/build.
#     make_genome_cbf); multi-device runs use ShardedCBF.  (HostCBF is a
#     host-RAM oracle kept for tests only.)  Beyond 2^31 cells the update
#     is histogrammed one position-range chunk at a time so every index
#     stays within 32 bits; each chunk re-scans all positions, so that path
#     (kept for the sharded path's oversized shards) multiplies the scatter
#     work by m/chunk.
_DENSE_ADD_MAX = 1 << 30
_DEVICE_ADD_MAX = 1 << 31
_ADD_CHUNK = 1 << 28


def _combine_hist_chunked(filt: jnp.ndarray, hist: jnp.ndarray,
                          m: int) -> jnp.ndarray:
    """filt = min(filt + hist, 255) one [_ADD_CHUNK] slice at a time, in
    place on the donated filter (bounds the u32 intermediates)."""
    for c0 in range(0, m, _ADD_CHUNK):
        width = min(_ADD_CHUNK, m - c0)
        chunk = jnp.minimum(
            jax.lax.dynamic_slice(filt, (c0,), (width,)).astype(jnp.uint32)
            + jax.lax.dynamic_slice(hist, (c0,), (width,)),
            255,
        ).astype(jnp.uint8)
        filt = jax.lax.dynamic_update_slice(filt, chunk, (c0,))
    return filt


def _saturating_update_chunked(filt: jnp.ndarray, pos_flat: jnp.ndarray,
                               inc_flat: jnp.ndarray, m: int) -> jnp.ndarray:
    """Saturating filt[p] += multiplicity(p), histogrammed one position-range
    chunk at a time (all positions are re-scanned per chunk; out-of-range
    ones drop).

    Each chunk is written back with dynamic_update_slice on the (donated)
    filter so the update runs in place -- a concatenate-of-parts version
    kept the old filter plus every part live and OOMed at m=2^32 (19.1 G
    peak on a 15.75 G chip).  When m is a multiple of the chunk, the filter
    is viewed as [m/chunk, chunk] so per-dimension indices stay within
    32 bits."""
    if m % _ADD_CHUNK == 0:
        rows = m // _ADD_CHUNK
        f2 = filt.reshape(rows, _ADD_CHUNK)
        for r in range(rows):
            c0 = r * _ADD_CHUNK
            rel = pos_flat - jnp.uint64(c0)
            inr = rel < jnp.uint64(_ADD_CHUNK)  # unsigned: below-range wraps
            idx = jnp.where(inr, rel, jnp.uint64(_ADD_CHUNK)).astype(jnp.int32)
            hist = jnp.zeros((_ADD_CHUNK,), jnp.uint32).at[idx].add(
                inc_flat, mode="drop"
            )
            chunk = jnp.minimum(f2[r].astype(jnp.uint32) + hist, 255).astype(
                jnp.uint8
            )
            f2 = jax.lax.dynamic_update_slice(f2, chunk[None], (r, 0))
        return f2.reshape(m)
    for c0 in range(0, m, _ADD_CHUNK):
        width = min(_ADD_CHUNK, m - c0)
        rel = pos_flat - jnp.uint64(c0)
        inr = rel < jnp.uint64(width)  # unsigned: below-range wraps
        idx = jnp.where(inr, rel, jnp.uint64(width)).astype(jnp.int32)
        hist = jnp.zeros((width,), jnp.uint32).at[idx].add(
            inc_flat, mode="drop"
        )
        chunk = jnp.minimum(
            jax.lax.dynamic_slice(filt, (c0,), (width,)).astype(jnp.uint32)
            + hist,
            255,
        ).astype(jnp.uint8)
        filt = jax.lax.dynamic_update_slice(filt, chunk, (c0,))
    return filt


@functools.partial(jax.jit, static_argnames=("m",), donate_argnums=(0,))
def _add(filt: jnp.ndarray, hashes: jnp.ndarray, mask: jnp.ndarray,
         seeds: jnp.ndarray, m: int) -> jnp.ndarray:
    pos = _positions(hashes, seeds, m)  # [kh, N]
    inc = jnp.broadcast_to(mask.astype(jnp.uint32), pos.shape).reshape(-1)
    if m <= _DENSE_ADD_MAX:
        hist = jnp.zeros((m,), jnp.uint32).at[pos.reshape(-1)].add(inc)
        return jnp.minimum(filt.astype(jnp.uint32) + hist, 255).astype(
            jnp.uint8
        )
    if m <= _DEVICE_ADD_MAX:
        hist = jnp.zeros((m,), jnp.uint32).at[pos.reshape(-1)].add(inc)
        return _combine_hist_chunked(filt, hist, m)
    return _saturating_update_chunked(filt, pos.reshape(-1), inc, m)


@functools.partial(jax.jit, static_argnames=("m",))
def _count(filt: jnp.ndarray, hashes: jnp.ndarray, seeds: jnp.ndarray, m: int):
    pos = _positions(hashes, seeds, m)  # [kh, N]
    vals = filt[pos]  # [kh, N] u8
    return jnp.min(vals, axis=0)


@functools.partial(jax.jit, static_argnames=("m",))
def _nonzero_frac(filt: jnp.ndarray, m: int) -> jnp.ndarray:
    """Fraction of nonzero counters, reduced one chunk at a time so no
    full-filter f32/i32 intermediate materializes (a plain mean() OOMed at
    m=2^32: 16 GB of f32)."""
    total = jnp.uint32(0)
    for c0 in range(0, m, _ADD_CHUNK):
        width = min(_ADD_CHUNK, m - c0)
        chunk = jax.lax.dynamic_slice(filt, (c0,), (width,))
        total = total + jnp.sum(chunk > 0, dtype=jnp.uint32)
    return total.astype(jnp.float64) / m


class CountingBloomFilter:
    """Counting Bloom filter with a device-resident uint8 counter array."""

    def __init__(self, n: int, p: float = 0.01, seed: int = 0,
                 _from_state: tuple | None = None):
        if _from_state is not None:
            self.size, self.num_hashes, self.seeds, self.filter = _from_state
            return
        # Deviation from the reference's exact m = ceil(n ln p / ...):
        # round the filter size UP to a power of two.  Position addressing
        # becomes a bit-and instead of a u64 modulo, and XLA compiles at most
        # log2 distinct filter shapes across genome sizes.  The false-positive
        # rate only improves; count semantics are unchanged.  (The reference's
        # own CBF contents are irreproducible anyway -- random_device seeds.)
        m_exact = cbf_size(n, p)
        m = 1
        while m < m_exact:
            m *= 2
        self.size = m
        self.num_hashes = cbf_num_hashes(n, self.size)
        self.seeds = make_seeds(self.num_hashes, seed)
        self.filter = jnp.zeros((self.size,), jnp.uint8)

    # ------------------------------------------------------------------ ops
    @staticmethod
    def _pad_pow2(hashes: np.ndarray, mask):
        """Pad query arrays to power-of-two lengths to bound recompiles."""
        hashes = np.asarray(hashes, dtype=np.uint64).reshape(-1)
        n = len(hashes)
        p = 1
        while p < n:
            p *= 2
        if mask is None:
            mask = np.ones(n, bool)
        else:
            mask = np.asarray(mask, bool).reshape(-1)
        if p != n:
            hashes = np.concatenate([hashes, np.zeros(p - n, np.uint64)])
            mask = np.concatenate([mask, np.zeros(p - n, bool)])
        return hashes, mask, n

    def add(self, hashes, mask=None) -> None:
        if hasattr(hashes, "device"):  # already device array: use as is
            h = jnp.asarray(hashes, dtype=jnp.uint64).reshape(-1)
            m = (jnp.ones(h.shape, jnp.bool_) if mask is None
                 else jnp.asarray(mask, jnp.bool_).reshape(-1))
        else:
            hp, mp, _ = self._pad_pow2(hashes, mask)
            h, m = jnp.asarray(hp), jnp.asarray(mp)
        self.filter = _add(self.filter, h, m, jnp.asarray(self.seeds), self.size)

    def count(self, hashes) -> np.ndarray:
        hp, _, n = self._pad_pow2(hashes, None)
        out = _count(self.filter, jnp.asarray(hp), jnp.asarray(self.seeds), self.size)
        return np.asarray(out)[:n]

    def find(self, hashes) -> np.ndarray:
        return self.count(hashes) > 0

    def occupancy(self) -> float:
        """Fraction of nonzero counters (reference get_cap, :100-115)."""
        return float(_nonzero_frac(self.filter, self.size))

    # ---------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            size=np.uint64(self.size),
            num_hashes=np.uint32(self.num_hashes),
            seeds=self.seeds,
            filter=np.asarray(self.filter),
        )

    @classmethod
    def load(cls, path: str) -> "CountingBloomFilter":
        z = np.load(path)
        return cls(0, _from_state=(
            int(z["size"]), int(z["num_hashes"]), z["seeds"],
            jnp.asarray(z["filter"]),
        ))


class HostCBF:
    """Host-RAM counting Bloom filter — a test/verification oracle, NOT wired
    into production (index/build.make_genome_cbf counts exactly via
    ops/exact_count for filters beyond _CBF_DEVICE_MAX; multi-device runs
    use ShardedCBF).
    Kept because its u8 counter array is directly inspectable.

    Hash positions are still computed on device (vectorized Murmur3);
    the saturating update runs on host as a sort + run-length + vectorized
    fancy-index min (numpy sorts ~50M elem/s; np.add.at would be 10x
    slower and non-saturating).  ``count`` is a host gather + min.

    Sizing uses the reference's EXACT m (no power-of-two rounding): host
    RAM is the scarce resource here and pow2 rounding doubles it worst-case;
    position addressing falls back to the u64 modulo the reference uses
    (counting_bloom_filter.cpp:90-98).
    """

    def __init__(self, n: int, p: float = 0.01, seed: int = 0):
        self.size = cbf_size(n, p)
        self.num_hashes = cbf_num_hashes(n, self.size)
        self.seeds = make_seeds(self.num_hashes, seed)
        self.filter = np.zeros(self.size, np.uint8)

    def _host_positions(self, hashes, mask=None) -> np.ndarray:
        if hasattr(hashes, "device"):
            h = jnp.asarray(hashes, dtype=jnp.uint64).reshape(-1)
            mk = (None if mask is None
                  else np.asarray(mask, bool).reshape(-1))
        else:
            hp, mp, nreal = CountingBloomFilter._pad_pow2(hashes, mask)
            h, mk = jnp.asarray(hp), mp
        pos = np.asarray(_positions(h, jnp.asarray(self.seeds), self.size))
        if mk is not None:
            pos = pos[:, mk]
        return pos.reshape(-1)

    def add(self, hashes, mask=None) -> None:
        flat = self._host_positions(hashes, mask)
        if not len(flat):
            return
        upos, counts = np.unique(flat, return_counts=True)
        cur = self.filter[upos].astype(np.uint32)
        self.filter[upos] = np.minimum(cur + counts, 255).astype(np.uint8)

    def count(self, hashes) -> np.ndarray:
        hp, _, n = CountingBloomFilter._pad_pow2(hashes, None)
        pos = np.asarray(
            _positions(jnp.asarray(hp), jnp.asarray(self.seeds), self.size)
        )
        vals = self.filter[pos]  # [kh, N] host gather
        return vals.min(axis=0)[:n]

    def find(self, hashes) -> np.ndarray:
        return self.count(hashes) > 0

    def occupancy(self) -> float:
        return float(np.count_nonzero(self.filter)) / self.size

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            size=np.uint64(self.size),
            num_hashes=np.uint32(self.num_hashes),
            seeds=self.seeds,
            filter=self.filter,
        )


class ShardedCBF:
    """Position-range-sharded counting Bloom filter over a device mesh.

    Same sizing/hash semantics as CountingBloomFilter, but the uint8 counter
    array is sharded across the mesh's devices by position range (a 3 Gbp
    genome at p=0.01 needs ~29 GB of counters).  The add path is collective-free (each device
    scatters only its range); count is a pmin across devices.
    """

    def __init__(self, n: int, p: float = 0.01, seed: int = 0, mesh=None):
        from jax.sharding import NamedSharding, PartitionSpec

        from ..parallel.mesh import (
            make_cbf_add_sharded,
            make_cbf_count_sharded,
            make_mesh,
        )

        self.mesh = mesh if mesh is not None else make_mesh()
        n_dev = self.mesh.devices.size
        m_exact = cbf_size(n, p)
        m = 1
        while m < m_exact:
            m *= 2
        while m % n_dev:  # non-power-of-two meshes: pad to a multiple
            m += 1
        self.size = m
        self.num_hashes = cbf_num_hashes(n, self.size)
        self.seeds = make_seeds(self.num_hashes, seed)
        self.filter = jax.device_put(
            jnp.zeros((m,), jnp.uint8),
            NamedSharding(self.mesh, PartitionSpec("data")),
        )
        self._add = make_cbf_add_sharded(self.mesh, m, self.num_hashes)
        self._count = make_cbf_count_sharded(self.mesh, m, self.num_hashes)
        self._nonzero_fn = None  # built lazily (occupancy is a log-line op)

    def add(self, hashes, mask=None) -> None:
        if hasattr(hashes, "device"):
            h = jnp.asarray(hashes, dtype=jnp.uint64).reshape(-1)
            m = (jnp.ones(h.shape, jnp.bool_) if mask is None
                 else jnp.asarray(mask, jnp.bool_).reshape(-1))
        else:
            hp, mp, _ = CountingBloomFilter._pad_pow2(hashes, mask)
            h, m = jnp.asarray(hp), jnp.asarray(mp)
        self.filter = self._add(self.filter, h, m, jnp.asarray(self.seeds))

    def count(self, hashes) -> np.ndarray:
        hp, _, n = CountingBloomFilter._pad_pow2(hashes, None)
        out = self._count(self.filter, jnp.asarray(hp), jnp.asarray(self.seeds))
        return np.asarray(out)[:n]

    def find(self, hashes) -> np.ndarray:
        return self.count(hashes) > 0

    def occupancy(self) -> float:
        # chunked per-shard reduction + psum: a plain f32 mean materializes
        # 4x the u8 shard size and OOMs at exactly the genome scales this
        # class exists for (see _nonzero_frac's docstring).
        if self._nonzero_fn is None:
            from ..parallel.mesh import make_cbf_nonzero_sharded

            self._nonzero_fn = make_cbf_nonzero_sharded(self.mesh, self.size)
        return float(self._nonzero_fn(self.filter)) / self.size
