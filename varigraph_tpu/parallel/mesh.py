"""Multi-chip execution over a jax.sharding.Mesh.

The reference has no distributed mode at all (SURVEY.md section 2.4: a CPU
thread pool plus one optional CUDA device).  This layer is new; the mesh is
1-D and topology-free (every device reaches every other):

  * mesh axis "data": read batches are sharded across devices; each device
    sketches and probes its shard, per-shard count deltas merge with psum
    (replicated-table mode).
  * hash-range sharding: for large tables, keys/cov are sharded along the
    table axis; each device probes its local key range against the
    (all-gathered) query batch and keeps its own coverage shard -- no
    collective needed on the update path at all.
  * genotyping windows are a batch dimension (window-parallel scoring):
    the [W, N, S] forward/backward in engine_jax vmaps over windows, so
    sharding W across "data" distributes the HMM with zero code change.

All functions are shard_map'd and jitted; they run identically on several
GPUs or on `--xla_force_host_platform_device_count=N` virtual CPU devices.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.kmer import sketch_codes
from ..ops.table import count_merge


def make_mesh(n_devices: int = 0, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices <= 0:
        n_devices = len(devs)
    return Mesh(np.array(devs[:n_devices]), (axis,))


# ----------------------------------------------------------------------
# data-parallel counting with a replicated table
# ----------------------------------------------------------------------

def make_count_batch_replicated(mesh: Mesh, k: int):
    """Returns a jitted step: (cov, keys, codes[B, L]) -> cov.

    codes are sharded along the batch axis; the coverage update is a
    per-shard scatter-add followed by a psum over the data axis.
    """

    def shard_fn(cov, keys, codes):
        values, emit = sketch_codes(codes, k)
        # positions 0..k-2 never emit; drop them before the join
        values, emit = values[..., k - 1 :], emit[..., k - 1 :]
        delta = count_merge(
            jnp.zeros_like(cov), keys, values.reshape(-1), emit.reshape(-1)
        )
        delta = jax.lax.psum(delta, "data")
        return cov + delta

    mapped = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P("data", None)),
        out_specs=P(),
    )
    return jax.jit(mapped, donate_argnums=(0,))


def count_batch_replicated(mesh: Mesh, k: int, cov, keys, codes):
    return make_count_batch_replicated(mesh, k)(cov, keys, codes)


def make_count_batch_replicated_packed(mesh: Mesh, k: int):
    """As make_count_batch_replicated, but the batch arrives in the 2-bit
    packed wire format ([B, L/4+2] rows, ops/kmer.unpack_2bit) -- the
    production count_reads feed."""
    from ..ops.kmer import sketch_packed

    def shard_fn(cov, keys, packed):
        values, emit = sketch_packed(packed, k)
        # positions 0..k-2 never emit; drop them before the join
        values, emit = values[..., k - 1 :], emit[..., k - 1 :]
        delta = count_merge(
            jnp.zeros_like(cov), keys, values.reshape(-1), emit.reshape(-1)
        )
        delta = jax.lax.psum(delta, "data")
        return cov + delta

    mapped = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P("data", None)),
        out_specs=P(),
    )
    return jax.jit(mapped, donate_argnums=(0,))


# ----------------------------------------------------------------------
# hash-range-sharded table
# ----------------------------------------------------------------------

def shard_table_arrays(mesh: Mesh, keys: np.ndarray, cov: np.ndarray):
    """Pad the sorted key array to a multiple of the mesh size and place
    keys/cov sharded along the table axis."""
    n = mesh.devices.size
    m = len(keys)
    pad = (-m) % n
    if pad:
        # pad value: sorts last, low "span" byte 0x1F is never a real k-mer
        # span and keeps bit 7 clear (count_merge uses bit 7 as the
        # key/query tag)
        keys = np.concatenate([keys, np.full(pad, np.uint64(0xFFFFFFFFFFFFFF1F))])
        cov = np.concatenate([cov, np.zeros(pad, cov.dtype)])
    sharding = NamedSharding(mesh, P("data"))
    return (
        jax.device_put(jnp.asarray(keys), sharding),
        jax.device_put(jnp.asarray(cov), sharding),
        m,
    )


def make_count_batch_hash_sharded(mesh: Mesh, k: int):
    """Returns a jitted step: (cov_sh, keys_sh, codes[B, L]) -> cov_sh.

    The table is sharded by (sorted) hash range; the read batch is sharded
    along the batch axis, sketched locally, then all-gathered so every device
    probes the full batch against its local key range.  Coverage shards are
    updated locally -- no collective on the write path.
    """

    def shard_fn(cov_l, keys_l, codes):
        values, emit = sketch_codes(codes, k)
        # positions 0..k-2 never emit; dropping them also shrinks the
        # all-gather payload by (k-1)/L
        values, emit = values[..., k - 1 :], emit[..., k - 1 :]
        q = jax.lax.all_gather(values.reshape(-1), "data", tiled=True)
        msk = jax.lax.all_gather(emit.reshape(-1), "data", tiled=True)
        return count_merge(cov_l, keys_l, q, msk)

    mapped = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("data"), P("data"), P("data", None)),
        out_specs=P("data"),
    )
    return jax.jit(mapped, donate_argnums=(0,))


def count_batch_hash_sharded(mesh: Mesh, k: int, cov_sh, keys_sh, codes):
    return make_count_batch_hash_sharded(mesh, k)(cov_sh, keys_sh, codes)


def make_count_super_hash_sharded(mesh: Mesh, k: int):
    """Large-table mesh counting: hash-range-sharded table x superbatch
    queries -- the production big-table formulation (count_merge_super)
    distributed over devices.

    Returns a jitted step: (cov_sh, keys_sh, packed_f [F, B, L/4+2]) ->
    cov_sh.  The stacked super-group is sharded over its F axis (each device
    sketches F/D sub-batches), sketched values all-gather so every device
    joins the FULL super-group's queries against its local key range, and
    coverage shards update locally -- no collective on the write path.  The
    per-device join cost is (M/D + G*nq) sort elements: the table term that
    motivates the superbatch regime scales DOWN with mesh size, unlike the
    replicated per-batch path.  F must be divisible by the mesh size
    (_pick_super_rows emits multiples of 8).
    """
    from ..ops.kmer import sketch_packed
    from ..ops.table import _SENTINEL, count_merge_super

    def shard_fn(cov_l, keys_l, packed_f):
        def body(_, packed):
            values, emit = sketch_packed(packed, k)
            values, emit = values[..., k - 1 :], emit[..., k - 1 :]
            return None, jnp.where(emit, values, _SENTINEL).reshape(-1)

        _, vals = jax.lax.scan(body, None, packed_f)
        q = jax.lax.all_gather(vals.reshape(-1), "data", tiled=True)
        return count_merge_super(cov_l, keys_l, q)

    mapped = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("data"), P("data"), P("data", None, None)),
        out_specs=P("data"),
    )
    return jax.jit(mapped, donate_argnums=(0,))


# ----------------------------------------------------------------------
# position-range-sharded counting Bloom filter
# ----------------------------------------------------------------------
# A human-scale genome CBF (n = 3e9, p = 0.01 -> ~9.6 cells/elem) is ~29 GB
# of uint8 counters.  Shard the counter array
# by position range: every device computes all hash positions (replicated
# VPU work, no communication), scatters only the positions in its own range
# (write path has NO collective), and `count` takes a pmin across devices
# (each device contributes its local counters, 255 elsewhere).

def make_cbf_add_sharded(mesh: Mesh, m: int, num_hashes: int):
    """Returns a jitted step: (filt_shard, hashes, mask, seeds) -> filt_shard.

    ``m`` must be divisible by the mesh size (CBF sizes are powers of two).
    """
    from ..ops.cbf import (
        _DENSE_ADD_MAX,
        _positions,
        _saturating_update_chunked,
    )

    n_dev = mesh.devices.size
    assert m % n_dev == 0, (m, n_dev)
    m_l = m // n_dev

    def shard_fn(filt_l, hashes, mask, seeds):
        pos = _positions(hashes, seeds, m)          # [kh, N] global
        lo = jax.lax.axis_index("data").astype(jnp.uint64) * jnp.uint64(m_l)
        rel = pos - lo
        inrange = (rel < jnp.uint64(m_l)) & mask[None, :]  # unsigned wrap
        local = jnp.where(inrange, rel, jnp.uint64(m_l))
        if m_l <= _DENSE_ADD_MAX:
            inc = inrange.astype(jnp.uint32)
            hist = jnp.zeros((m_l,), jnp.uint32).at[local.reshape(-1)].add(
                inc.reshape(-1), mode="drop"
            )
            return jnp.minimum(filt_l.astype(jnp.uint32) + hist, 255).astype(
                jnp.uint8
            )
        # huge shards: position-range-chunked histogram (bounded transient)
        return _saturating_update_chunked(
            filt_l, local.reshape(-1), inrange.astype(jnp.uint32).reshape(-1),
            m_l,
        )

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P("data"), P(), P(), P()), out_specs=P("data"),
    )
    return jax.jit(mapped, donate_argnums=(0,))


def make_cbf_count_sharded(mesh: Mesh, m: int, num_hashes: int):
    """Returns a jitted fn: (filt_shard, hashes, seeds) -> min counts [N]."""
    from ..ops.cbf import _ADD_CHUNK, _positions

    n_dev = mesh.devices.size
    assert m % n_dev == 0, (m, n_dev)
    m_l = m // n_dev
    if m_l > (1 << 31):
        # int32 local indices would overflow (positions >= 2^31 clamp to 0
        # and corrupt counts); gather row-wise on a [rows, chunk] view so
        # each per-dimension index stays within 32 bits, matching the add
        # path's huge-shard branch.
        assert m_l % _ADD_CHUNK == 0, (m_l, _ADD_CHUNK)

    def shard_fn(filt_l, hashes, seeds):
        pos = _positions(hashes, seeds, m)
        lo = jax.lax.axis_index("data").astype(jnp.uint64) * jnp.uint64(m_l)
        rel = pos - lo
        inrange = rel < jnp.uint64(m_l)
        safe = jnp.where(inrange, rel, jnp.uint64(0))
        if m_l <= (1 << 31):
            got = filt_l[safe.astype(jnp.int32)]
        else:
            rows = m_l // _ADD_CHUNK
            f2 = filt_l.reshape(rows, _ADD_CHUNK)
            r = (safe >> jnp.uint64(_ADD_CHUNK.bit_length() - 1)).astype(jnp.int32)
            c = (safe & jnp.uint64(_ADD_CHUNK - 1)).astype(jnp.int32)
            got = f2[r, c]
        vals = jnp.where(inrange, got, jnp.uint8(255))
        vals = jax.lax.pmin(vals, "data")            # [kh, N] replicated
        return jnp.min(vals, axis=0)

    mapped = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P("data"), P(), P()), out_specs=P(),
    )
    return jax.jit(mapped)


def make_cbf_nonzero_sharded(mesh: Mesh, m: int):
    """Returns a jitted fn: (filt_shard,) -> total nonzero counters (u64).

    Reduces each shard one position-range chunk at a time so no full-shard
    int/float intermediate materializes (a plain f32 mean over the global
    filter is 4x the u8 size and OOMs exactly at the genome scales the
    sharded CBF exists for)."""
    from ..ops.cbf import _ADD_CHUNK

    n_dev = mesh.devices.size
    assert m % n_dev == 0, (m, n_dev)
    m_l = m // n_dev

    def shard_fn(filt_l):
        total = jnp.zeros((), jnp.uint64)
        for c0 in range(0, m_l, _ADD_CHUNK):
            w = min(_ADD_CHUNK, m_l - c0)
            chunk = jax.lax.dynamic_slice(filt_l, (c0,), (w,))
            total = total + jnp.sum(chunk > 0, dtype=jnp.uint32).astype(jnp.uint64)
        return jax.lax.psum(total, "data")

    mapped = jax.shard_map(shard_fn, mesh=mesh, in_specs=(P("data"),),
                           out_specs=P())
    return jax.jit(mapped)


# ----------------------------------------------------------------------
# distributed coverage histogram (the 256-bin psum of SURVEY.md section 5.8)
# ----------------------------------------------------------------------

def make_hom_histogram(mesh: Mesh):
    """(cov_u8 shard, hom_mask shard) -> replicated 256-bin histogram."""

    def shard_fn(cov_l, mask_l):
        hist = jnp.zeros((256,), jnp.uint32).at[
            jnp.where(mask_l, cov_l.astype(jnp.int32), 256 - 1)
        ].add(mask_l.astype(jnp.uint32), mode="drop")
        return jax.lax.psum(hist, "data")

    mapped = jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(P("data"), P("data")), out_specs=P()
    )
    return jax.jit(mapped)


def hom_histogram_sharded(mesh: Mesh, cov_u8, hom_mask):
    return make_hom_histogram(mesh)(cov_u8, hom_mask)
