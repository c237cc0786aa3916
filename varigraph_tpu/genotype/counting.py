"""Read k-mer counting against the graph table, batched on device.

Replaces the reference's thread-pooled per-read hash-map probing
(src/fastq_kmer.cpp:65-187, kmer_sketch_fastq at src/kmer.cpp:110-149) with:
  FASTQ stream -> packed [B, L] base-code batches -> device sketch scan ->
  sort-merge join against the sorted table (ops/table.count_merge) ->
  coverage add.

Read batches travel in the 2-bit packed wire format ([B, L/4+2] rows: 4
bases/byte + u16 valid length, ops/kmer.unpack_2bit).  ``_FUSE`` host batches
stack into one [F, B, L/4+2] upload, and one jitted ``lax.scan`` dispatch
joins all F sub-batches.  Tables above _SMALL_TABLE_MAX_KEYS keys take the
superbatch regime instead (_count_packed_super).

Both regimes upload a phase of staged groups, dispatch the phase back to
back, then wait for the device once (see _STAGE_GROUPS).  ROADMAP D1 measures
this staging against plain async dispatch and replaces it.
"""

from __future__ import annotations

import collections
import functools
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np

from ..io.fastq import stream_packed_batches_multi
from ..ops.kmer import sketch_packed
from ..ops.table import _SENTINEL, KmerTable, count_merge, count_merge_super
from ..utils.log import log


def _count_batch_inner(cov: jnp.ndarray, keys: jnp.ndarray,
                       packed: jnp.ndarray, k: int):
    values, emit = sketch_packed(packed, k)
    # positions 0..k-2 of every row can never emit (the rolling window is
    # incomplete); dropping them statically cuts the join's query slots by
    # (k-1)/L (~16% at k=27, L=160)
    values, emit = values[..., k - 1 :], emit[..., k - 1 :]
    return count_merge(cov, keys, values.reshape(-1), emit.reshape(-1))


@functools.partial(jax.jit, static_argnames=("k",), donate_argnums=(0,))
def _count_fused(cov: jnp.ndarray, keys: jnp.ndarray, packed_f: jnp.ndarray,
                 k: int):
    """Join F stacked packed batches ([F, B, L/4+2]) in one lax.scan dispatch."""

    def body(c, packed):
        return _count_batch_inner(c, keys, packed, k), None

    cov, _ = jax.lax.scan(body, cov, packed_f)
    return cov


_FUSE = 4            # host batches stacked per H2D upload / device dispatch
_UPLOAD_DEPTH = 3    # device_put workers preparing a phase's uploads

# ---- large-table regime -------------------------------------------------
# The per-batch join sorts all M table keys with every batch's queries, so
# its cost grows with M.  Above this many keys the superbatch path instead
# sketches _pick_super_rows() batches per dispatch and joins them against
# the table once (ops/table.count_merge_super), amortizing the table term to
# M/G per batch.  ROADMAP D3 folds the two regimes into one.
_SMALL_TABLE_MAX_KEYS = int(os.environ.get("VARIGRAPH_SMALL_TABLE_MAX_KEYS",
                                           str(2 << 20)))
_SUPER_ROWS_MIN = 24
_SUPER_ROWS_MAX = 96   # at most ~210M query slots per super-group dispatch
# live-set factor of the superbatch join per (M + G*nq) sort element:
# vals + vals_s u64 (16 B) + i32/bool scan intermediates (~12 B) + the
# second sort's packed/packed_s u64 (16 B, overlapping lifetimes)
_JOIN_BYTES_PER_ELEM = 36
# share of the device's memory limit the join may plan for; the table,
# coverage and staged uploads live in the rest
_JOIN_MEM_FRACTION = 0.5
# the join budget where the backend reports no memory limit (the CPU
# backend, as in the tests)
_JOIN_BUDGET_CPU = 11 * 10**9

# fixed override for tests / experiments; None = scale with table size
_SUPER_ROWS = (int(os.environ["VARIGRAPH_SUPER_ROWS"])
               if os.environ.get("VARIGRAPH_SUPER_ROWS") else None)


def _join_budget() -> int:
    """Bytes the superbatch join may plan for: VARIGRAPH_JOIN_HBM if set,
    else _JOIN_MEM_FRACTION of the first local device's memory limit."""
    if os.environ.get("VARIGRAPH_JOIN_HBM"):
        return int(os.environ["VARIGRAPH_JOIN_HBM"])
    stats = jax.local_devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return int(limit * _JOIN_MEM_FRACTION) if limit else _JOIN_BUDGET_CPU


def _pick_super_rows(m: int, nq: int) -> int:
    """Batches per super-group dispatch, scaled with table size.

    The amortized table term per batch is M/G sort elements, so G grows with
    M until the table term is <= ~1/3 of the per-batch query term, within
    [_SUPER_ROWS_MIN, _SUPER_ROWS_MAX] and bounded by the join's memory
    budget for its peak live set."""
    if _SUPER_ROWS:
        return _SUPER_ROWS
    g = -(-3 * m // max(nq, 1))              # ceil: table term <= nq/3
    g = max(_SUPER_ROWS_MIN, min(_SUPER_ROWS_MAX, -(-g // 8) * 8))
    budget = _join_budget()
    while g > _SUPER_ROWS_MIN and _JOIN_BYTES_PER_ELEM * (m + g * nq) > budget:
        g -= 8
    return g

# Groups staged per phase: count_reads uploads this many groups (scaled by
# group size), dispatches them back to back, then waits once.  ROADMAP D1.
_STAGE_GROUPS = int(os.environ.get("VARIGRAPH_STAGE_GROUPS", "12"))


def _pace(arr) -> None:
    """Wait for ``arr`` by fetching its first element (ROADMAP D1)."""
    np.asarray(jax.device_get(arr[:1]))


def _malloc_trim() -> None:
    """Return freed glibc arenas to the OS after each staged large-table
    phase, so per-phase host buffers do not pile up in the peak RSS.  A
    no-op where there is no glibc."""
    import ctypes

    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return
    libc.malloc_trim(0)


@functools.partial(jax.jit, static_argnames=("k",), donate_argnums=(0,))
def _count_packed_super(cov: jnp.ndarray, keys: jnp.ndarray,
                        packed_f: jnp.ndarray, k: int) -> jnp.ndarray:
    """One dispatch per super-group: sketch all F stacked packed sub-batches
    (lax.scan) and join their flattened values against the table in the
    same call.  Pad sub-batches (valid length 0) sketch to all-sentinel
    rows, so tail groups need no masking."""

    def body(_, packed):
        values, emit = sketch_packed(packed, k)
        values, emit = values[..., k - 1:], emit[..., k - 1:]
        return None, jnp.where(emit, values, _SENTINEL).reshape(-1)

    _, vals = jax.lax.scan(body, None, packed_f)
    return count_merge_super(cov, keys, vals.reshape(-1))


def _fused_groups(batch_iter, fuse: int):
    """Stack ``fuse`` packed host batches into [F, B, L/4+2]; the tail group
    is padded with zero rows (valid length 0 -> no emissions) so every
    dispatch has one static shape."""
    group, gb = [], 0
    for packed, bases in batch_iter:
        group.append(packed)
        gb += bases
        if len(group) == fuse:
            yield np.stack(group), gb, fuse
            group, gb = [], 0
    if group:
        n_real = len(group)
        pad = np.zeros_like(group[0])
        while len(group) < fuse:
            group.append(pad)
        yield np.stack(group), gb, n_real


def count_reads(
    table: KmerTable,
    fastq_files: list[str],
    k: int,
    batch_size: int,
    max_len: int,
    n_devices: int = 0,
    io_threads: int = 4,
) -> int:
    """Stream all files, count k-mers into table.cov.  Returns total bases.

    n_devices: device-mesh width (config.mesh_devices); 0 = all local.
    io_threads: FASTQ files decompressed/packed concurrently (CLI -t)."""
    read_base = 0
    ngroups = 0
    nbatches = 0
    max_len = (max_len + 3) // 4 * 4  # packed wire rows need L % 4 == 0

    # multi-device: small tables shard each batch across the mesh and psum
    # the count deltas; LARGE tables hash-range-shard the table itself and
    # run the superbatch join per shard (parallel/mesh.py) -- the per-device
    # table term scales down with mesh size.  Single device uses the donated
    # fused steps.
    n_dev = jax.local_device_count()
    if n_devices:
        n_dev = min(n_devices, n_dev)
    big_table = table.size > _SMALL_TABLE_MAX_KEYS
    nq = batch_size * (max_len - k + 1)
    super_rows = _pick_super_rows(table.size, nq)
    mesh_step = None
    mesh_super = None
    sharding = None
    keys_dev = table.keys
    cov0 = table.cov
    if n_dev > 1 and batch_size % n_dev == 0:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.mesh import (
            make_count_batch_replicated_packed,
            make_count_super_hash_sharded,
            make_mesh,
            shard_table_arrays,
        )

        mesh = make_mesh(n_dev)
        if big_table:
            # super_rows must split evenly over the mesh (F-axis sharding)
            super_rows = -(-super_rows // n_dev) * n_dev
            mesh_super = make_count_super_hash_sharded(mesh, k)
            keys_dev, cov0, _m_real = shard_table_arrays(
                mesh, table.keys_np(), np.asarray(table.cov)
            )
            sharding = NamedSharding(mesh, P("data", None, None))
            log(f"counting hash-range-sharded over {n_dev} devices "
                f"({table.size / 1e6:.1f}M keys, "
                f"{table.size / n_dev / 1e6:.1f}M per device)",
                func="count_reads")
        else:
            mesh_step = make_count_batch_replicated_packed(mesh, k)
            # fused groups upload sharded over the batch axis; slicing
            # group[j] yields a [B, L] array already laid out P("data", None)
            sharding = NamedSharding(mesh, P(None, "data", None))
            log(f"counting data-parallel over {n_dev} devices",
                func="count_reads")

    for path in fastq_files:
        log(f"Collecting kmers from read on device: {path}", func="count_reads")

    # large-table regime: upload super_rows batches per group and run ONE
    # fused sketch+join dispatch per group (see _SMALL_TABLE_MAX_KEYS and
    # _count_packed_super above)
    fuse = super_rows if big_table else _FUSE
    stage_groups = max(3, min(_STAGE_GROUPS, (_STAGE_GROUPS * 24) // fuse))
    if big_table:
        log(f"large-table counting: {table.size / 1e6:.1f}M keys, "
            f"one fused sketch+join dispatch per {super_rows} batches "
            f"({super_rows * nq / 1e6:.0f}M query slots), "
            f"{stage_groups} groups staged per phase",
            func="count_reads")

    # one accumulator: phases dispatch back-to-back chained joins, so extra
    # round-robin buffers would only waste M*4 bytes of device memory each
    accs = [cov0]

    def _force(dev):
        """Wait for an upload by fetching one element (ROADMAP D1)."""
        np.asarray(jax.device_get(dev[0, 0, :1]))

    def upload(arr):
        return jax.device_put(arr, sharding) if sharding is not None \
            else jax.device_put(arr)

    pool = ThreadPoolExecutor(max_workers=_UPLOAD_DEPTH)
    timing = os.environ.get("VARIGRAPH_COUNT_TIMING")
    waits = {"upload": 0.0, "sync": 0.0, "dispatch": 0.0, "feed": 0.0}
    import time as _time

    def flush_staged(staged):
        """Dispatch every staged group back to back, then wait once."""
        nonlocal read_base, ngroups, nbatches
        t0 = _time.perf_counter()
        for dev, gb, n_real in staged:
            if big_table:
                if mesh_super is not None:
                    accs[0] = mesh_super(accs[0], keys_dev, dev)
                else:
                    accs[0] = _count_packed_super(accs[0], keys_dev, dev, k)
            elif mesh_step is not None:
                for j in range(n_real):
                    accs[0] = mesh_step(accs[0], keys_dev, dev[j])
            else:
                accs[0] = _count_fused(accs[0], keys_dev, dev, k)
            read_base += gb
            ngroups += 1
            nbatches += n_real
        waits["dispatch"] += _time.perf_counter() - t0
        t0 = _time.perf_counter()
        _pace(accs[0])
        waits["sync"] += _time.perf_counter() - t0
        staged.clear()

    try:
        # staged phases for both regimes (see _STAGE_GROUPS): upload a
        # phase of groups, dispatch it back to back, wait once; the feed
        # keeps producing into the merge-queue buffer throughout
        # (io/fastq._merge_file_streams)
        staged: list = []
        pending: collections.deque = collections.deque()
        tfeed = _time.perf_counter()
        for stacked, gb, n_real in _fused_groups(
            stream_packed_batches_multi(fastq_files, batch_size, max_len,
                                        k, max_parallel=max(io_threads, 1)),
            fuse,
        ):
            waits["feed"] += _time.perf_counter() - tfeed
            pending.append((pool.submit(upload, stacked), gb, n_real))
            if len(pending) >= stage_groups:
                t0 = _time.perf_counter()
                while pending:
                    fut, g, n = pending.popleft()
                    staged.append((fut.result(), g, n))
                # wait for the phase's uploads before dispatching it
                list(pool.map(_force, (d for d, _, _ in staged)))
                up_dt = _time.perf_counter() - t0
                waits["upload"] += up_dt
                t0 = _time.perf_counter()
                flush_staged(staged)
                if timing:
                    import resource

                    log(f"phase: upload {up_dt:.2f}s "
                        f"exec {_time.perf_counter() - t0:.2f}s "
                        f"({stage_groups} groups, rss "
                        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.1f}"
                        f" GB)", func="count_reads")
                if big_table:
                    _malloc_trim()
            tfeed = _time.perf_counter()
        t0 = _time.perf_counter()
        while pending:
            fut, g, n = pending.popleft()
            staged.append((fut.result(), g, n))
        list(pool.map(_force, (d for d, _, _ in staged)))
        waits["upload"] += _time.perf_counter() - t0
        if staged:
            flush_staged(staged)
    finally:
        pool.shutdown(wait=False)
    if timing:
        log("count timing: " + " ".join(
            f"{k_}={v:.1f}s" for k_, v in waits.items()),
            func="count_reads")

    cov = accs[0]
    if mesh_super is not None and cov.shape[0] != table.size:
        # trim the hash-shard padding back to the real table length
        cov = jnp.asarray(np.asarray(jax.device_get(cov))[: table.size])
    _pace(cov)
    table.cov = cov
    log(f"Processed {nbatches} batches, {read_base / 1e9:.2f} Gb",
        func="count_reads")
    return read_base
