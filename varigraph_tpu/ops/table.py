"""Dense device-resident k-mer table.

Replaces the reference's central ``unordered_map<uint64_t, kmerCovFreBitVec>``
(include/construct_index.hpp:140) with structure-of-arrays device state:

  keys     uint64 [M]      sorted k-mer encodings (hash64<<8|span)
  cov      uint32 [M]      read coverage 'c'; exposed saturated at 255
                           (reference src/fastq_kmer.cpp:135)
  freq     uint8  [M]      graph frequency 'f', saturating
                           (reference src/construct_index.cpp:663)
  hapbits  uint32 [M, W]   one bit per haplotype, W = ceil(nhap/32)
  refflag  bool   [M]      the reference's bit 7 of the last bitmap byte:
                           "k-mer also occurs in the reference genome but not
                           in this node's REF path"
                           (src/construct_index.cpp:1211-1215)

Lookup is a vectorized unrolled binary search; read coverage is counted
with a sort-merge join (count_merge) and exposed saturated at 255,
equivalent to the reference's per-read saturating increments.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, replace

import jax
import jax.numpy as jnp
import numpy as np

_U64 = jnp.uint64


def binary_search(keys: jnp.ndarray, queries: jnp.ndarray) -> jnp.ndarray:
    """Vectorized lower-bound binary search, unrolled to ceil(log2(M)) gather
    steps.  Used by KmerTable.lookup (host-side queries, not the counting
    path).
    """
    m = keys.shape[0]
    steps = max(1, math.ceil(math.log2(max(m, 2))))
    lo = jnp.zeros(queries.shape, jnp.int32)
    hi = jnp.full(queries.shape, m, jnp.int32)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        km = keys[mid]
        go_right = km < queries
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
    return lo


# numpy scalar, NOT jnp: a module-level jnp constant would instantiate the
# XLA backend at import time, which breaks jax.distributed.initialize()
# (must run before any backend init) for multi-host CLI runs
_SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


def count_merge(cov: jnp.ndarray, keys: jnp.ndarray, queries: jnp.ndarray,
                mask: jnp.ndarray) -> jnp.ndarray:
    """Add 1 to cov[i] for every (masked-in) query equal to keys[i].

    Sort-merge join with no gather or scatter: both the join and the
    result placement are formulated as sorts (the sort + reduce-by-key shape
    of the reference's CUDA counter).  ROADMAP S1 measures a probe with
    scatter-add against it:

      1. sort [keys ++ queries] together (the key/query tag rides bit 7 of
         the span byte, so keys tie-break first in a single-operand u64
         sort); mark matched queries with cumsum/cummax scans.
      2. compact the per-key matched-prefix counts back into table order
         with a SECOND u64 sort of (run_idx<<32 | cumsum(matched)): the M
         key slots sort to the front in table order, and adjacent
         differences of their payloads are exactly the per-key counts.
         cov update is then a plain elementwise add.

    Assumes keys are unique (the global k-mer table is) except for optional
    duplicated padding keys that no query equals (they get count 0).
    Encoded k-mer values never equal the sentinel (the low span byte is
    1..28), so masked-out queries map to the sentinel and sort to the end
    without matching.
    """
    m = keys.shape[0]
    if m == 0:
        return cov
    q = jnp.where(mask, queries, _SENTINEL)
    tag_bit = _U64(0x80)
    vals = jnp.concatenate([keys, q | tag_bit])
    vals_s = jax.lax.sort(vals)
    is_key = (vals_s & tag_bit) == 0
    vals_s = vals_s & ~tag_bit
    # equal-value run structure: a run contains at most one (unique) key and
    # it sits at the run start.
    first = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), vals_s[1:] != vals_s[:-1]]
    )
    key_at_start = first & is_key
    seg_id = jnp.cumsum(first.astype(jnp.int32))
    latest_key_run = jax.lax.cummax(
        jnp.where(key_at_start, seg_id, 0)
    )
    matched = (~is_key) & (latest_key_run == seg_id)
    run_idx = jnp.cumsum(is_key.astype(jnp.int32)) - 1
    # compact cumsum(matched) at key positions into table order: key slots
    # carry (run_idx << 32 | cm) and sort to the front (non-keys get a large
    # sort key).  cm at a key position counts matches strictly before it, so
    # counts[i] = cm_at_key[i+1] - cm_at_key[i], last = total - cm_at_key[-1].
    cm = jnp.cumsum(matched.astype(jnp.int32))
    packed = (
        jnp.where(is_key, run_idx, jnp.int32(0x7FFFFFFF)).astype(_U64)
        << _U64(32)
    ) | cm.astype(_U64)
    packed_s = jax.lax.sort(packed)
    cmk = (packed_s[:m] & _U64(0xFFFFFFFF)).astype(jnp.uint32)
    total = cm[-1].astype(jnp.uint32)
    nxt = jnp.concatenate([cmk[1:], total[None]])
    return cov + (nxt - cmk)


def count_merge_super(cov: jnp.ndarray, keys: jnp.ndarray,
                      values: jnp.ndarray) -> jnp.ndarray:
    """count_merge for the LARGE-TABLE regime: values are pre-sentinelized
    (masked-out slots == _SENTINEL), typically a whole super-batch of
    sketched query batches flattened together.

    Why a separate entry point: the per-batch join concatenates all M keys
    into every batch's sort, so its cost grows with the table.  Accumulating
    G batches of queries on device and joining once amortizes the table
    term to M/G sort elements per batch:

        per-batch cost ~ 2 sorts of (M/G + N) elements

    Reference counterpart: the O(1) hash-map probe per k-mer
    (src/fastq_kmer.cpp:126-141) whose table-size independence this regime
    recovers, amortized.
    """
    return count_merge(cov, keys, values, values != _SENTINEL)


def count_merge_chunked(cov: jnp.ndarray, keys: jnp.ndarray,
                        queries: jnp.ndarray, mask: jnp.ndarray,
                        chunks: int) -> jnp.ndarray:
    """count_merge split into ``chunks`` independent row-sorts.

    Each chunk carries its own copy of the table keys, so chunks join
    independently and one batched ``lax.sort`` call sorts all rows: R sorts
    of (M + Q/R) elements at the cost of (R-1)*M duplicated key slots.
    Results are placed with a scatter-add.  Used by tests only (ROADMAP D2).
    """
    m = keys.shape[0]
    q = jnp.where(mask, queries, _SENTINEL).reshape(chunks, -1)
    tag_bit = _U64(0x80)
    vals = jnp.concatenate(
        [jnp.broadcast_to(keys, (chunks, m)), q | tag_bit], axis=1
    )
    vals_s = jax.lax.sort(vals, dimension=1)
    is_key = (vals_s & tag_bit) == 0
    vals_s = vals_s & ~tag_bit
    first = jnp.concatenate(
        [jnp.ones((chunks, 1), jnp.bool_), vals_s[:, 1:] != vals_s[:, :-1]],
        axis=1,
    )
    key_at_start = first & is_key
    seg_id = jnp.cumsum(first.astype(jnp.int32), axis=1)
    latest_key_run = jax.lax.cummax(jnp.where(key_at_start, seg_id, 0), axis=1)
    matched = (~is_key) & (latest_key_run == seg_id)
    run_idx = jnp.cumsum(is_key.astype(jnp.int32), axis=1) - 1
    idx = jnp.where(matched, run_idx, m)
    return cov.at[idx.reshape(-1)].add(
        matched.reshape(-1).astype(jnp.uint32), mode="drop"
    )


@functools.partial(jax.jit, donate_argnums=(0,))
def _add_counts(cov: jnp.ndarray, keys: jnp.ndarray, queries: jnp.ndarray,
                mask: jnp.ndarray) -> jnp.ndarray:
    return count_merge(cov, keys, queries, mask)


@jax.jit
def _lookup(keys: jnp.ndarray, queries: jnp.ndarray):
    idx = binary_search(keys, queries)
    idx = jnp.minimum(idx, keys.shape[0] - 1)
    found = keys[idx] == queries
    return jnp.where(found, idx, -1), found


import sys as _sys

_LITTLE = _sys.byteorder == "little"


def pack_hapbits(bitrows: np.ndarray) -> np.ndarray:
    """[M, H] 0/1 matrix -> [M, W] uint32 words (hap i -> word i>>5, bit i&31)."""
    m, h = bitrows.shape
    w = (h + 31) // 32
    if _LITTLE:
        # np.packbits(bitorder="little") puts column 8j+b into bit b of byte
        # j; a little-endian u32 view then maps column 32w+i to bit i of
        # word w -- exactly the layout above, at memcpy-ish speed.
        if h == w * 32 and bitrows.dtype == np.uint8 and bitrows.flags.c_contiguous:
            src = bitrows
        else:
            src = np.zeros((m, w * 32), dtype=np.uint8)
            src[:, :h] = bitrows
        return np.packbits(src, axis=1, bitorder="little").view(np.uint32)
    padded = np.zeros((m, w * 32), dtype=np.uint32)
    padded[:, :h] = bitrows.astype(np.uint32)
    words = padded.reshape(m, w, 32)
    shifts = np.arange(32, dtype=np.uint32)
    return (words << shifts).sum(axis=2, dtype=np.uint32)


def unpack_hapbits(words: np.ndarray, nhap: int) -> np.ndarray:
    """[M, W] uint32 -> [M, nhap] uint8 0/1."""
    m, w = words.shape
    if _LITTLE:
        by = np.ascontiguousarray(words).view(np.uint8).reshape(m, w * 4)
        return np.unpackbits(by, axis=1, bitorder="little")[:, :nhap]
    shifts = np.arange(32, dtype=np.uint32)
    bits = (words[:, :, None] >> shifts) & np.uint32(1)
    return bits.reshape(m, w * 32)[:, :nhap].astype(np.uint8)


def bytes_to_words(packed_bytes: np.ndarray, nhap: int) -> np.ndarray:
    """[M, nbytes] packed-bit uint8 rows (hap i -> byte i>>3, bit i&7, the
    reference's BitVec layout) -> [M, W] uint32 words (hap i -> word i>>5,
    bit i&31).  Pure byte-level reshape on little-endian hosts."""
    m, nb = packed_bytes.shape
    w = (nhap + 31) // 32
    out_b = np.zeros((m, w * 4), np.uint8)
    out_b[:, : min(nb, w * 4)] = packed_bytes[:, : w * 4]
    if _LITTLE:
        return out_b.view(np.uint32)
    words = out_b.reshape(m, w, 4).astype(np.uint32)
    return (
        words[:, :, 0] | (words[:, :, 1] << 8) | (words[:, :, 2] << 16)
        | (words[:, :, 3] << 24)
    )


@dataclass
class KmerTable:
    # keys/cov are device arrays (the counting join consumes them); freq /
    # hapbits / refflag may be host numpy OR device arrays -- production
    # builders keep them host-side since only the *_np views are ever read
    keys: jnp.ndarray      # uint64 [M] sorted
    cov: jnp.ndarray       # uint32 [M]
    freq: jnp.ndarray      # uint8  [M]
    hapbits: jnp.ndarray   # uint32 [M, W]
    refflag: jnp.ndarray   # bool   [M]
    nhap: int

    # ----------------------------------------------------------- construction
    @staticmethod
    def build(keys: np.ndarray, freq: np.ndarray, hapbit_rows: np.ndarray,
              refflag: np.ndarray, nhap: int) -> "KmerTable":
        """Build from unsorted host arrays; hapbit_rows is [M, nhap] 0/1.

        Materializes the unpacked matrix -- fine for tests/small inputs; the
        construct pipeline uses build_packed (no [M, H] intermediate)."""
        order = np.argsort(keys, kind="stable")
        keys = np.ascontiguousarray(keys[order])
        return KmerTable(
            keys=jnp.asarray(keys.astype(np.uint64)),
            cov=jnp.zeros((len(keys),), jnp.uint32),
            freq=jnp.asarray(freq[order].astype(np.uint8)),
            hapbits=jnp.asarray(pack_hapbits(hapbit_rows[order])),
            refflag=jnp.asarray(refflag[order].astype(np.bool_)),
            nhap=nhap,
        )

    @staticmethod
    def build_packed(keys: np.ndarray, freq: np.ndarray,
                     hapbit_bytes: np.ndarray, refflag: np.ndarray,
                     nhap: int) -> "KmerTable":
        """Build from host arrays with bit-packed haplotype rows
        ([M, ceil(nhap/8)] uint8, hap i -> byte i>>3 bit i&7).  Never
        materializes the [M, nhap] matrix -- the scale-safe path (at
        M = 10^8, H = 200 the unpacked matrix is 20 GB).  Already-sorted
        keys (index_graph emits them hash-major) skip the argsort."""
        keys = np.asarray(keys, np.uint64)
        if len(keys) > 1 and not np.all(keys[1:] > keys[:-1]):
            order = np.argsort(keys, kind="stable")
            keys = np.ascontiguousarray(keys[order])
            freq, hapbit_bytes, refflag = (
                freq[order], hapbit_bytes[order], refflag[order]
            )
        words = bytes_to_words(hapbit_bytes, nhap)
        freq = freq.astype(np.uint8)
        refflag = refflag.astype(np.bool_)
        # freq/hapbits/refflag stay host numpy: no device compute reads them
        # (all consumers use the *_np views), and the [M, W] bit matrix is
        # ~2.4 GB at the 87M-key human-scale table
        t = KmerTable(
            keys=jnp.asarray(keys),
            cov=jnp.zeros((len(keys),), jnp.uint32),
            freq=freq,
            hapbits=words,
            refflag=refflag,
            nhap=nhap,
        )
        # seed the memoized host views from the source arrays, so no host
        # consumer fetches the key array back from the device (ROADMAP D5)
        t._keys_np = keys
        t._freq_np = freq
        t._words_np = words
        t._refflag_np = refflag
        return t

    @property
    def size(self) -> int:
        return int(self.keys.shape[0])

    # ------------------------------------------------------------------- ops
    def lookup(self, queries) -> tuple[np.ndarray, np.ndarray]:
        """Return (index or -1, found) for each query (host arrays)."""
        q = jnp.asarray(queries, dtype=jnp.uint64)
        idx, found = _lookup(self.keys, q)
        return np.asarray(idx), np.asarray(found)

    def add_counts(self, queries, mask=None) -> None:
        """Increment coverage for present queries (saturating view at 255)."""
        q = jnp.asarray(queries, dtype=jnp.uint64)
        if mask is None:
            mask = jnp.ones(q.shape, jnp.bool_)
        else:
            mask = jnp.asarray(mask, jnp.bool_)
        self.cov = _add_counts(self.cov, self.keys, q, mask)

    def cov_u8(self) -> np.ndarray:
        """Coverage saturated to uint8, the reference's 'c'."""
        return np.asarray(jnp.minimum(self.cov, 255).astype(jnp.uint8))

    def reset_cov(self) -> None:
        """Zero coverage between samples (reference ConstructIndex::reset,
        include/construct_index.hpp:317-331)."""
        self.cov = jnp.zeros_like(self.cov)

    # ------------------------------------------------------------ host views
    # keys/freq/hapbits/refflag are immutable after build, so their host
    # views are fetched at most once (ROADMAP D5)
    def keys_np(self) -> np.ndarray:
        if not hasattr(self, "_keys_np"):
            self._keys_np = np.asarray(self.keys)
        return self._keys_np

    def freq_np(self) -> np.ndarray:
        if not hasattr(self, "_freq_np"):
            self._freq_np = np.asarray(self.freq)
        return self._freq_np

    def hap_words_np(self) -> np.ndarray:
        """Packed [M, W] uint32 haplotype bits on host (production view;
        32x smaller than the unpacked matrix)."""
        if not hasattr(self, "_words_np"):
            self._words_np = np.asarray(self.hapbits)
        return self._words_np

    def hapbit_rows_np(self) -> np.ndarray:
        """Unpacked [M, nhap] matrix -- oracle/tests only; at genome scale
        this is tens of GB (use hap_words_np + ops.table.unpack_hapbits on
        gathered subsets instead)."""
        if not hasattr(self, "_rows_np"):
            self._rows_np = unpack_hapbits(self.hap_words_np(), self.nhap)
        return self._rows_np

    def refflag_np(self) -> np.ndarray:
        if not hasattr(self, "_refflag_np"):
            self._refflag_np = np.asarray(self.refflag)
        return self._refflag_np
