"""Device canonical k-mer sketch as a parallel associative scan.

Parallel reformulation of the sequential rolling sketch in reference
src/kmer.cpp:20-52.  Instead of a per-base serial loop (or the CUDA
one-thread-per-position rescan, reference src/kmer.cu:39-69), the two rolling
registers are computed for *every* position at once with a
``jax.lax.associative_scan``:

  forward register recurrence   x -> ((x << 2) | c) & mask      (kmer.cpp:37)
  reverse register recurrence   x -> (x >> 2) | (3^c) << 2(k-1) (kmer.cpp:38)

Both recurrences belong to shift-or families closed under composition:

  fwd:  x -> ((x << 2m) | v) & mask ;  (m1,v1)*(m2,v2) = (m1+m2, (v1<<2m2 | v2) & mask)
  rev:  x -> ( x >> 2m) | v         ;  (m1,v1)*(m2,v2) = (m1+m2, (v1>>2m2) | v2)

with m = number of non-ambiguous bases in the segment (capped at k, since
longer shifts vanish under the mask).  Ambiguous bases are the identity
element (m=0, v=0), which exactly reproduces the reference's behavior of NOT
resetting the registers at N (src/kmer.cpp:48 only resets the run counter),
including the stale-register palindrome checks during warmup.

The emission-eligibility counter l (reset at N, not incremented at palindromic
windows) is a segmented count, also an associative scan.

Work is O(L log L) on the VPU, fully parallel over both positions and a batch
dimension of reads.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .sketch_ref import SEQ_NT4_TABLE, encode_bases_np

# encoded value layout: hash64(kmer) << 8 | span (reference src/kmer.cpp:43)
KMER_SPAN_BITS = 8

_U64 = jnp.uint64


def encode_bases(seq: str | bytes) -> np.ndarray:
    """Host helper: DNA string -> uint8 codes (0..3, 4 = ambiguous)."""
    return encode_bases_np(seq)


def pack_seqs(seqs: list[bytes | str], max_len: int | None = None) -> np.ndarray:
    """Pack variable-length sequences into a [B, L] uint8 code matrix.

    Padding uses code 4 (ambiguous), which never emits and resets the run
    counter, so rows are fully independent.
    """
    if max_len is None:
        max_len = max((len(s) for s in seqs), default=1)
    out = np.full((len(seqs), max_len), 4, dtype=np.uint8)
    for i, s in enumerate(seqs):
        codes = encode_bases_np(s)[:max_len]
        out[i, : len(codes)] = codes
    return out


def hash64(key: jnp.ndarray, mask) -> jnp.ndarray:
    """Invertible integer finalizer (reference include/hash64.hpp:5-14)."""
    key = (~key + (key << _U64(21))) & mask
    key = key ^ (key >> _U64(24))
    key = ((key + (key << _U64(3))) + (key << _U64(8))) & mask
    key = key ^ (key >> _U64(14))
    key = ((key + (key << _U64(2))) + (key << _U64(4))) & mask
    key = key ^ (key >> _U64(28))
    key = (key + (key << _U64(31))) & mask
    return key


@functools.partial(jax.jit, static_argnames=("k",))
def sketch_codes(codes: jnp.ndarray, k: int):
    """Canonical k-mer sketch over base-code arrays.

    Args:
      codes: uint8/int array [..., L] with values 0..3 (bases) or >=4
        (ambiguous / padding).  The scan runs along the last axis; leading
        axes are independent sequences.
      k: k-mer size, 1..28 (56-bit packing).

    Returns:
      (values, emit): values uint64 [..., L] with hash64(canonical)<<8|k at
      every position (meaningful only where emit), emit bool [..., L] true at
      positions that the reference's rolling scan would emit.
    """
    assert 0 < k <= 28
    mask = _U64((1 << (2 * k)) - 1)
    shift1 = _U64(2 * (k - 1))
    kcap = jnp.int32(k)

    codes = codes.astype(jnp.int32)
    non_n = codes < 4
    c = jnp.where(non_n, codes, 0).astype(_U64)

    # scan elements: (m, vf, vr)
    m0 = jnp.where(non_n, jnp.int32(1), jnp.int32(0))
    vf0 = jnp.where(non_n, c, _U64(0))
    vr0 = jnp.where(non_n, (_U64(3) ^ c) << shift1, _U64(0))

    def combine(a, b):
        m1, vf1, vr1 = a
        m2, vf2, vr2 = b
        sh = (2 * m2).astype(_U64)
        m = jnp.minimum(m1 + m2, kcap)
        vf = ((vf1 << sh) | vf2) & mask
        vr = (vr1 >> sh) | vr2
        return m, vf, vr

    _, vf, vr = jax.lax.associative_scan(combine, (m0, vf0, vr0), axis=-1)

    pal = (vf == vr) & non_n

    # l counter: reset at ambiguous bases, +1 at non-palindromic steps
    # (reference src/kmer.cpp:39,41,48). Segmented sum scan.
    resets = ~non_n
    inc = jnp.where(non_n & ~pal, jnp.int32(1), jnp.int32(0))

    def combine_l(a, b):
        f1, s1 = a
        f2, s2 = b
        return f1 | f2, jnp.where(f2, s2, s1 + s2)

    _, l = jax.lax.associative_scan(combine_l, (resets, inc), axis=-1)

    emit = non_n & ~pal & (l >= kcap)

    canonical = jnp.minimum(vf, vr)
    values = (hash64(canonical, mask) << _U64(KMER_SPAN_BITS)) | _U64(k)
    values = jnp.where(emit, values, _U64(0))
    return values, emit


PACKED_LEN_BYTES = 2  # u16-LE row length appended to each packed row


def unpack_2bit(packed: jnp.ndarray) -> jnp.ndarray:
    """Decode the wire format of the packed read feed.

    packed: uint8 [B, L//4 + 2] -- each row is L//4 bytes of 2-bit base
    codes (base i in bits (2i mod 8) of byte i//4) followed by a u16-LE
    valid-length.  Returns codes uint8 [B, L] with 0..3 for the first
    ``length`` bases and 4 (never-emit padding) beyond.

    2-bit packing makes the host-to-device payload 4x smaller than one code
    per byte; the unpack here is a shift/mask that fuses into the sketch
    scan.  ROADMAP S7 keeps it only if the transfer shows in the profile.
    """
    body = packed[:, :-PACKED_LEN_BYTES]
    ltail = packed[:, -PACKED_LEN_BYTES:].astype(jnp.int32)
    lengths = ltail[:, 0] | (ltail[:, 1] << 8)              # [B]
    shifts = jnp.arange(4, dtype=jnp.uint8) * jnp.uint8(2)  # [4]
    c = (body[:, :, None] >> shifts[None, None, :]) & jnp.uint8(3)
    c = c.reshape(body.shape[0], -1)                        # [B, L]
    valid = jnp.arange(c.shape[1], dtype=jnp.int32)[None, :] < lengths[:, None]
    return jnp.where(valid, c, jnp.uint8(4))


def sketch_packed(packed: jnp.ndarray, k: int):
    """sketch_codes over the packed wire format (see unpack_2bit)."""
    return sketch_codes(unpack_2bit(packed), k)


def pack_codes_np(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Host-side packer: [B, L] codes 0..4 + [B] valid lengths ->
    [B, L//4 + 2] wire rows.  Codes beyond ``lengths`` are ignored; rows
    must be prefix-valid (no interior >=4 codes within ``lengths``)."""
    B, L = codes.shape
    assert L % 4 == 0, L
    c = np.where(codes > 3, 0, codes).astype(np.uint8).reshape(B, L // 4, 4)
    body = (c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4)
            | (c[:, :, 3] << 6)).astype(np.uint8)
    out = np.empty((B, L // 4 + PACKED_LEN_BYTES), np.uint8)
    out[:, : L // 4] = body
    lengths = lengths.astype(np.uint32)
    out[:, L // 4] = (lengths & 0xFF).astype(np.uint8)
    out[:, L // 4 + 1] = ((lengths >> 8) & 0xFF).astype(np.uint8)
    return out


def sketch_seq(seq: str | bytes, k: int) -> np.ndarray:
    """Convenience host wrapper: string -> emitted encoded k-mers (1-D u64)."""
    codes = encode_bases_np(seq)
    if codes.size == 0:
        return np.empty(0, dtype=np.uint64)
    values, emit = sketch_codes(jnp.asarray(codes), k)
    values = np.asarray(values)
    emit = np.asarray(emit)
    return values[emit]
