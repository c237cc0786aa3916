"""FASTQ/FASTA read streaming into fixed-shape device batches.

Host-side replacement for the reference's kseq streaming + thread-pool
batching (src/fastq_kmer.cpp:65-187).  Reads are packed into [B, L] uint8
base-code matrices (padding code 4 never emits k-mers), the shape the device
sketch kernel consumes.  Reads longer than max_len are split into overlapping
segments (overlap k-1) so no k-mer is lost.
"""

from __future__ import annotations

import gzip
import os
from typing import Iterator

import numpy as np

from ..ops.sketch_ref import SEQ_NT4_TABLE


def _open_bin(path: str):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def stream_records(path: str) -> Iterator[bytes]:
    """Yield raw read sequences (bytes) from a FASTQ or FASTA file."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"'{path}': No such file or directory.")
    with _open_bin(path) as fh:
        first = fh.peek(1)[:1] if hasattr(fh, "peek") else b""
        if first == b">":  # FASTA
            seq_parts: list[bytes] = []
            for line in fh:
                line = line.rstrip(b"\n")
                if line.startswith(b">"):
                    if seq_parts:
                        yield b"".join(seq_parts)
                        seq_parts = []
                else:
                    seq_parts.append(line)
            if seq_parts:
                yield b"".join(seq_parts)
        else:  # FASTQ
            while True:
                header = fh.readline()
                if not header:
                    break
                seq = fh.readline().rstrip(b"\n")
                fh.readline()  # '+'
                fh.readline()  # quals
                yield seq


def stream_read_batches_native(
    path: str,
    batch_size: int,
    max_len: int,
    k: int,
) -> Iterator[tuple[np.ndarray, int]] | None:
    """Native (C++) batch streamer; returns None if the library is
    unavailable.  Batches come from a background thread so gz decompression
    and packing overlap device compute (double buffering)."""
    import ctypes
    import queue
    import threading

    from ..native.loader import get_fastq_lib

    lib = get_fastq_lib()
    if lib is None:
        return None

    def gen():
        h = lib.vgf_open(path.encode())
        if not h:
            raise FileNotFoundError(f"'{path}': No such file or directory.")
        q: queue.Queue = queue.Queue(maxsize=4)

        def producer():
            try:
                while True:
                    buf = np.full((batch_size, max_len), 4, dtype=np.uint8)
                    bases = ctypes.c_long(0)
                    rows = lib.vgf_next_batch(
                        h,
                        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                        batch_size, max_len, k, ctypes.byref(bases),
                    )
                    if rows == 0:
                        break
                    q.put((buf, int(bases.value)))
            finally:
                q.put(None)
                lib.vgf_close(h)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            yield item

    return gen()


def stream_read_batches(
    path: str,
    batch_size: int,
    max_len: int,
    k: int,
) -> Iterator[tuple[np.ndarray, int]]:
    """Yield ([B, max_len] uint8 code batches, base_count_in_batch).

    Uses the native C++ reader with background prefetch when available;
    falls back to pure Python.  The final batch is padded (code 4) to the
    full batch shape so the device kernel compiles once.
    """
    native = stream_read_batches_native(path, batch_size, max_len, k)
    if native is not None:
        yield from native
        return
    buf = np.full((batch_size, max_len), 4, dtype=np.uint8)
    row = 0
    bases = 0
    for seq in stream_records(path):
        bases += len(seq)
        codes = SEQ_NT4_TABLE[np.frombuffer(seq, dtype=np.uint8)]
        # split long reads into overlapping segments so no window is lost
        start = 0
        n = len(codes)
        while True:
            seg = codes[start : start + max_len]
            buf[row, : len(seg)] = seg
            row += 1
            if row == batch_size:
                yield buf, bases
                buf = np.full((batch_size, max_len), 4, dtype=np.uint8)
                row = 0
                bases = 0
            if start + max_len >= n:
                break
            start += max_len - (k - 1)
    if row > 0:
        yield buf, bases


def _packed_row_bytes(max_len: int) -> int:
    assert max_len % 4 == 0, max_len
    return max_len // 4 + 2  # + u16-LE valid-length


def stream_packed_batches_native(
    path: str, batch_size: int, max_len: int, k: int,
) -> Iterator[tuple[np.ndarray, int]] | None:
    """Native packed batch streamer ([B, max_len/4+2] wire rows, see
    ops/kmer.unpack_2bit); None if the library lacks the packed API."""
    import ctypes
    import queue
    import threading

    from ..native.loader import get_fastq_lib

    lib = get_fastq_lib()
    if lib is None or not hasattr(lib, "vgf_next_batch_packed"):
        return None
    row_bytes = _packed_row_bytes(max_len)

    def gen():
        h = lib.vgf_open(path.encode())
        if not h:
            raise FileNotFoundError(f"'{path}': No such file or directory.")
        q: queue.Queue = queue.Queue(maxsize=4)

        def producer():
            try:
                while True:
                    buf = np.zeros((batch_size, row_bytes), dtype=np.uint8)
                    bases = ctypes.c_long(0)
                    rows = lib.vgf_next_batch_packed(
                        h,
                        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                        batch_size, max_len, k, ctypes.byref(bases),
                    )
                    if rows == 0:
                        break
                    q.put((buf, int(bases.value)))
            finally:
                q.put(None)
                lib.vgf_close(h)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            yield item

    return gen()


def stream_packed_batches(
    path: str, batch_size: int, max_len: int, k: int,
) -> Iterator[tuple[np.ndarray, int]]:
    """Yield ([B, max_len/4+2] uint8 packed wire rows, base_count).

    Wire format: 2-bit base codes (4 bases/byte, little-end within the
    byte) + u16-LE valid length per row (decoded by ops/kmer.unpack_2bit).
    Reads split at non-ACGT bases (hard split -- the sketch's N-reset
    means no k-mer spans one) and at max_len (k-1 overlap); segments
    shorter than k are dropped.  max_len must be a multiple of 4.
    """
    native = stream_packed_batches_native(path, batch_size, max_len, k)
    if native is not None:
        yield from native
        return
    from ..ops.kmer import pack_codes_np

    row_bytes = _packed_row_bytes(max_len)
    codes_buf = np.full((batch_size, max_len), 4, dtype=np.uint8)
    lens_buf = np.zeros(batch_size, np.int32)
    row = 0
    bases = 0
    step = max_len - (k - 1)
    for seq in stream_records(path):
        bases += len(seq)
        codes = SEQ_NT4_TABLE[np.frombuffer(seq, dtype=np.uint8)]
        # split into maximal ACGT runs
        valid = codes < 4
        if valid.all():
            runs = [(0, len(codes))] if len(codes) else []
        else:
            d = np.diff(valid.astype(np.int8))
            starts = list(np.where(d == 1)[0] + 1)
            ends = list(np.where(d == -1)[0] + 1)
            if len(valid) and valid[0]:
                starts.insert(0, 0)
            if len(valid) and valid[-1]:
                ends.append(len(valid))
            runs = list(zip(starts, ends))
        for r0, r1 in runs:
            if r1 - r0 < k:
                continue
            start = r0
            while True:
                seg = codes[start : min(start + max_len, r1)]
                codes_buf[row, : len(seg)] = seg
                lens_buf[row] = len(seg)
                row += 1
                if row == batch_size:
                    yield pack_codes_np(codes_buf, lens_buf), bases
                    codes_buf = np.full((batch_size, max_len), 4, np.uint8)
                    lens_buf = np.zeros(batch_size, np.int32)
                    row = 0
                    bases = 0
                if start + max_len >= r1:
                    break
                start += step
    if row > 0:
        yield pack_codes_np(codes_buf, lens_buf), bases


def stream_packed_batches_multi(
    paths: list[str],
    batch_size: int,
    max_len: int,
    k: int,
    max_parallel: int = 4,
) -> Iterator[tuple[np.ndarray, int]]:
    """Packed-format counterpart of stream_read_batches_multi."""
    yield from _merge_file_streams(
        paths, max_parallel,
        lambda p: stream_packed_batches(p, batch_size, max_len, k),
    )


def stream_read_batches_multi(
    paths: list[str],
    batch_size: int,
    max_len: int,
    k: int,
    max_parallel: int = 4,
) -> Iterator[tuple[np.ndarray, int]]:
    """Merge batches from several files, each decompressed and packed on its
    own background thread (up to ``max_parallel`` concurrently).

    Per-file batch order is preserved but files interleave arbitrarily --
    coverage counting is a commutative sum, so results are independent of
    interleaving.  This parallelizes the gz decompression that bounds the
    host feed (the reference streams files strictly sequentially,
    src/fastq_kmer.cpp:41-63).
    """
    yield from _merge_file_streams(
        paths, max_parallel,
        lambda p: stream_read_batches(p, batch_size, max_len, k),
    )


def _merge_file_streams(paths, max_parallel, make_stream):
    if len(paths) == 1:
        yield from make_stream(paths[0])
        return
    import queue
    import threading

    # Deep enough to keep decompress/pack threads busy while the consumer
    # waits for the device at the end of each staged phase
    # (genotype/counting._STAGE_GROUPS); a shallow buffer makes feed and
    # device alternate instead of overlap.  64 packed [16384, L/4+2] batches
    # is ~44 MB of host RAM.
    q: queue.Queue = queue.Queue(maxsize=max(64, 2 * max_parallel))
    errors: list[BaseException] = []

    def worker(p: str):
        try:
            for item in make_stream(p):
                q.put(item)
        except BaseException as e:  # surfaced in the consumer
            errors.append(e)
        finally:
            q.put(None)

    pending = list(paths)

    def start_next():
        if pending:
            p = pending.pop(0)
            threading.Thread(target=worker, args=(p,), daemon=True).start()

    for _ in range(min(max_parallel, len(paths))):
        start_next()
    finished = 0
    while finished < len(paths):
        item = q.get()
        if item is None:
            finished += 1
            start_next()
            continue
        yield item
    if errors:
        raise errors[0]
