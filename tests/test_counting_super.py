"""Large-table (superbatch) counting path: genotype/counting's buffered
sort-merge join must produce exactly the per-batch joins' coverage.

This is the path of tables above _SMALL_TABLE_MAX_KEYS (1 Gbp genomes and
up); the tests force it at
toy scale via _SMALL_TABLE_MAX_KEYS/_SUPER_ROWS so every piece runs: stash of
fused groups, super-join on full buffers, buffer rotation, stale-row
masking, and the partial tail join.
"""

import gzip

import jax.numpy as jnp
import numpy as np
import pytest

import varigraph_tpu.genotype.counting as C
from varigraph_tpu.ops.sketch_ref import sketch_ref
from varigraph_tpu.ops.table import KmerTable, count_merge_super, _SENTINEL

K = 15
B, L = 32, 64


def test_count_merge_super_matches_flat():
    from varigraph_tpu.ops.table import count_merge

    rng = np.random.default_rng(5)
    keys = np.unique(
        (rng.integers(0, 1 << 50, size=500, dtype=np.uint64) << np.uint64(8))
        | np.uint64(27)
    )
    m = len(keys)
    q = (rng.integers(0, 1 << 50, size=8192, dtype=np.uint64) << np.uint64(8)) | np.uint64(27)
    hit = rng.random(8192) < 0.4
    q[hit] = keys[rng.integers(0, m, size=int(hit.sum()))]
    mask = rng.random(8192) < 0.9
    exp = count_merge(jnp.zeros(m, jnp.uint32), jnp.asarray(keys),
                      jnp.asarray(q), jnp.asarray(mask))
    vals = np.where(mask, q, np.uint64(_SENTINEL))
    got = count_merge_super(jnp.zeros(m, jnp.uint32), jnp.asarray(keys),
                            jnp.asarray(vals))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(exp))


def _write_fastq(path, reads):
    with gzip.open(path, "wt") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")


def _reads_and_table(nreads=150, seed=3):
    rng = np.random.default_rng(seed)
    reads = [
        "".join("ACGT"[c] for c in rng.integers(0, 4, int(rng.integers(30, 60))))
        for _ in range(nreads)
    ]
    # table keys: every k-mer of half the reads, plus decoys
    kmers = np.concatenate(
        [sketch_ref(r, K) for r in reads[: nreads // 2]] or [np.empty(0, np.uint64)]
    )
    decoys = (rng.integers(0, 1 << 50, size=64, dtype=np.uint64)
              << np.uint64(8)) | np.uint64(K)
    keys = np.unique(np.concatenate([kmers, decoys]))
    m = len(keys)
    freq = np.ones(m, np.uint8)
    bits = np.zeros((m, 1), np.uint8)
    flag = np.zeros(m, bool)
    return reads, KmerTable.build(keys, freq, bits, flag, 1)


@pytest.mark.parametrize("super_rows", [4, 8, 12])
@pytest.mark.parametrize("n_devices", [1, 0])
def test_superbatch_count_reads_matches_default(tmp_path, monkeypatch,
                                                super_rows, n_devices):
    """count_reads with the big-table path forced (tiny _SMALL_TABLE_MAX_KEYS,
    small _SUPER_ROWS) == count_reads on the default per-batch path, for a
    stream long enough to fill buffers several times plus a partial tail.

    n_devices=1 exercises the single-device superbatch path
    (_count_packed_super); n_devices=0 uses all 8 virtual CPU devices and
    exercises the hash-range-sharded mesh superbatch path
    (parallel/mesh.make_count_super_hash_sharded), asserting parity between
    the distributed and single-device formulations."""
    reads, table = _reads_and_table()
    fq = str(tmp_path / "r.fq.gz")
    _write_fastq(fq, reads)

    base = C.count_reads(table, [fq], K, B, L, n_devices=1, io_threads=1)
    want = table.cov_u8().copy()
    table.reset_cov()

    monkeypatch.setattr(C, "_SMALL_TABLE_MAX_KEYS", 0)
    monkeypatch.setattr(C, "_SUPER_ROWS", super_rows)
    got_bases = C.count_reads(table, [fq], K, B, L, n_devices=n_devices,
                              io_threads=1)
    got = table.cov_u8()

    assert got_bases == base
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0  # the table was actually hit
    assert len(got) == table.size  # shard padding trimmed


def test_superbatch_exact_multiplicities(tmp_path, monkeypatch):
    """Coverage from the superbatch path equals the spec oracle's exact
    per-key multiplicity over the whole stream."""
    reads, table = _reads_and_table(nreads=60, seed=11)
    fq = str(tmp_path / "r.fq.gz")
    _write_fastq(fq, reads)

    monkeypatch.setattr(C, "_SMALL_TABLE_MAX_KEYS", 0)
    monkeypatch.setattr(C, "_SUPER_ROWS", 8)
    C.count_reads(table, [fq], K, B, L, io_threads=1)

    all_kmers = np.concatenate([sketch_ref(r, K) for r in reads])
    keys = table.keys_np()
    idx = np.searchsorted(keys, all_kmers)
    idx[idx == len(keys)] = 0
    hits = keys[idx] == all_kmers
    exp = np.zeros(len(keys), np.uint32)
    np.add.at(exp, idx[hits], 1)
    np.testing.assert_array_equal(
        table.cov_u8(), np.minimum(exp, 255).astype(np.uint8)
    )
