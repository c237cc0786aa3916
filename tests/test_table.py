"""Tests for the dense k-mer table."""

import numpy as np

from varigraph_tpu.ops.table import KmerTable, pack_hapbits, unpack_hapbits


def _rand_table(m=200, h=37, seed=0):
    rng = np.random.default_rng(seed)
    # realistic k-mer encodings: hash<<8 | span (span byte < 32)
    keys = rng.choice(np.arange(1, 10 * m, dtype=np.uint64), size=m, replace=False)
    keys = (keys << np.uint64(8)) | np.uint64(27)
    freq = rng.integers(1, 10, size=m, dtype=np.uint8)
    bits = rng.integers(0, 2, size=(m, h), dtype=np.uint8)
    refflag = rng.integers(0, 2, size=m, dtype=bool)
    return keys, freq, bits, refflag, h


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(1)
    for h in (1, 7, 32, 33, 64, 100):
        bits = rng.integers(0, 2, size=(50, h), dtype=np.uint8)
        assert (unpack_hapbits(pack_hapbits(bits), h) == bits).all()


def test_lookup():
    keys, freq, bits, refflag, h = _rand_table()
    t = KmerTable.build(keys, freq, bits, refflag, h)
    idx, found = t.lookup(keys)
    assert found.all()
    assert (t.keys_np()[idx] == keys).all()
    # payload alignment survives the sort
    order = np.argsort(keys, kind="stable")
    assert (t.freq_np() == freq[order]).all()
    assert (t.hapbit_rows_np() == bits[order]).all()
    assert (t.refflag_np() == refflag[order]).all()

    missing = np.array([0, 10 * 200 + 5], dtype=np.uint64)
    idx2, found2 = t.lookup(missing)
    assert not found2.any()
    assert (idx2 == -1).all()


def test_add_counts_and_saturation():
    keys, freq, bits, refflag, h = _rand_table(m=50)
    t = KmerTable.build(keys, freq, bits, refflag, h)
    q = np.concatenate([keys[:10], keys[:10], np.array([(999999 << 8) | 27], np.uint64)])
    t.add_counts(q)
    cov = t.cov_u8()
    idx, _ = t.lookup(keys[:10])
    assert (cov[idx] == 2).all()
    assert cov.sum() == 20

    # saturate
    for _ in range(3):
        t.add_counts(np.repeat(keys[:1], 128))
    assert t.cov_u8()[t.lookup(keys[:1])[0][0]] == 255

    t.reset_cov()
    assert t.cov_u8().sum() == 0


def test_masked_counts():
    keys, freq, bits, refflag, h = _rand_table(m=20)
    t = KmerTable.build(keys, freq, bits, refflag, h)
    t.add_counts(keys, mask=np.arange(20) % 2 == 0)
    assert t.cov_u8().sum() == 10


def test_count_merge_chunked_matches_flat():
    import jax.numpy as jnp

    from varigraph_tpu.ops.table import count_merge, count_merge_chunked

    rng = np.random.default_rng(3)
    m = 100
    keys = np.sort(
        (rng.integers(0, 1 << 40, size=m, dtype=np.uint64) << np.uint64(8))
        | np.uint64(27)
    )
    q = (rng.integers(0, 1 << 40, size=256, dtype=np.uint64) << np.uint64(8)) | np.uint64(27)
    hit = rng.random(256) < 0.5
    q[hit] = keys[rng.integers(0, m, size=int(hit.sum()))]
    mask = rng.random(256) < 0.9

    cov_flat = count_merge(jnp.zeros(m, jnp.uint32), jnp.asarray(keys),
                           jnp.asarray(q), jnp.asarray(mask))
    for chunks in (2, 4, 8):
        cov_c = count_merge_chunked(jnp.zeros(m, jnp.uint32), jnp.asarray(keys),
                                    jnp.asarray(q), jnp.asarray(mask), chunks)
        np.testing.assert_array_equal(np.asarray(cov_c), np.asarray(cov_flat))

