"""Tests for MurmurHash3 closed form and the counting Bloom filter."""

import numpy as np
import jax.numpy as jnp

from varigraph_tpu.ops.cbf import (CountingBloomFilter, cbf_num_hashes,
                                   cbf_size, make_seeds)
from varigraph_tpu.ops.murmur3 import murmur3_x64_128_u64key


def murmur3_x64_128_py(key: int, seed: int) -> int:
    """Independent pure-Python port of the full MurmurHash3_x64_128 for an
    8-byte key, used as the oracle for the closed form."""
    M = (1 << 64) - 1

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & M

    def fmix(h):
        h ^= h >> 33
        h = (h * 0xFF51AFD7ED558CCD) & M
        h ^= h >> 33
        h = (h * 0xC4CEB9FE1A85EC53) & M
        h ^= h >> 33
        return h

    c1 = 0x87C37B91114253D5
    c2 = 0x4CF5AD432745937F
    h1 = h2 = seed & 0xFFFFFFFF
    # len=8: no body blocks, tail = 8 bytes little-endian = key
    k1 = (key * c1) & M
    k1 = rotl(k1, 31)
    k1 = (k1 * c2) & M
    h1 ^= k1
    h1 ^= 8
    h2 ^= 8
    h1 = (h1 + h2) & M
    h2 = (h2 + h1) & M
    h1 = fmix(h1)
    h2 = fmix(h2)
    h1 = (h1 + h2) & M
    h2 = (h2 + h1) & M
    return (h1 + h2) & M


def test_murmur_closed_form_matches_oracle():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 63, size=100, dtype=np.uint64)
    for seed in (0, 1, 0xDEADBEEF, (1 << 40) + 17):  # incl. >32-bit seed
        got = np.asarray(murmur3_x64_128_u64key(jnp.asarray(keys), seed))
        for ki, gi in zip(keys.tolist(), got.tolist()):
            assert gi == murmur3_x64_128_py(ki, seed)


def test_sizing_formulas():
    # n=1000, p=0.01: exact m = ceil(1000*ln(.01)/ln(1/2^ln2))
    n, p = 1000, 0.01
    import math
    expected = math.ceil((n * math.log(p)) / math.log(1.0 / math.pow(2.0, math.log(2.0))))
    assert cbf_size(n, p) == expected
    bf = CountingBloomFilter(n=n, p=p, seed=0)
    # filter size is the exact size rounded up to a power of two
    assert bf.size >= expected and bf.size & (bf.size - 1) == 0
    assert bf.num_hashes == round(bf.size * math.log(2.0) / n)


def test_cbf_add_count_find():
    bf = CountingBloomFilter(n=2000, p=0.01, seed=42)
    rng = np.random.default_rng(3)
    present = rng.integers(1, 1 << 60, size=500, dtype=np.uint64)
    absent = rng.integers(1, 1 << 60, size=500, dtype=np.uint64)
    absent = np.setdiff1d(absent, present)

    bf.add(present)
    bf.add(present[:100])  # second insertion for the first 100

    counts = bf.count(present)
    assert (counts >= 1).all()
    assert (counts[:100] >= 2).all()
    assert bf.find(present).all()

    # false positive rate should be around p=1%
    fp = bf.find(absent).mean()
    assert fp < 0.05

    # counts are (near) exact for distinct keys: min-over-positions may
    # overcount on collisions, never undercount
    assert (counts[100:] >= 1).all()


def test_cbf_saturation_equivalence():
    bf = CountingBloomFilter(n=100, p=0.01, seed=1)
    key = np.array([12345], dtype=np.uint64)
    # add in chunks totalling > 255
    for _ in range(3):
        bf.add(np.repeat(key, 100))
    assert bf.count(key)[0] == 255


def test_cbf_masked_add():
    bf = CountingBloomFilter(n=100, p=0.01, seed=1)
    keys = np.array([1, 2, 3], dtype=np.uint64)
    bf.add(keys, mask=np.array([True, False, True]))
    assert bf.count(np.array([1], np.uint64))[0] >= 1
    assert bf.count(np.array([3], np.uint64))[0] >= 1
    # key 2 was masked out; may still collide, but with tiny filter load it
    # should be absent
    assert bf.count(np.array([2], np.uint64))[0] == 0


def test_cbf_determinism_and_save_load(tmp_path):
    a = CountingBloomFilter(n=500, p=0.01, seed=7)
    b = CountingBloomFilter(n=500, p=0.01, seed=7)
    assert (a.seeds == b.seeds).all()
    keys = np.arange(1, 200, dtype=np.uint64)
    a.add(keys)
    b.add(keys)
    assert (np.asarray(a.filter) == np.asarray(b.filter)).all()

    p = str(tmp_path / "bf.npz")
    a.save(p)
    c = CountingBloomFilter.load(p)
    assert (c.count(keys) == a.count(keys)).all()


def test_chunked_add_matches_dense_add():
    """The position-range-chunked saturating add (large-filter path) must
    agree exactly with the dense-histogram add, incl. saturation, for any
    chunk/filter-size relation."""
    import varigraph_tpu.ops.cbf as cbfmod
    from varigraph_tpu.ops.cbf import (
        _add,
        _positions,
        _saturating_update_chunked,
    )

    rng = np.random.default_rng(5)
    m = 1 << 12
    seeds = make_seeds(4, seed=9)
    filt_np = rng.integers(0, 256, size=m).astype(np.uint8)
    # heavy duplication so per-position counts are large and clamping triggers
    hashes = jnp.asarray(rng.integers(1, 50, size=4096, dtype=np.uint64))
    mask = jnp.asarray(rng.random(4096) < 0.9)

    dense = _add(jnp.asarray(filt_np), hashes, mask, jnp.asarray(seeds), m)

    pos = _positions(hashes, jnp.asarray(seeds), m)
    inc = jnp.broadcast_to(mask.astype(jnp.uint32), pos.shape).reshape(-1)
    orig = cbfmod._ADD_CHUNK
    try:
        # 1000: non-dividing chunk (1-D path with a short tail);
        # 1024: dividing chunk (2-D in-place path used for huge filters)
        for chunk_size in (1000, 1024):
            cbfmod._ADD_CHUNK = chunk_size
            chunked = _saturating_update_chunked(
                jnp.asarray(filt_np), pos.reshape(-1), inc, m
            )
            assert (np.asarray(dense) == np.asarray(chunked)).all(), chunk_size

        # mid path (2^30 < m <= 2^31): one full scatter histogram + chunked
        # in-place combine
        from varigraph_tpu.ops.cbf import _combine_hist_chunked

        hist = jnp.zeros((m,), jnp.uint32).at[pos.reshape(-1)].add(inc)
        for chunk_size in (1000, 1024):
            cbfmod._ADD_CHUNK = chunk_size
            mid = _combine_hist_chunked(jnp.asarray(filt_np), hist, m)
            assert (np.asarray(dense) == np.asarray(mid)).all(), chunk_size
    finally:
        cbfmod._ADD_CHUNK = orig


def test_host_cbf_matches_device_semantics():
    """HostCBF (host-RAM counters, exact non-pow2 sizing) must implement the
    same saturating-add/min-count semantics as a per-element simulation."""
    from varigraph_tpu.ops.cbf import HostCBF, _positions

    bf = HostCBF(n=500, p=0.01, seed=3)
    assert bf.size & (bf.size - 1) != 0 or bf.size > 0  # exact sizing
    rng = np.random.default_rng(8)
    hashes = rng.integers(1, 40, size=512, dtype=np.uint64)  # heavy dups
    mask = rng.random(512) < 0.8
    bf.add(hashes, mask)
    bf.add(hashes[:100])  # second round, no mask

    # per-element oracle with the same seeds/size
    sim = np.zeros(bf.size, np.uint16)
    pos = np.asarray(
        _positions(jnp.asarray(hashes), jnp.asarray(bf.seeds), bf.size)
    )
    for rnd, mk in ((pos, mask), (pos[:, :100], np.ones(100, bool))):
        for j in range(rnd.shape[1]):
            if not mk[j]:
                continue
            for i in range(rnd.shape[0]):
                sim[rnd[i, j]] = min(sim[rnd[i, j]] + 1, 255)
    assert (bf.filter == sim.astype(np.uint8)).all()

    counts = bf.count(hashes[:32])
    expect = pos[:, :32]
    for j in range(32):
        assert counts[j] == sim[expect[:, j]].min()
    assert (bf.find(hashes[:32]) == (counts > 0)).all()


def test_exact_genome_counter_matches_brute_force(monkeypatch):
    """ExactGenomeCounter (one streaming sort-merge pass, the large-genome
    replacement for the Bloom filter) must return the EXACT multiplicity of
    every queried k-mer in the genome, capped at 255."""
    from varigraph_tpu.ops.exact_count import ExactGenomeCounter
    from varigraph_tpu.index.build import segment_genome_batches
    from varigraph_tpu.ops.kmer import sketch_codes

    rng = np.random.default_rng(13)
    # a random core plus a 300x-repeated motif to exercise the 255 cap
    seq = ("".join(rng.choice(list("ACGT"), size=3000))
           + "ACGTTGCACCGTTGAACGGTTGCACCA" * 300)
    k = 27
    n = len(seq) - k + 1

    all_values = []
    for batch in segment_genome_batches(seq, k):
        values, emit = sketch_codes(jnp.asarray(batch), k)
        v = np.asarray(values).reshape(-1)[np.asarray(emit).reshape(-1)]
        all_values.append(v)
    genome_kmers = np.concatenate(all_values)
    uniq, true_counts = np.unique(genome_kmers, return_counts=True)

    present = uniq[rng.permutation(len(uniq))[:200]]
    absent = rng.integers(1, 1 << 60, size=100, dtype=np.uint64) << np.uint64(8)
    queries = np.concatenate([present, absent, present[:7]])  # incl. dups

    monkeypatch.setattr(ExactGenomeCounter, "ADD_STACK", 2)  # many joins
    ec = ExactGenomeCounter({"chr1": seq}, n=n, k=k, p=0.01, seed=5)
    got = ec.count(queries)
    want = np.minimum(true_counts[np.searchsorted(uniq, present)], 255)
    assert (got[:200] == want).all()
    assert (got[200:300] == 0).all()
    assert (got[300:] == want[:7]).all()  # duplicate queries answered alike
    assert (want == 255).any()  # the cap was actually exercised
    assert (ec.find(queries[:200]) == (got[:200] > 0)).all()
    assert 0 < ec.occupancy() <= 1
