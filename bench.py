"""Benchmark harness: read k-mer counting throughput per chip, SELF-VERIFYING.

Prints ONE JSON line to stdout:
  {"metric": "read_kmers_per_sec_per_chip", "value": N, "unit": "kmers/s",
   "vs_baseline": R, "device_loop_value": N2, "device_vs_baseline": R2,
   "verified": true, ...}

The headline ``value`` is the END-TO-END counting throughput (gz streaming +
packing + H2D + device join), the number a user actually sees; the
pure-device loop (pre-staged batches, excludes H2D) is reported separately
as ``device_loop_value``.  vs_baseline = end-to-end / the reference C++
binary's counting phase measured on this host, when that binary is built.

Every trial is self-verifying:
  1. it computes on FRESH inputs (per-trial salts added to the
     accumulators, so no (executable, buffers) pair ever repeats),
  2. it must produce cov.sum() exactly equal to an expected hit count
     (established once and cross-checked between the device loop and the
     independent end-to-end path), and
  3. the whole pipeline is anchored against the pure-Python spec oracle
     (ops/sketch_ref) on a subset of real reads, joined on host with
     numpy searchsorted and compared per-key to a device dispatch of the
     production shape.
The recorded number is the MEDIAN of the trials.  The card's name and power
limit (nvidia-smi) are printed to stderr and recorded in the JSON.

Both sides read the SAME inputs: the sample's reads split across 4 gz FASTQ
files (the reference accepts multi-file samples but streams them strictly
sequentially, src/fastq_kmer.cpp:41-63; our feed decompresses files on
parallel threads).  Reference counting phase: src/fastq_kmer.cpp:65-187.

Dataset (cached in .bench_cache/): 2 Mb synthetic genome, 2000 variants,
~20x reads for one sample; our graph index built once and reused.

A second LARGE-TABLE configuration (bench_ours_large_table) measures the
same stream against a 24M-key table -- the operating regime of a 1 Gbp
genome (29M keys at the dress rehearsal; ~10^8 for humans) where round 3's
per-batch joins could not run at all.  Its numbers are reported under
"large_table" in the JSON line, verified the same way.
"""

import json
import os
import re
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".bench_cache")
K = 27
GENOME_MB = 2
DEPTH = 20.0
READ_LEN = 150
N_FILES = 4   # reads split across gz files; both sides get the same list
REPEATS = 3   # each file passed this many times
DEVICE_TRIALS = 3
E2E_TRIALS = 5      # median of 5
E2E_REPEATS = 10    # passes per e2e trial (~0.4 Gb: long enough that
                    # steady-state streaming dominates startup)
ORACLE_READS = 128  # reads host-verified against ops/sketch_ref


def log(msg):
    sys.stderr.write(f"[bench] {msg}\n")
    sys.stderr.flush()


def ensure_dataset():
    os.makedirs(CACHE, exist_ok=True)
    marker = os.path.join(CACHE, "ready2")
    paths = {
        "ref": os.path.join(CACHE, "ref.fa"),
        "vcf": os.path.join(CACHE, "vars.vcf.gz"),
        "fqs": [os.path.join(CACHE, f"S1_{i}.fq.gz") for i in range(N_FILES)],
        "graph": os.path.join(CACHE, "graph.vgt"),
    }
    if os.path.exists(marker):
        return paths
    log("generating bench dataset (one-time)...")
    import gzip

    from data_gen import generate_dataset

    generate_dataset(
        CACHE,
        seed=123,
        chrom_lens={"chr1": GENOME_MB * 1_000_000},
        n_variants=2000,
        samples=("S1", "S2"),
        depth=DEPTH,
        read_len=READ_LEN,
    )
    # split the single fq into N_FILES round-robin shards
    src = os.path.join(CACHE, "S1.fq.gz")
    outs = [gzip.open(p, "wt", compresslevel=6) for p in paths["fqs"]]
    with gzip.open(src, "rt") as fh:
        rec = []
        n = 0
        for line in fh:
            rec.append(line)
            if len(rec) == 4:
                outs[n % N_FILES].writelines(rec)
                rec = []
                n += 1
    for fh in outs:
        fh.close()
    os.remove(src)

    log("building graph index (one-time)...")
    from varigraph_tpu.config import VarigraphConfig
    from varigraph_tpu.index.build import construct_graph_index
    from varigraph_tpu.index.serialize import save_graph

    cfg = VarigraphConfig(ref_file=paths["ref"], vcf_file=paths["vcf"],
                          kmer_len=K, seed=0)
    gi = construct_graph_index(cfg)
    save_graph(gi, paths["graph"])
    open(marker, "w").write("ok")
    return paths


def count_total_kmers(fq_paths):
    import gzip

    total = 0
    for fq_path in fq_paths:
        with gzip.open(fq_path, "rb") as fh:
            for i, line in enumerate(fh):
                if i % 4 == 1:
                    total += max(len(line.rstrip(b"\n")) - K + 1, 0)
    return total


def read_first_seqs(fq_path, n):
    import gzip

    seqs = []
    with gzip.open(fq_path, "rb") as fh:
        for i, line in enumerate(fh):
            if i % 4 == 1:
                seqs.append(line.rstrip(b"\n"))
                if len(seqs) == n:
                    break
    return seqs


def oracle_check(keys_np, batch_shape, fuse, step, cov_template, keys_dev, fq):
    """Anchor the production counting dispatch against the pure-Python spec
    oracle: ORACLE_READS real reads are packed (2-bit wire format) into row
    0.. of an otherwise empty stack of the PRODUCTION shape (so no extra
    compile), counted on device, and the per-key counts must exactly equal
    a host sketch_ref + searchsorted join."""
    import numpy as np

    from varigraph_tpu.ops.kmer import pack_codes_np
    from varigraph_tpu.ops.sketch_ref import SEQ_NT4_TABLE, sketch_ref

    seqs = read_first_seqs(fq, ORACLE_READS)
    b, l = batch_shape
    codes = np.full((b, l), 4, dtype=np.uint8)
    lens = np.zeros(b, np.int32)
    vals = []
    for r, s in enumerate(seqs):
        s = s[:l]
        row = SEQ_NT4_TABLE[np.frombuffer(s, np.uint8)]
        assert (row < 4).all(), "oracle reads must be pure ACGT (prefix-valid)"
        codes[r, : len(s)] = row
        lens[r] = len(s)
        vals.extend(sketch_ref(s, K))
    packed0 = pack_codes_np(codes, lens)
    stack = np.zeros((fuse,) + packed0.shape, dtype=np.uint8)
    stack[0] = packed0
    vals = np.asarray(vals, dtype=np.uint64)
    m = len(keys_np)
    idx = np.searchsorted(keys_np, vals)
    found = (idx < m) & (keys_np[np.minimum(idx, m - 1)] == vals)
    want = np.bincount(idx[found], minlength=m).astype(np.uint32)
    import jax.numpy as jnp

    # fresh zeros: ``step`` donates its first argument
    got = np.asarray(
        step(jnp.zeros_like(cov_template), keys_dev, jnp.asarray(stack), K)
    )
    if not (got == want).all():
        bad = int((got != want).sum())
        raise AssertionError(
            f"oracle check FAILED: device counts differ from the host spec "
            f"oracle at {bad}/{m} keys (oracle hits {int(want.sum())}, "
            f"device {int(got.sum())})"
        )
    log(f"oracle check OK: {int(want.sum())} hits from {len(seqs)} reads "
        f"match the host spec oracle per-key")
    return int(want.sum())


def bench_ours(paths):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from varigraph_tpu.genotype.counting import _FUSE, _count_fused, count_reads
    from varigraph_tpu.index.serialize import load_graph
    from varigraph_tpu.io.fastq import stream_packed_batches

    gi = load_graph(paths["graph"])
    log(f"backend: {jax.devices()[0]}; table size {gi.table.size}")

    # rows sized to the data (150 bp reads; the nearest multiple of 4):
    # at k=27 a [16384, 152] batch yields 126 join slots/row of which ~124
    # emit -- 98% band occupancy vs 77% at the old 160-wide rows
    batch_size, max_len = 16384, 152

    batches = []
    for fq in paths["fqs"]:
        batches.extend(
            p for p, _ in stream_packed_batches(fq, batch_size, max_len, K)
        )
    kmers_one_pass = count_total_kmers(paths["fqs"])
    total_kmers = kmers_one_pass * REPEATS
    log(f"{len(batches)} batches/pass, {total_kmers/1e6:.1f}M read k-mers/trial")

    # stack into fused groups of the production dispatch shape [F, B, L/4+2]
    stacks = []
    pad = np.zeros_like(batches[0])
    for i in range(0, len(batches), _FUSE):
        grp = batches[i : i + _FUSE]
        while len(grp) < _FUSE:
            grp.append(pad)
        stacks.append(np.stack(grp))

    keys = gi.table.keys

    # ---- correctness anchor vs the pure-Python spec oracle ----------------
    oracle_check(gi.table.keys_np(), (batch_size, max_len), _FUSE,
                 _count_fused, gi.table.cov, keys, paths["fqs"][0])

    # pre-stage one pass worth of stacks on device; trials loop REPEATS times
    dev_stacks = [jax.device_put(jnp.asarray(s)) for s in stacks]

    # ---- expected-hits pass (also warmup/compile) -------------------------
    cov_once = jnp.zeros_like(gi.table.cov)
    for s in dev_stacks:
        cov_once = _count_fused(cov_once, keys, s, K)
    cov_once.block_until_ready()
    hits_once = int(cov_once.sum())
    assert 0 < hits_once <= kmers_one_pass, (hits_once, kmers_one_pass)
    log(f"expected hits/pass: {hits_once} "
        f"({100.0*hits_once/kmers_one_pass:.1f}% of read k-mers)")

    # ---- device-loop trials (fresh salted inputs, verified, median) -------
    n_acc = 3
    dev_thrs = []
    for trial in range(DEVICE_TRIALS):
        salts = [trial * n_acc + i + 1 for i in range(n_acc)]
        accs = [
            jnp.zeros_like(gi.table.cov).at[i].add(np.uint32(salts[i]))
            for i in range(n_acc)
        ]
        i = 0
        t0 = time.perf_counter()
        for _ in range(REPEATS):
            for s in dev_stacks:
                accs[i % n_acc] = _count_fused(accs[i % n_acc], keys, s, K)
                i += 1
        total = accs[0] + accs[1] + accs[2]
        total.block_until_ready()
        dt = time.perf_counter() - t0
        got = int(total.sum())
        want = hits_once * REPEATS + sum(salts)
        if got != want:
            raise AssertionError(
                f"device trial {trial}: cov sum {got} != expected {want} -- "
                f"the timed loop did not do the expected work"
            )
        thr = total_kmers / dt
        log(f"device trial {trial}: {dt:.3f}s -> {thr/1e6:.1f}M kmers/s "
            f"[sum OK]")
        dev_thrs.append(thr)
    del dev_stacks
    thr_dev = statistics.median(dev_thrs)

    # ---- end-to-end trials (independent path: gz stream + H2D + device) ---
    files = paths["fqs"] * E2E_REPEATS
    e2e_kmers = kmers_one_pass * E2E_REPEATS

    def e2e_round():
        e2e_thrs = []
        for trial in range(E2E_TRIALS):
            salt = trial + 1
            gi.table.reset_cov()
            # salt so no two trials run an identical chain
            gi.table.cov = gi.table.cov.at[trial].add(np.uint32(salt))
            t0 = time.perf_counter()
            count_reads(gi.table, files, K, batch_size, max_len)
            gi.table.cov.block_until_ready()
            dt = time.perf_counter() - t0
            got = int(gi.table.cov.sum())
            want = hits_once * E2E_REPEATS + salt
            if got != want:
                raise AssertionError(
                    f"e2e trial {trial}: cov sum {got} != expected {want} "
                    f"-- the end-to-end path did not do the expected work"
                )
            thr = e2e_kmers / dt
            log(f"end-to-end trial {trial}: {dt:.3f}s "
                f"-> {thr/1e6:.1f}M kmers/s [sum OK]")
            e2e_thrs.append(thr)
        return statistics.median(e2e_thrs)

    return e2e_round(), thr_dev


LARGE_TABLE_KEYS = 24_000_000  # ~the 1 Gbp rehearsal's 29M-key regime
LARGE_DEVICE_TRIALS = 3
LARGE_E2E_TRIALS = 2
# stream multiplier for the large-table configuration: the staged-phase
# design amortizes per-phase costs over hundreds of batches, so the stream
# must be long enough that steady state dominates.  25 passes ~= 1 Gb /
# ~500 batches.
LARGE_REPEATS = 25
LARGE_REF_REPEATS = 6  # reference large-table stream (its rate is flat in
                       # stream length; 6 passes ~= 90s window at its
                       # measured 29M-key rate, enough for 1s-resolution
                       # log timestamps)


def bench_ours_large_table(paths):
    """Counting throughput against a LARGE table (the superbatch regime of
    genomes of 1 Gbp and up).  The real 2 Mb graph's keys are augmented
    with random decoy
    keys to LARGE_TABLE_KEYS; decoys share the span byte but are fresh
    55-bit hashes, so the expected hit count is unchanged (collision odds
    ~1e-8) and every trial is verified by the exact cov sum.  Dispatches
    are the production large-table path (genotype/counting.
    _count_packed_super, auto-selected by count_reads above
    _SMALL_TABLE_MAX_KEYS)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import varigraph_tpu.genotype.counting as C
    from varigraph_tpu.index.serialize import load_graph
    from varigraph_tpu.io.fastq import stream_packed_batches

    gi = load_graph(paths["graph"])
    batch_size, max_len = 16384, 152
    rng = np.random.default_rng(42)
    n_decoy = LARGE_TABLE_KEYS - gi.table.size
    decoys = (rng.integers(1, 1 << 55, size=n_decoy, dtype=np.uint64)
              << np.uint64(8)) | np.uint64(K)
    big_keys = np.unique(np.concatenate([gi.table.keys_np(), decoys]))
    keys = jnp.asarray(big_keys)
    m = len(big_keys)
    log(f"large-table config: {m/1e6:.1f}M keys "
        f"({gi.table.size} real + decoys)")

    batches = []
    for fq in paths["fqs"]:
        batches.extend(
            p for p, _ in stream_packed_batches(fq, batch_size, max_len, K)
        )
    kmers_one_pass = count_total_kmers(paths["fqs"])
    total_kmers = kmers_one_pass * LARGE_REPEATS
    nq = batch_size * (max_len - K + 1)
    # PRODUCTION super-group size for this table (scaled with M, exactly
    # what count_reads picks)
    g = C._pick_super_rows(m, nq)
    seq = batches * LARGE_REPEATS
    groups = []
    pad = np.zeros_like(batches[0])
    for i in range(0, len(seq), g):
        grp = seq[i : i + g]
        while len(grp) < g:
            grp.append(pad)  # zero rows emit nothing (production padding)
        groups.append(np.stack(grp))
    log(f"large-table stream: {len(seq)} batches "
        f"({total_kmers/1e6:.0f}M k-mers) in {len(groups)} super-groups "
        f"of {g}")
    dev_groups = [jax.device_put(jnp.asarray(s)) for s in groups]

    def one_sweep(cov):
        for s in dev_groups:
            cov = C._count_packed_super(cov, keys, s, K)
        return cov

    # expected hits (also warmup/compile); must match the small-table count
    cov_once = one_sweep(jnp.zeros((m,), jnp.uint32))
    hits_sweep = int(np.asarray(cov_once.sum()))
    assert 0 < hits_sweep <= total_kmers, (hits_sweep, total_kmers)
    log(f"large-table expected hits/sweep: {hits_sweep}")

    dev_thrs = []
    for trial in range(LARGE_DEVICE_TRIALS):
        cov = jnp.zeros((m,), jnp.uint32).at[trial].add(np.uint32(trial + 1))
        t0 = time.perf_counter()
        cov = one_sweep(cov)
        total = int(np.asarray(cov.sum()))  # real D2H fetch = real sync
        dt = time.perf_counter() - t0
        want = hits_sweep + trial + 1
        if total != want:
            raise AssertionError(
                f"large-table device trial {trial}: cov sum {total} != "
                f"expected {want}")
        thr = total_kmers / dt
        log(f"large-table device trial {trial}: {dt:.3f}s -> "
            f"{thr/1e6:.1f}M kmers/s [sum OK]")
        dev_thrs.append(thr)
    del dev_groups
    thr_dev = statistics.median(dev_thrs)

    # end-to-end through the production count_reads dispatch
    big_table = type(gi.table)(
        keys=keys, cov=jnp.zeros((m,), jnp.uint32),
        freq=jnp.zeros((m,), jnp.uint8),
        hapbits=jnp.zeros((m, 1), jnp.uint32),
        refflag=jnp.zeros((m,), jnp.bool_), nhap=gi.table.nhap,
    )
    files = paths["fqs"] * LARGE_REPEATS
    e2e_thrs = []
    for trial in range(LARGE_E2E_TRIALS):
        big_table.cov = jnp.zeros((m,), jnp.uint32).at[trial].add(
            np.uint32(trial + 1))
        t0 = time.perf_counter()
        C.count_reads(big_table, files, K, batch_size, max_len)
        got = int(np.asarray(big_table.cov.sum()))
        dt = time.perf_counter() - t0
        want = hits_sweep + trial + 1
        if got != want:
            raise AssertionError(
                f"large-table e2e trial {trial}: cov sum {got} != "
                f"expected {want}")
        thr = total_kmers / dt
        log(f"large-table e2e trial {trial}: {dt:.3f}s -> "
            f"{thr/1e6:.1f}M kmers/s [sum OK]")
        e2e_thrs.append(thr)
    thr_e2e = statistics.median(e2e_thrs)
    return thr_e2e, thr_dev, m, big_keys


def ensure_big_ref_graph(paths, big_keys):
    """Write a reference-format graph.bin whose k-mer table is augmented to
    the SAME key set as the large-table config (real keys + decoys), so the
    reference binary can be measured in a MATCHED table regime: its
    hash-map probe slows at 10^7+ keys, so its small-table rate is the
    wrong denominator for the large-table configuration."""
    import numpy as np

    out = os.path.join(CACHE, "graph_big.bin")
    if os.path.exists(out):
        return out
    log("building matched large-table reference graph.bin (one-time)...")
    import jax.numpy as jnp

    from varigraph_tpu.index.interop import save_reference_graph_bin
    from varigraph_tpu.index.serialize import load_graph
    from varigraph_tpu.ops.table import KmerTable

    gi = load_graph(paths["graph"])
    m = len(big_keys)
    keys_small = gi.table.keys_np()
    pos = np.searchsorted(big_keys, keys_small)
    assert (big_keys[pos] == keys_small).all()
    freq = np.ones(m, np.uint8)
    freq[pos] = gi.table.freq_np()
    words = np.zeros((m, gi.table.hap_words_np().shape[1]), np.uint32)
    words[pos] = gi.table.hap_words_np()
    refflag = np.zeros(m, bool)
    refflag[pos] = gi.table.refflag_np()
    tbl = KmerTable(keys=big_keys, cov=jnp.zeros((m,), jnp.uint32),
                    freq=freq, hapbits=words, refflag=refflag,
                    nhap=gi.table.nhap)
    tbl._keys_np, tbl._freq_np = big_keys, freq
    tbl._words_np, tbl._refflag_np = words, refflag
    gi.table = tbl
    save_reference_graph_bin(gi, out)
    return out


def bench_reference(paths, graph_bin=None, repeats=REPEATS, tag="small",
                    timeout=900):
    """Measure the reference binary's FASTQ k-mer collection phase against
    ``graph_bin`` (default: its own construct output)."""
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             ".ref_build")
    ref_bin = os.path.join(build_dir, "varigraph")
    if not os.path.exists(ref_bin) and os.path.isdir("/root/reference"):
        log("building reference binary (one-time)...")
        os.makedirs(build_dir, exist_ok=True)
        try:
            subprocess.run(["cmake", "/root/reference"], cwd=build_dir,
                           capture_output=True, timeout=600, check=True)
            subprocess.run(["make", "-j2"], cwd=build_dir,
                           capture_output=True, timeout=900, check=True)
        except Exception as e:
            log(f"reference build failed: {e}")
    if not os.path.exists(ref_bin):
        log("reference binary not found; vs_baseline = 0")
        return None
    if graph_bin is None:
        graph_bin = os.path.join(CACHE, "graph.bin")
        if not os.path.exists(graph_bin):
            log("building reference graph.bin (one-time)...")
            r = subprocess.run(
                [ref_bin, "construct", "-r", paths["ref"], "-v", paths["vcf"],
                 "--save-graph", graph_bin, "-t", "2"],
                capture_output=True, text=True, timeout=1800,
            )
            if r.returncode != 0:
                log(f"reference construct failed: {r.stderr[-500:]}")
                return None
    cfg_path = os.path.join(CACHE, f"samples_ref_{tag}.cfg")
    with open(cfg_path, "w") as fh:
        fh.write("S1 " + " ".join(paths["fqs"] * repeats) + "\n")
    # the reference's ThreadPool occasionally deadlocks at startup (0 CPU,
    # futex wait, observed 2026-08-20); bound each attempt and retry
    for attempt in range(3):
        t0 = time.perf_counter()
        try:
            r = subprocess.run(
                [ref_bin, "genotype", "--load-graph", graph_bin, "-s",
                 cfg_path, "-t", "2"],
                capture_output=True, text=True, timeout=timeout, cwd=CACHE,
            )
        except subprocess.TimeoutExpired:
            log(f"reference genotype attempt {attempt} timed out (its "
                f"thread pool can deadlock at startup); retrying")
            continue
        if r.returncode == 0:
            break
        log(f"reference genotype failed: {r.stderr[-500:]}")
    else:
        return None
    # parse its log timestamps around the k-mer collection phase
    lines = r.stderr.splitlines()
    t_start = t_end = None
    ts = re.compile(r"::(\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2})\]")
    for line in lines:
        m = ts.search(line)
        if m is None:
            continue
        t = time.mktime(time.strptime(m.group(1), "%Y-%m-%d %H:%M:%S"))
        if "Collecting kmers from read" in line and t_start is None:
            t_start = t
        if ("highest: count[" in line or "Genotyping" in line) and t_start is not None:
            t_end = t
            break
    if t_start is None or t_end is None or t_end <= t_start:
        log("could not isolate the reference counting phase from logs; "
            "using total genotype wall-clock")
        dt = time.perf_counter() - t0
    else:
        dt = t_end - t_start
    total_kmers = count_total_kmers(paths["fqs"]) * repeats
    thr = total_kmers / dt
    log(f"reference counting [{tag}]: {dt:.1f}s -> {thr/1e6:.1f}M kmers/s "
        f"(2 threads)")
    return thr


def main():
    import jax

    from chip_smoke import card_info, require_gpu

    card = card_info()
    dev = jax.devices()[0]
    require_gpu(dev.platform, len(jax.devices()))
    log(f"card: {card}; jax device: {dev.device_kind}")
    paths = ensure_dataset()
    thr_e2e, thr_dev = bench_ours(paths)
    lg_e2e, lg_dev, lg_keys, big_keys = bench_ours_large_table(paths)
    ref = bench_reference(paths)
    ref_large = None
    if ref:
        # MATCHED-regime baseline: the reference measured against the SAME
        # 24M-key table (real keys + identical decoys, via the interop
        # writer)
        big_bin = ensure_big_ref_graph(paths, big_keys)
        ref_large = bench_reference(paths, graph_bin=big_bin,
                                    repeats=LARGE_REF_REPEATS, tag="large",
                                    timeout=1200)
    print(json.dumps({
        "metric": "read_kmers_per_sec_per_chip",
        "value": round(thr_e2e, 1),
        "unit": "kmers/s",
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "vs_baseline": round(thr_e2e / ref, 3) if ref else 0.0,
        "device_loop_value": round(thr_dev, 1),
        "device_vs_baseline": round(thr_dev / ref, 3) if ref else 0.0,
        "baseline_value": round(ref, 1) if ref else 0.0,
        "large_table": {
            "keys": lg_keys,
            "value": round(lg_e2e, 1),
            "device_loop_value": round(lg_dev, 1),
            # baseline measured in the MATCHED regime: the reference binary
            # counting the same stream against the same 24M-key table
            "baseline_value": round(ref_large, 1) if ref_large else 0.0,
            "vs_baseline": round(lg_e2e / ref_large, 3) if ref_large else 0.0,
            "device_vs_baseline":
                round(lg_dev / ref_large, 3) if ref_large else 0.0,
        },
        "verified": True,
        "trials": "median of sum-verified trials",
    }))


if __name__ == "__main__":
    main()
