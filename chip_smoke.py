"""GPU smoke run: the construct -> genotype path end to end on one card, with
exact counting parity and GPU-vs-CPU scoring checks.

Usage, from the repository root of a machine with an NVIDIA GPU:

    python chip_smoke.py                # one card: phases a-d
    python chip_smoke.py --four-cards   # the mesh phase only, on four cards

One card:
  a  card: the nvidia-smi name and power limit, and jax.devices(); the
     platform must be "gpu".
  b  end to end: a tools/gen_big.py dataset (100 Mb, 50k sites, 101
     haplotypes, ~1 Gbp of reads; cached under .smoke/), then
     `construct -t 4` and `genotype --save-counts` through varigraph_tpu.cli.
     GT vs truth on written sites must reach GT_MIN.
  c  counting at production width: [16384, 160] packed read batches against
     a ~100k-key table through _count_fused and _count_packed_super; the
     per-key counts must equal the ops/sketch_ref oracle exactly.
  d  scoring on GPU vs CPU: a JAX_PLATFORMS=cpu child re-scores the sample
     from the saved counts (>= GPU_CPU_GT_MIN identical GT), and
     _emissions_group / _forward_backward run at production shapes on both
     backends, compared within RTOL / ATOL.

Four cards (--four-cards): construct on one card and on four (sharded
counting Bloom filter forced on), whose tables must be byte-identical; then
genotype on one card and with --mesh-devices 4 (hash-range-sharded
superbatch counting forced on, window-sharded forward/backward), whose GT
calls must be identical.

Only one process holds a card at a time: all GPU work runs in sequential
child processes and this parent never initialises JAX.  The CPU-pinned child
of phase d is the only process that runs beside a GPU child.  Any failed
phase raises, so the script exits non-zero and prints no result; the last
line of stdout, printed only when every phase passed, is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")

# phase b: GT vs truth on written sites (the same dataset at depth 10 gave
# 0.9954 on written sites in an earlier run of this pipeline)
GT_MIN = 0.99
# phase d: share of written sites whose GT the CPU re-scoring reproduces
GPU_CPU_GT_MIN = 0.999
# phase d kernel tolerances.  alpha/beta are per-node normalised
# probabilities and logE sums of 128 log-Poisson terms; the two backends
# differ only in summation order and in the last ulp of exp/log/lgamma.
RTOL = 1e-4
ATOL = 1e-6

# tools/gen_big.py arguments of the end-to-end dataset
E2E_DATA = dict(mb=100, variants=50_000, samples=50, depth=10, files=4, seed=7)
# the four-card phase compares two runs of each step, so it uses a smaller
# genome; sharding is forced on below
MESH_DATA = dict(mb=20, variants=10_000, samples=50, depth=10, files=4, seed=7)

K = 27
BATCH, READ_LEN_PAD, READ_LEN = 16384, 160, 150   # config.py defaults


def say(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


# ----------------------------------------------------------------------
# helpers shared by the parent and the children
# ----------------------------------------------------------------------

def card_info() -> str:
    """`name, power.limit` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi reported no card")
    return out


def require_gpu(platform: str, count: int, need: int = 1) -> None:
    if platform != "gpu":
        raise RuntimeError(f"JAX platform is {platform!r}, not 'gpu'")
    if count < need:
        raise RuntimeError(f"{count} GPU(s) visible, {need} needed")


def contract_line(platform: str, kind: str, count: int) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def written_site_agreement(gpu_vcf: str, cpu_vcf: str) -> tuple[int, int]:
    from tools.vcf_compare import gt_agreement, read_calls

    return gt_agreement(read_calls(gpu_vcf), read_calls(cpu_vcf))


def truth_check(vcf: str, truth: str):
    from tools.vcf_compare import read_calls, read_truth, truth_concordance

    return truth_concordance(read_calls(vcf), read_truth(truth))


# ----------------------------------------------------------------------
# children (each a fresh process)
# ----------------------------------------------------------------------

def child_device() -> None:
    import jax

    devs = jax.devices()
    print(f"[smoke] jax.devices(): {devs}", flush=True)
    d = devs[0]
    print("DEVICE " + json.dumps({"platform": d.platform,
                                  "kind": d.device_kind,
                                  "count": len(devs)}), flush=True)


def child_cli(argv: list[str]) -> None:
    """Run one varigraph CLI command, then report peak host and device
    memory of this process."""
    import resource

    from varigraph_tpu.cli import main

    rc = main(argv)
    if rc:
        raise SystemExit(rc)
    import jax

    peaks = []
    for d in jax.local_devices():
        st = d.memory_stats() or {}
        peaks.append(st.get("peak_bytes_in_use", 0) / 2**30)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"[smoke] {argv[0]}: peak RSS {rss:.2f} GiB; peak device memory "
          + ", ".join(f"{p:.2f}" for p in peaks) + " GiB", flush=True)


def counting_fixture(batch: int, pad_len: int, read_len: int, n_keys: int,
                     seed: int = 11):
    """Reads, per-read oracle k-mers and a table for the counting parity
    phase.

    Returns (codes [batch, read_len] u8, kmers [batch, read_len-K+1] u64
    from ops/sketch_ref, keys sorted u64).  Reads are pure ACGT and K is odd,
    so every read emits exactly read_len-K+1 k-mers and a prefix of length
    l emits the first l-K+1 of them."""
    import numpy as np

    from varigraph_tpu.ops.sketch_ref import sketch_ref

    assert read_len <= pad_len
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=max(4 * batch * read_len // 5, 4096),
                          dtype=np.uint8)
    starts = rng.integers(0, len(genome) - read_len, size=batch)
    codes = genome[starts[:, None] + np.arange(read_len)]
    acgt = np.frombuffer(b"ACGT", np.uint8)
    kmers = np.array([sketch_ref(acgt[row].tobytes(), K) for row in codes],
                     dtype=np.uint64)
    assert kmers.shape == (batch, read_len - K + 1), kmers.shape
    flat = kmers.reshape(-1)
    hits = rng.choice(flat, size=min(n_keys // 2, len(flat)), replace=False)
    decoys = (rng.integers(1, 1 << 55, size=n_keys, dtype=np.uint64)
              << np.uint64(8)) | np.uint64(K)
    keys = np.unique(np.concatenate([hits, decoys]))[:n_keys]
    return codes, kmers, np.sort(keys)


def counting_stack(codes, kmers, keys, n_sub: int, pad_len: int, seed: int):
    """[n_sub, B, pad_len/4+2] packed sub-batches and their oracle per-key
    counts.  Sub-batch j holds the reads rolled by a random shift, each cut
    to a random prefix length (0 = empty row), so every sub-batch differs."""
    import numpy as np

    from varigraph_tpu.ops.kmer import pack_codes_np

    rng = np.random.default_rng(seed)
    b, read_len = codes.shape
    n_k = kmers.shape[1]
    full = np.full((b, pad_len), 4, np.uint8)
    stack, emitted = [], []
    for _ in range(n_sub):
        perm = np.roll(np.arange(b), int(rng.integers(0, b)))
        lens = rng.integers(K - 1, read_len + 1, size=b)
        lens[rng.random(b) < 0.02] = 0
        full[:, :read_len] = codes[perm]
        stack.append(pack_codes_np(full, lens.astype(np.int32)))
        take = np.arange(n_k)[None, :] < (lens - K + 1)[:, None]
        emitted.append(kmers[perm][take])
    vals = np.concatenate(emitted)
    m = len(keys)
    idx = np.searchsorted(keys, vals)
    found = (idx < m) & (keys[np.minimum(idx, m - 1)] == vals)
    want = np.bincount(idx[found], minlength=m).astype(np.uint32)
    return np.stack(stack), want


def phase_counting(batch=BATCH, pad_len=READ_LEN_PAD, read_len=READ_LEN,
                   n_keys=100_000) -> None:
    """Phase c: both counting regimes against the sketch_ref oracle."""
    import jax.numpy as jnp
    import numpy as np

    from varigraph_tpu.genotype import counting as C

    t0 = time.perf_counter()
    codes, kmers, keys = counting_fixture(batch, pad_len, read_len, n_keys)
    say(f"c: oracle k-mers of {batch} reads ({kmers.size} k-mers, "
        f"{len(keys)} keys) in {time.perf_counter() - t0:.1f}s")
    keys_dev = jnp.asarray(keys)
    m = len(keys)
    nq = batch * (pad_len - K + 1)
    for name, fn, n_sub in (
        ("_count_fused", C._count_fused, C._FUSE),
        ("_count_packed_super", C._count_packed_super,
         C._pick_super_rows(m, nq)),
    ):
        stack, want = counting_stack(codes, kmers, keys, n_sub, pad_len,
                                     seed=n_sub)
        dev = jnp.asarray(stack)
        t0 = time.perf_counter()
        got = np.asarray(fn(jnp.zeros((m,), jnp.uint32), keys_dev, dev, K))
        dt = time.perf_counter() - t0
        bad = int((got != want).sum())
        if bad:
            raise AssertionError(
                f"{name}: {bad}/{m} per-key counts differ from the oracle "
                f"(oracle hits {int(want.sum())}, device {int(got.sum())})")
        say(f"c: {name} {list(stack.shape)}: {int(want.sum())} hits over "
            f"{m} keys, exactly equal to the oracle (first call incl. "
            f"compile {dt:.1f}s)")


def scoring_inputs(n_windows: int, n_nodes: int, seed: int = 5):
    """Production-shape emission and forward/backward inputs: K=128
    k-mers per node, S/U pinned as engine_jax pins them for the default
    configuration (15 haplotypes, het, ploidy 2 -> S=128, U=32)."""
    import numpy as np

    from varigraph_tpu.genotype.combos import increment_vector
    from varigraph_tpu.genotype.engine_jax import (
        MAX_NODE_KMERS, _pow2, _transition_logs, state_count_matrix,
    )
    from varigraph_tpu.genotype.engine_np import get_error_param, \
        poisson_interval
    from varigraph_tpu.ops.table import pack_hapbits

    rng = np.random.default_rng(seed)
    hn, P, nhap = 15, 2, 101
    states = np.array(increment_vector(list(range(hn)), "het", P, nhap - 1),
                      np.int32)
    s_real = len(states)
    S, U, Kn = _pow2(s_real, 4), max(32, _pow2(hn, 4)), MAX_NODE_KMERS
    G = max(1, 4096 // n_nodes)               # engine_jax._EMIT_ROWS rows
    shape = (G, n_nodes, Kn)
    n_k = rng.integers(0, Kn + 1, size=(G, n_nodes))
    kmask = np.arange(Kn)[None, None, :] < n_k[..., None]
    bits = (rng.random(shape + (U,)) < 0.4) & (np.arange(U) < hn)
    local = bits & (rng.random(shape + (U,)) < 0.8)

    def pk(a):
        return pack_hapbits(a.reshape(-1, U).astype(np.uint8)).reshape(
            shape + (U // 32,))

    sc = np.zeros((G, U, S), np.float32)
    sc[:, :, :s_real] = state_count_matrix(states, U)
    smask = np.zeros((G, S), bool)
    smask[:, :s_real] = True
    gt0 = np.zeros((G, n_nodes, U), bool)
    gt0[..., :hn] = rng.random((G, n_nodes, hn)) < 0.5
    hap_cov = 2.0
    p = get_error_param(hap_cov)
    lo, up = poisson_interval(hap_cov)
    log_prior = float(np.log(1.0 / np.sqrt(2 * np.pi * 0.05))
                      - (p - 0.5) ** 2 / (2 * 0.05))
    emit = (
        rng.poisson(4.0, size=shape).astype(np.uint8),
        rng.integers(1, 4, size=shape).astype(np.uint8),
        rng.random(shape) < 0.05, kmask, pk(bits), pk(local), gt0, sc, smask,
        np.float32(hap_cov), np.float32(lo), np.float32(up),
        np.float32(np.log(p)), np.float32(np.log(1 - p)),
        np.float32(log_prior),
    )

    W, N = n_windows, n_nodes
    n_real = rng.integers(N // 2, N + 1, size=W)
    kind = np.where(np.arange(N)[None, :] < n_real[:, None], 1, 0)
    kind[(kind == 1) & (rng.random((W, N)) < 0.03)] = 2
    lrf, lnrf = _transition_logs(rng.integers(1, 3000, size=W * N), nhap)
    lrb, lnrb = _transition_logs(rng.integers(1, 3000, size=W * N), nhap)
    cnt = np.zeros((s_real, hn), np.int32)
    for si, st in enumerate(states):
        for h in st:
            cnt[si, h] += 1
    ov = np.zeros((S, S), np.int32)
    ov[:s_real, :s_real] = np.minimum(cnt[:, None, :], cnt[None, :, :]).sum(2)
    sm = np.zeros((W, S), bool)
    sm[:, :s_real] = True
    fb = (
        kind.astype(np.int32),
        lrf.reshape(W, N), lnrf.reshape(W, N),
        lrb.reshape(W, N), lnrb.reshape(W, N),
        np.broadcast_to(ov, (W, S, S)).copy(),
        np.zeros((W, S), np.float32), sm,
    )
    return emit, fb, P, rng


def _compare(name: str, gpu, cpu) -> None:
    import jax
    import numpy as np

    plat = jax.devices()[0].platform
    gpu, cpu = np.asarray(gpu), np.asarray(cpu)
    fin = np.isfinite(cpu)
    bad = ~np.isclose(gpu, cpu, rtol=RTOL, atol=ATOL)
    if bad.any():
        rows = bad.reshape(-1, bad.shape[-1]).any(axis=1)
        say(f"d: {name}: {int(bad.sum())} values in {int(rows.sum())} of "
            f"{rows.size} rows differ; first at {np.argwhere(bad)[0].tolist()}")
    np.testing.assert_array_equal(np.isfinite(gpu), fin,
                                  err_msg=f"{name}: non-finite pattern")
    np.testing.assert_allclose(gpu, cpu, rtol=RTOL, atol=ATOL,
                               err_msg=f"{name}: {plat} vs cpu")
    err = np.abs(gpu[fin] - cpu[fin])
    rel = err / np.maximum(np.abs(cpu[fin]), 1e-30)
    say(f"d: {name} {list(gpu.shape)}: {plat} == cpu within rtol {RTOL} / atol "
        f"{ATOL} (max abs diff {err.max():.3g}, max rel diff "
        f"{rel[err > ATOL].max() if (err > ATOL).any() else 0.0:.3g})")


def phase_scoring_kernels(n_windows: int = 256, n_nodes: int = 512) -> None:
    """Phase d, kernel part: the emission and forward/backward kernels on
    the default backend and on the CPU, same inputs."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from varigraph_tpu.genotype.engine_jax import _emissions_group, \
        _forward_backward

    emit, fb, P, rng = scoring_inputs(n_windows, n_nodes)
    cpu = jax.devices("cpu")[0]
    main = jax.devices()[0]

    def on(dev, arrs):
        return [jax.device_put(a, dev) for a in arrs]

    le = [_emissions_group(*on(d, emit[:9]), *emit[9:]) for d in (main, cpu)]
    _compare("_emissions_group logE", le[0], le[1])

    # forward/backward over emissions of the kind the kernel above makes,
    # tiled across the window group with per-window noise
    base = np.asarray(le[1])                       # [G, N, S]
    reps = -(-n_windows // base.shape[0])
    logE = np.tile(base, (reps, 1, 1))[:n_windows]
    logE = (logE + rng.normal(0, 1, size=logE.shape)).astype(np.float32)
    args = (logE,) + fb
    out = [_forward_backward(*on(d, args), jnp.bool_(False), P)
           for d in (main, cpu)]
    _compare("_forward_backward alpha", out[0][0], out[1][0])
    _compare("_forward_backward beta", out[0][1], out[1][1])


def child_kernels() -> None:
    phase_counting()
    phase_scoring_kernels()


# ----------------------------------------------------------------------
# parent
# ----------------------------------------------------------------------

class Children:
    """Runs child processes with their output in per-step log files, and
    stops whatever is still running when the parent exits."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.live: list[subprocess.Popen] = []
        os.makedirs(log_dir, exist_ok=True)

    def start(self, name: str, argv: list[str], env: dict | None = None):
        log = open(os.path.join(self.log_dir, f"{name}.log"), "w")
        full_env = dict(os.environ)
        full_env.update(env or {})
        p = subprocess.Popen([sys.executable, os.path.abspath(__file__)]
                             + argv, stdout=log, stderr=subprocess.STDOUT,
                             env=full_env, cwd=ROOT)
        p._smoke = (name, log, time.perf_counter())
        self.live.append(p)
        return p

    def wait(self, p, timeout: float) -> tuple[float, str]:
        name, log, t0 = p._smoke
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rc = "timeout"
        dt = time.perf_counter() - t0
        log.close()
        self.live.remove(p)
        with open(log.name) as fh:
            text = fh.read()
        for line in text.splitlines():
            if line.startswith("[smoke]"):
                print(line, flush=True)
        if rc != 0:
            sys.stderr.write(text[-8000:])
            raise RuntimeError(f"{name} failed ({rc}) after {dt:.1f}s; "
                               f"log {log.name}")
        return dt, text

    def run(self, name, argv, timeout, env=None):
        return self.wait(self.start(name, argv, env), timeout)

    def stop_all(self) -> None:
        for p in self.live:
            p.kill()
            p.wait()
        self.live.clear()


def program_lines(text: str, keys: tuple[str, ...]) -> list[str]:
    return [ln.strip() for ln in text.splitlines()
            if any(k in ln for k in keys)]


def ensure_dataset(params: dict) -> str:
    """Generate (once) a tools/gen_big.py dataset under .smoke/."""
    d = os.path.join(WORK, "data_" + "_".join(
        f"{k}{v}" for k, v in sorted(params.items())))
    if not os.path.exists(os.path.join(d, "ready")):
        from tools.gen_big import generate

        t0 = time.perf_counter()
        generate(d, params["mb"], params["variants"], params["samples"],
                 params["depth"], params["files"], params["seed"])
        open(os.path.join(d, "ready"), "w").write("ok")
        say(f"dataset {params} generated in {time.perf_counter() - t0:.1f}s")
    return d


def check_device(kids: Children, need: int, env=None) -> dict:
    _, text = kids.run("device", ["--child", "device"], 300, env)
    dev = json.loads(next(ln[7:] for ln in text.splitlines()
                          if ln.startswith("DEVICE ")))
    require_gpu(dev["platform"], dev["count"], need)
    return dev


def construct(kids, name, data, graph, env=None, threads=4):
    dt, text = kids.run(name, [
        "--child", "cli", "construct", "-r", os.path.join(data, "ref.fa"),
        "-v", os.path.join(data, "vars.vcf.gz"), "--save-graph", graph,
        "-t", str(threads)], 900, env)
    for ln in program_lines(text, ("aggregation:", "Counting Bloom Filter",
                                   "k-mers present", "Real time")):
        say(f"b: {name}: {ln}")
    say(f"b: {name}: {dt:.1f}s wall")
    return text


def genotype(kids, name, data, graph, out_dir, extra=(), env=None,
             timeout=900):
    dt, text = kids.run(name, [
        "--child", "cli", "genotype", "--load-graph", graph,
        "-s", os.path.join(data, "samples.cfg"), "--out-dir", out_dir,
        *extra], timeout, env)
    for ln in program_lines(text, ("phase timing", "engine timing",
                                   "count timing", "native FASTQ reader",
                                   "counting hash-range", "large-table",
                                   "window-sharded", "Real time")):
        say(f"b: {name}: {ln}")
    say(f"b: {name}: {dt:.1f}s wall")
    return os.path.join(out_dir, "S1.varigraph.vcf.gz")


def one_card(kids: Children) -> dict:
    dev = check_device(kids, 1)
    say(f"a: device {dev}")

    data = ensure_dataset(E2E_DATA)
    run = os.path.join(WORK, "run_1card")
    os.makedirs(run, exist_ok=True)
    graph = os.path.join(run, "graph.vgt")
    counts = os.path.join(run, "counts.npz")
    construct(kids, "construct", data, graph)
    vcf = genotype(kids, "genotype", data, graph, os.path.join(run, "gpu"),
                   ("--save-counts", counts))
    mw, nw, mn, nn, miss = truth_check(vcf, os.path.join(data, "truth.npz"))
    say(f"b: GT vs truth: {mw}/{nw} = {mw / max(nw, 1):.4f} on written "
        f"sites; {mn}/{nn} = {mn / max(nn, 1):.4f} of non-ref truth sites "
        f"(missing {miss})")
    if mw / max(nw, 1) < GT_MIN:
        raise AssertionError(f"GT vs truth below {GT_MIN}")

    # phase d's CPU re-scoring runs beside the GPU kernel child (phases c
    # and d); it never touches the card
    cpu = kids.start("genotype_cpu", [
        "--child", "cli", "genotype", "--load-graph", graph,
        "-s", os.path.join(data, "samples.cfg"), "--load-counts", counts,
        "--out-dir", os.path.join(run, "cpu")],
        {"JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": ""})
    kids.run("kernels", ["--child", "kernels"], 900)
    dt, text = kids.wait(cpu, 900)
    for ln in program_lines(text, ("phase timing: scoring", "engine timing")):
        say(f"d: genotype_cpu: {ln}")
    same, union = written_site_agreement(
        vcf, os.path.join(run, "cpu", "S1.varigraph.vcf.gz"))
    say(f"d: GPU vs CPU scoring: identical GT on {same}/{union} = "
        f"{same / max(union, 1):.5f} of written sites ({dt:.1f}s CPU child)")
    if same / max(union, 1) < GPU_CPU_GT_MIN:
        raise AssertionError(f"GPU vs CPU GT agreement below "
                             f"{GPU_CPU_GT_MIN}")
    return dev


def table_arrays(graph: str) -> dict:
    import numpy as np

    z = np.load(graph)
    return {k: z[k] for k in ("tbl_keys", "tbl_freq", "tbl_bits",
                              "tbl_refflag")}


def four_cards(kids: Children) -> dict:
    dev = check_device(kids, 4)
    say(f"a: device {dev}")
    data = ensure_dataset(MESH_DATA)
    run = os.path.join(WORK, "run_4cards")
    os.makedirs(run, exist_ok=True)
    one = {"CUDA_VISIBLE_DEVICES": "0"}
    g1, g4 = os.path.join(run, "graph1.vgt"), os.path.join(run, "graph4.vgt")
    construct(kids, "construct_1card", data, g1, one)
    text = construct(kids, "construct_4cards", data, g4,
                     {"VARIGRAPH_CBF_SHARD_MIN": "1"})
    if "sharded across 4 devices" not in text:
        raise AssertionError("the four-card construct did not shard the CBF")
    t1, t4 = table_arrays(g1), table_arrays(g4)
    for k in t1:
        if t1[k].shape != t4[k].shape or t1[k].tobytes() != t4[k].tobytes():
            raise AssertionError(f"four-card table differs from the one-card "
                                 f"table in {k}")
    say(f"4: tables byte-identical ({len(t1['tbl_keys'])} keys; "
        f"keys, freq, hap bits, ref flags)")

    v1 = genotype(kids, "genotype_1card", data, g1, os.path.join(run, "one"),
                  ("--mesh-devices", "1"), one)
    v4 = genotype(kids, "genotype_4cards", data, g1,
                  os.path.join(run, "four"), ("--mesh-devices", "4"),
                  {"VARIGRAPH_SMALL_TABLE_MAX_KEYS": "0"})
    same, union = written_site_agreement(v1, v4)
    say(f"4: GT identical on {same}/{union} written sites")
    if same != union:
        raise AssertionError("four-card GT differs from the one-card GT")
    return dev


CHILDREN = {"device": child_device, "kernels": child_kernels}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:
        mode, rest = argv[1], argv[2:]
        if mode == "cli":
            child_cli(rest)
        else:
            CHILDREN[mode]()
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)

    if importlib.util.find_spec("varigraph_tpu") is None:
        raise RuntimeError("run chip_smoke.py from the repository root")
    print(card_info(), flush=True)
    t0 = time.perf_counter()
    kids = Children(os.path.join(WORK, "logs"))
    try:
        dev = four_cards(kids) if args.four_cards else one_card(kids)
    finally:
        kids.stop_all()
    say(f"all phases passed in {time.perf_counter() - t0:.1f}s")
    print(card_info(), flush=True)
    print(contract_line(dev["platform"], dev["kind"], dev["count"]),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
