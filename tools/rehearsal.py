"""Genome-scale dress rehearsal: construct + genotype end-to-end with
per-phase wall-clock and peak-RSS reporting, GT-checked against the
simulated truth.

Usage:
  python tools/rehearsal.py DATA_DIR [--graph cached.vgt] [--skip-construct]

DATA_DIR must hold a tools/gen_big.py dataset (ref.fa, vars.vcf.gz,
S1_*.fq.gz, samples.cfg, truth.npz).  It runs in one process; on a GPU
machine chip_smoke.py runs the same path through the CLI.
"""

from __future__ import annotations

import argparse
import glob
import os
import resource
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("data_dir")
    ap.add_argument("--graph", default=None,
                    help="graph path (default DATA_DIR/graph.vgt)")
    ap.add_argument("--skip-construct", action="store_true")
    ap.add_argument("--construct-only", action="store_true")
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--engine", default="jax")
    args = ap.parse_args()
    d = args.data_dir
    gpath = args.graph or os.path.join(d, "graph.vgt")
    fqs = sorted(glob.glob(os.path.join(d, "S1_*.fq.gz")))
    assert fqs, f"no S1_*.fq.gz under {d}"

    from varigraph_tpu.config import VarigraphConfig
    from varigraph_tpu.utils.log import log

    phases = {}

    if not args.skip_construct:
        from varigraph_tpu.index.build import construct_graph_index
        from varigraph_tpu.index.serialize import save_graph

        cfg = VarigraphConfig(
            ref_file=os.path.join(d, "ref.fa"),
            vcf_file=os.path.join(d, "vars.vcf.gz"),
            kmer_len=27, seed=0, threads=args.threads,
        )
        t0 = time.perf_counter()
        gi = construct_graph_index(cfg)
        phases["construct"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        save_graph(gi, gpath)
        phases["save_graph"] = time.perf_counter() - t0
        log(f"[rehearsal] construct {phases['construct']:.1f}s, "
            f"save {phases['save_graph']:.1f}s, RSS {rss_gb():.2f} GB")
        if args.construct_only:
            print("\n=== rehearsal summary (construct only) ===")
            for k, v in phases.items():
                print(f"  {k:16s} {v:9.1f} s")
            print(f"  peak RSS        {rss_gb():9.2f} GB")
            print(f"  table size      {gi.table.size}")
            print("  RESULT: PASS (construct only)")
            return 0
        del gi

    from varigraph_tpu.genotype.engine_np import graph2node
    from varigraph_tpu.genotype.pipeline import genotype_one_sample
    from varigraph_tpu.index.serialize import load_graph

    t0 = time.perf_counter()
    gi = load_graph(gpath)
    phases["load_graph"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    graph2node(gi)
    phases["graph2node"] = time.perf_counter() - t0

    gcfg = VarigraphConfig(kmer_len=gi.kmer_len, vcf_ploidy=gi.vcf_ploidy,
                           engine=args.engine, seed=0)
    t0 = time.perf_counter()
    vcf_out = genotype_one_sample(gi, gcfg, "S1", fqs, out_dir=d)
    phases["genotype_total"] = time.perf_counter() - t0

    # ---- concordance vs truth ----
    import gzip

    truth = np.load(os.path.join(d, "truth.npz"))
    chroms = sorted({k.rsplit("_", 1)[0] for k in truth.files})
    expected = {}
    for c in chroms:
        pos = truth[f"{c}_pos"]
        g0 = truth[f"{c}_gt0"]
        g1 = truth[f"{c}_gt1"]
        for p, a, b in zip(pos, g0, g1):
            expected[(c, int(p))] = sorted((int(a), int(b)))
    called = {}
    with gzip.open(vcf_out, "rt") as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            gt = f[9].split(":")[0]
            if "." in gt:
                continue
            called[(f[0], int(f[1]))] = sorted(int(g) for g in gt.split("/"))
    n_eval = n_match = n_missing = 0
    for key, exp in expected.items():
        if exp == [0, 0]:
            continue
        n_eval += 1
        got = called.get(key)
        if got is None:
            n_missing += 1
        elif got == exp:
            n_match += 1
    conc = n_match / max(n_eval, 1)

    print("\n=== rehearsal summary ===")
    for k, v in phases.items():
        print(f"  {k:16s} {v:9.1f} s")
    print(f"  peak RSS        {rss_gb():9.2f} GB")
    print(f"  table size      {gi.table.size}")
    print(f"  GT concordance  {n_match}/{n_eval} = {conc:.4f} "
          f"(missing {n_missing})")
    ok = conc >= 0.95
    print(f"  RESULT: {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
