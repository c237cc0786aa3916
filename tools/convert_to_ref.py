"""Convert a .vgt graph to the reference binary's graph.bin format.

Usage: python tools/convert_to_ref.py GRAPH.vgt OUT.bin

Runs on the CPU backend: the conversion only needs
host views of the table plus the node/VCF structures.  Used to hand the
reference binary a graph built by this framework for matched-regime
baseline measurements (SURVEY.md section 6; reference load_index,
/root/reference/src/construct_index.cpp:911-1105).
"""

import os
import resource
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

from varigraph_tpu.index.interop import save_reference_graph_bin
from varigraph_tpu.index.serialize import load_graph


def main():
    src, dst = sys.argv[1], sys.argv[2]
    t0 = time.time()
    gi = load_graph(src)
    t1 = time.time()
    print(f"[convert] load {t1 - t0:.1f}s, rss "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.1f} GB",
          flush=True)
    save_reference_graph_bin(gi, dst)
    print(f"[convert] write {time.time() - t1:.1f}s, rss "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.1f} GB, "
          f"size {os.path.getsize(dst) / 1e9:.2f} GB", flush=True)


if __name__ == "__main__":
    main()
