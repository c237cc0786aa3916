"""Compare two varigraph VCF outputs (GT concordance + field drift), and
each against the simulated truth when a truth.npz is given.

Usage: python tools/vcf_compare.py A.vcf.gz B.vcf.gz [truth.npz]
"""
import gzip
import sys

import numpy as np


def read_calls(path):
    """{(chrom, pos): sorted GT tuple} for every record with a called GT."""
    calls = {}
    with gzip.open(path, "rt") as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            gt = f[9].split(":")[0]
            if "." in gt:
                continue
            calls[(f[0], int(f[1]))] = tuple(sorted(int(g) for g in gt.split("/")))
    return calls


def read_truth(path):
    truth = np.load(path)
    chroms = sorted({k.rsplit("_", 1)[0] for k in truth.files})
    out = {}
    for c in chroms:
        for p, a, b in zip(truth[f"{c}_pos"], truth[f"{c}_gt0"], truth[f"{c}_gt1"]):
            out[(c, int(p))] = tuple(sorted((int(a), int(b))))
    return out


def truth_concordance(calls, truth):
    """(match_written, n_written, match_nonref, n_nonref, missing_nonref).

    Written sites are the called records whose position the truth knows;
    the non-ref figures count every truth site that is not 0/0."""
    written = [k for k in calls if k in truth]
    match_written = sum(1 for k in written if calls[k] == truth[k])
    n_nonref = match_nonref = missing = 0
    for key, exp in truth.items():
        if exp == (0, 0):
            continue
        n_nonref += 1
        got = calls.get(key)
        if got is None:
            missing += 1
        elif got == exp:
            match_nonref += 1
    return match_written, len(written), match_nonref, n_nonref, missing


def gt_agreement(a, b):
    """(identical, union): sites whose GT is the same in both call sets,
    over the sites called in either."""
    keys = set(a) | set(b)
    same = sum(1 for k in keys if a.get(k) is not None and a.get(k) == b.get(k))
    return same, len(keys)


def vs_truth(name, calls, truth):
    mw, nw, mn, nn, miss = truth_concordance(calls, truth)
    print(f"{name}: {mw}/{nw} = {mw/max(nw,1):.4f} on written sites; "
          f"{mn}/{nn} = {mn/max(nn,1):.4f} vs truth non-ref (missing {miss})")


def main(argv):
    a = read_calls(argv[1])
    b = read_calls(argv[2])
    both = sum(1 for k in set(a) | set(b) if k in a and k in b)
    same, _ = gt_agreement(a, b)
    print(f"sites: A {len(a)}, B {len(b)}, shared {both}")
    print(f"GT identical on shared: {same}/{both} = {same/max(both,1):.4f}")
    if len(argv) > 3:
        truth = read_truth(argv[3])
        vs_truth("A", a, truth)
        vs_truth("B", b, truth)


if __name__ == "__main__":
    main(sys.argv)
