"""CPU tests of chip_smoke.py's helpers (the script itself needs a GPU)."""

import gzip
import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke as cs  # noqa: E402


@pytest.mark.parametrize("platform,count,need", [
    ("cpu", 8, 1), ("cuda", 1, 1), ("gpu", 1, 4), ("gpu", 0, 1),
])
def test_require_gpu_rejects(platform, count, need):
    with pytest.raises(RuntimeError):
        cs.require_gpu(platform, count, need)


def test_require_gpu_accepts():
    cs.require_gpu("gpu", 1)
    cs.require_gpu("gpu", 4, need=4)


def test_contract_line_has_exactly_the_contract_keys():
    line = cs.contract_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert "\n" not in line
    got = json.loads(line)
    assert got == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def _vcf(path, rows):
    with gzip.open(path, "wt") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n")
        for chrom, pos, gt in rows:
            fh.write(f"{chrom}\t{pos}\t.\tA\tC\t50\tPASS\t.\tGT:GQ\t{gt}:50\n")


def test_gt_compare_helpers(tmp_path):
    a, b = str(tmp_path / "a.vcf.gz"), str(tmp_path / "b.vcf.gz")
    _vcf(a, [("chr1", 10, "0/1"), ("chr1", 20, "1/1"), ("chr1", 30, "1/0"),
             ("chr2", 5, "./.")])
    _vcf(b, [("chr1", 10, "1/0"), ("chr1", 20, "0/1"), ("chr1", 40, "1/1")])
    # phased order is ignored, uncalled GTs are skipped; the union is
    # {chr1:10, 20, 30, 40} and only chr1:10 agrees
    assert cs.written_site_agreement(a, b) == (1, 4)
    assert cs.written_site_agreement(a, a) == (3, 3)

    truth = str(tmp_path / "truth.npz")
    np.savez(truth, chr1_pos=np.array([10, 20, 30, 50]),
             chr1_gt0=np.array([1, 1, 0, 1]), chr1_gt1=np.array([0, 0, 0, 1]))
    # written sites known to the truth: 10 (match), 20 (1/1 vs 0/1), 30
    # (0/1 vs 0/0); non-ref truth: 10, 20, 50 (missing)
    assert cs.truth_check(a, truth) == (1, 3, 1, 3, 1)
