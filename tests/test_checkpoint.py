"""Counted-reads checkpoint (save/load) and debug-trace smoke test."""

import os

import numpy as np
import pytest

from varigraph_tpu.config import VarigraphConfig
from varigraph_tpu.index.build import construct_graph_index
from varigraph_tpu.genotype.counting import count_reads
from varigraph_tpu.genotype.engine_np import graph2node
from varigraph_tpu.genotype.pipeline import (
    genotype_one_sample, load_counts, save_counts,
)

from data_gen import generate_dataset


@pytest.fixture(scope="module")
def ready(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ckpt"))
    paths, truth = generate_dataset(
        out, seed=41, chrom_lens={"chr1": 3000}, n_variants=10,
        samples=("S1",), depth=25.0,
    )
    cfg = VarigraphConfig(ref_file=paths["ref"], vcf_file=paths["vcf"],
                          kmer_len=27, seed=0)
    gi = construct_graph_index(cfg)
    graph2node(gi)
    return paths, gi, out


def test_counts_checkpoint_roundtrip(ready):
    paths, gi, out = ready
    cfg = VarigraphConfig(kmer_len=27, vcf_ploidy=2, seed=0)
    rb = count_reads(gi.table, [paths["fq"]], 27, cfg.read_batch_size,
                     cfg.max_read_len)
    ck = os.path.join(out, "counts.npz")
    save_counts(gi, ck, rb)
    before = gi.table.cov_u8().copy()
    gi.table.reset_cov()
    assert gi.table.cov_u8().sum() == 0
    rb2 = load_counts(gi, ck)
    assert rb2 == rb
    assert (gi.table.cov_u8() == before).all()


def test_counts_checkpoint_mismatch_rejected(ready, tmp_path):
    paths, gi, out = ready
    import numpy as np
    ck = str(tmp_path / "bad.npz")
    with open(ck, "wb") as fh:
        np.savez_compressed(fh, cov=np.zeros(3, np.uint32),
                            keys=np.zeros(1, np.uint64),
                            read_base=np.uint64(1))
    with pytest.raises(ValueError):
        load_counts(gi, ck)


def test_counts_checkpoint_other_keys_rejected(ready, tmp_path, monkeypatch):
    """A checkpoint of a same-size table with different keys is refused."""
    paths, gi, out = ready
    ck = str(tmp_path / "counts.npz")
    save_counts(gi, ck, 7)
    assert load_counts(gi, ck) == 7
    other = gi.table.keys_np().copy()
    other[-1] += np.uint64(1 << 8)
    monkeypatch.setattr(gi.table, "_keys_np", other)
    with pytest.raises(ValueError, match="keys differ"):
        load_counts(gi, ck)


def test_debug_traces(ready, capsys):
    paths, gi, out = ready
    cfg = VarigraphConfig(kmer_len=27, vcf_ploidy=2, seed=0, debug=True,
                          engine="jax")
    vcf = genotype_one_sample(gi, cfg, "S1", [paths["fq"]],
                              out_dir=os.path.join(out, "dbg"))
    captured = capsys.readouterr()
    assert cfg.engine == "np"  # debug switches to the oracle engine
    assert "observableStates:" in captured.err
    assert "Alpha:" in captured.err
    assert "Beta:" in captured.err
    assert os.path.exists(vcf)
