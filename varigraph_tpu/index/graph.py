"""Genome-graph model and VCF -> graph construction (host side).

Behavioral port of reference ConstructIndex::construct
(src/construct_index.cpp:188-473), vcf_construct (:507-581), gt_split
(:1616-1643) and find_node_up_down_seq (:1266-1549).  The graph is a
node-per-variant model: nodes ordered by start position per chromosome,
"edges" are implicit adjacency; reference filler nodes carry the sequence
between variants.

This layer is deliberately host Python: it is pointer-chasing text work.  The
compute-heavy per-node k-mer indexing lives in index/build.py and runs on
device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils.log import log


class RefSpan:
    """Lazy string view of a backing sequence slice [lo, hi).

    Filler nodes carry the whole inter-variant reference sequence as
    seqs[0]; storing it as a str would duplicate ~the entire genome on top
    of fasta_map (~1 GB of extra RSS at 1 Gbp, ~3 GB at human scale).  A
    RefSpan keeps (backing, lo, hi) -- the backing is a chromosome str at
    construct time or the mmap-able seq blob bytes at load time -- and
    materializes only the small slices the graph walker actually reads
    (typically <= k-1 bases per visit).

    Implements exactly the str operations the walker
    (find_node_up_down_seq), serializers, and engines use: len/bool,
    indexing/slicing, str(), +/radd, ==, hash, encode, upper.
    INTENTIONALLY UNSUPPORTED (raise AttributeError): startswith, count,
    replace, find, split, iteration protocols beyond __getitem__.  Note
    `in`/`for` fall back to per-char __getitem__ (correct but quadratic)
    and ==/hash materialize the whole slice -- if a new consumer needs
    those on genome-scale fillers, add a dedicated method instead."""

    __slots__ = ("_b", "_lo", "_hi")

    def __init__(self, backing, lo: int, hi: int):
        self._b = backing
        self._lo = lo
        self._hi = max(lo, hi)

    def __len__(self) -> int:
        return self._hi - self._lo

    def __bool__(self) -> bool:
        return self._hi > self._lo

    def _materialize(self, lo: int, hi: int) -> str:
        piece = self._b[lo:hi]
        return piece if isinstance(piece, str) else piece.decode("ascii")

    def __str__(self) -> str:
        return self._materialize(self._lo, self._hi)

    def __getitem__(self, idx) -> str:
        n = self._hi - self._lo
        if isinstance(idx, slice):
            lo, hi, step = idx.indices(n)
            if step != 1:
                return self._materialize(self._lo, self._hi)[idx]
            return self._materialize(self._lo + lo, self._lo + hi)
        if idx < 0:
            idx += n
        if not 0 <= idx < n:
            raise IndexError(idx)
        return self._materialize(self._lo + idx, self._lo + idx + 1)

    def __add__(self, other) -> str:
        return str(self) + str(other)

    def __radd__(self, other) -> str:
        return str(other) + str(self)

    def __eq__(self, other) -> bool:
        if isinstance(other, (str, RefSpan)):
            return len(self) == len(other) and str(self) == str(other)
        return NotImplemented

    def __hash__(self):
        return hash(str(self))

    def __repr__(self) -> str:
        return f"RefSpan({len(self)} bases)"

    def encode(self, encoding: str = "ascii") -> bytes:
        b = self._b[self._lo:self._hi]
        return b.encode(encoding) if isinstance(b, str) else bytes(b)

    def upper(self) -> str:
        return str(self).upper()


@dataclass
class Node:
    """One graph node (reference nodeSrt, include/construct_index.hpp:105-121).

    seqs[0] is the REF allele (or the filler sequence); hap_gt[h] is the
    allele index haplotype h carries (0 = REF).  Filler nodes have
    hap_gt == [0].  After GenomeGraph.finalize(), hap_gt is a numpy uint16
    row view into the per-chromosome GT matrix (same indexing/len semantics;
    ~15x less host RAM than Python int lists at genome scale).
    """
    start: int  # 1-based
    seqs: list[str] = field(default_factory=list)
    hap_gt: object = field(default_factory=list)
    # filled by the indexing phase:
    kmer_hashes: list[int] = field(default_factory=list)  # encoded k-mers
    # per-kmer haplotype-presence bitmask, packed uint8 [n_kmers, ceil(H/8)]
    local_bits: object = field(default_factory=list)

    @property
    def is_variant(self) -> bool:
        return len(self.hap_gt) > 1

    @property
    def end(self) -> int:
        return self.start + len(self.seqs[0]) - 1


class GenomeGraph:
    """Per-chromosome ordered node collections.

    finalize() additionally builds per-chromosome numpy views of the node
    metadata the genotype engine gathers per window (starts, ends, GT
    matrix): the per-node Python loops over these were ~30% of scoring time
    at the 100 Mb scale and linear in node count (VERDICT r2 item 4).
    """

    def __init__(self):
        self._maps: dict[str, dict[int, Node]] = {}
        self.starts: dict[str, list[int]] = {}
        self.nodes: dict[str, list[Node]] = {}
        # per-chromosome dense metadata (built by finalize)
        self.starts_np: dict[str, np.ndarray] = {}
        self.ends_np: dict[str, np.ndarray] = {}
        self.gt_mat: dict[str, np.ndarray] = {}   # [n, width] u16, 0-padded
        self.gt_len: dict[str, np.ndarray] = {}   # [n] int32
        # per-chromosome CSR of node k-mer data: raw hashes as produced by
        # indexing (kmer_csr) and table-resolved <=128-per-node slices
        # (tbl_csr, built by genotype.engine_np.graph2node).  Node attributes
        # (kmer_hashes / local_bits / table_idx / local_packed) are views
        # into these flats; the engines gather windows by slicing offsets
        # instead of concatenating per-node Python lists (VERDICT r2 item 4).
        self.kmer_csr: dict[str, tuple] = {}   # (off[n+1], kh u64, lb u8[.,B])
        self.tbl_csr: dict[str, tuple] = {}    # (off[n+1], idx i64, lp u8[.,B])

    def get_or_create(self, chrom: str, start: int) -> Node:
        chrom_map = self._maps.setdefault(chrom, {})
        node = chrom_map.get(start)
        if node is None:
            node = Node(start=start)
            chrom_map[start] = node
        return node

    def finalize(self) -> None:
        """Sort nodes by start per chromosome (std::map iteration order) and
        densify node metadata.  Each node's hap_gt becomes a row view into
        gt_mat (zero-padded: a missing haplotype's GT reads as 0 = REF,
        matching the engines' out-of-range default)."""
        self.starts = {}
        self.nodes = {}
        for chrom, cmap in self._maps.items():
            items = sorted(cmap.items())
            self.starts[chrom] = [s for s, _ in items]
            self.nodes[chrom] = [n for _, n in items]
            nodes = self.nodes[chrom]
            n = len(nodes)
            lens = np.fromiter((len(nd.hap_gt) for nd in nodes), np.int32, n)
            width = int(lens.max()) if n else 0
            mat = np.zeros((n, width), np.uint16)
            for i, nd in enumerate(nodes):
                li = lens[i]
                if li:
                    mat[i, :li] = nd.hap_gt
                nd.hap_gt = mat[i, :li]
            self.gt_mat[chrom] = mat
            self.gt_len[chrom] = lens
            self.starts_np[chrom] = np.fromiter(
                (nd.start for nd in nodes), np.int64, n
            )
            self.ends_np[chrom] = self.starts_np[chrom] + np.fromiter(
                (len(nd.seqs[0]) for nd in nodes), np.int64, n
            ) - 1

    def build_kmer_csr(self, nbytes: int) -> None:
        """Collect each node's kmer_hashes/local_bits into one flat array
        per chromosome and re-home the node attributes as views into it.
        Callers that already hold the flat layout (serialize.load_graph)
        fill self.kmer_csr directly instead."""
        for chrom, nodes in self.nodes.items():
            n = len(nodes)
            lens = np.fromiter(
                (len(nd.kmer_hashes) for nd in nodes), np.int64, n
            )
            off = np.zeros(n + 1, np.int64)
            np.cumsum(lens, out=off[1:])
            if off[-1]:
                kh = np.concatenate(
                    [np.asarray(nd.kmer_hashes, np.uint64)
                     for nd, li in zip(nodes, lens) if li]
                )
                lb = np.concatenate(
                    [np.asarray(nd.local_bits, np.uint8).reshape(li, -1)
                     for nd, li in zip(nodes, lens) if li]
                )
            else:
                kh = np.empty(0, np.uint64)
                lb = np.zeros((0, nbytes), np.uint8)
            self.kmer_csr[chrom] = (off, kh, lb)
            for i, nd in enumerate(nodes):
                nd.kmer_hashes = kh[off[i]:off[i + 1]]
                nd.local_bits = lb[off[i]:off[i + 1]]

    def gt_submatrix(self, chrom: str, node_idx: np.ndarray,
                     haps) -> np.ndarray:
        """[len(node_idx), len(haps)] int64 GT gather with 0 (REF) for
        haplotypes beyond a node's GT vector."""
        mat = self.gt_mat[chrom]
        uh = np.asarray(haps, np.int64)
        out = np.zeros((len(node_idx), len(uh)), np.int64)
        valid = uh < mat.shape[1]
        if valid.any() and len(node_idx):
            out[:, valid] = mat[np.ix_(node_idx, uh[valid])]
        return out

    @property
    def chroms(self) -> list[str]:
        return sorted(self.nodes.keys())


def gt_split(gt_txt: str) -> list[str]:
    """Split a GT field (reference construct_index.cpp:1616-1643)."""
    if gt_txt == ".":
        return []
    if "/" in gt_txt:
        return gt_txt.split("/")
    if "|" in gt_txt:
        return gt_txt.split("|")
    try:
        int(gt_txt)
    except ValueError:
        raise ValueError(f"GT is not separated by '/' or '|' -> {gt_txt}")
    log(f"Warning: sample has only one genotype, attempting to correct to diploid -> {gt_txt}")
    return [gt_txt]


@dataclass
class VariantStats:
    snp: int = 0
    indel: int = 0
    ins: int = 0
    dele: int = 0
    inv: int = 0
    dup: int = 0
    other: int = 0

    def total(self) -> int:
        return self.snp + self.indel + self.ins + self.dele + self.inv + self.dup + self.other


def classify_variant(ref_len: int, qry_len: int, stats: VariantStats) -> None:
    """Length-heuristic variant classification (construct_index.cpp:519-537)."""
    sv_len = qry_len - ref_len
    length_ratio = qry_len / float(ref_len) if ref_len else float("inf")
    if sv_len == 0 and ref_len == 1 and qry_len == 1:
        stats.snp += 1
    elif -49 <= sv_len <= 49 and ref_len <= 49 and qry_len <= 49:
        stats.indel += 1
    elif -2 <= sv_len <= 2 and ref_len > 49 and qry_len > 49:
        stats.inv += 1
    elif 1.8 <= length_ratio <= 2.2 and ref_len > 49 and qry_len > 49:
        stats.dup += 1
    elif sv_len < 0:
        stats.dele += 1
    elif sv_len > 0:
        stats.ins += 1
    else:
        stats.other += 1


FORMAT_HEADER_LINES = (
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
    '##FORMAT=<ID=GQ,Number=1,Type=Float,Description="Genotype quality '
    '(phred-scaled 1 - max(GPP))">\n'
    '##FORMAT=<ID=GPP,Number=1,Type=String,Description="Genotype posterior probabilities">\n'
    '##FORMAT=<ID=NAK,Number=.,Type=Float,Description="Number of allele k-mers">\n'
    '##FORMAT=<ID=CAK,Number=.,Type=Float,Description="Coverage of allele k-mers">\n'
    '##FORMAT=<ID=UK,Number=1,Type=Integer,Description="Total number of unique kmers, '
    'capped at 255">\n'
)


def build_graph_from_vcf(
    vcf_lines,
    fasta_map: dict[str, str],
    vcf_ploidy: int,
):
    """Stream VCF lines into the graph + VCF mirror.

    Port of ConstructIndex::construct (src/construct_index.cpp:188-473).

    Args:
      vcf_lines: iterable of text lines (already decompressed).
      fasta_map: chromosome -> sequence.
      vcf_ploidy: --vcf-ploidy.

    Returns (graph, vcf_head, vcf_info, hap_map, stats, graph_base_num_extra)
      vcf_info: chrom -> {start: [columns...]}
      hap_map: list of haplotype names, index 0 = "reference"
    """
    graph = GenomeGraph()
    vcf_head_parts: list[str] = []
    vcf_info: dict[str, dict[int, list[str]]] = {}
    hap_map: list[str] = ["reference"]
    stats = VariantStats()
    graph_base_extra = 0  # ALT bases added beyond the reference genome

    tmp_ref_start = 0
    tmp_ref_end = 0
    tmp_chromosome = ""

    for line in vcf_lines:
        line = line.rstrip("\n")
        if not line:
            continue
        if "##FORMAT" in line:
            continue
        if "#" in line and "#CHROM" not in line:
            vcf_head_parts.append(line + "\n")
            continue

        line_vec = line.split()
        if len(line_vec) < 10:
            raise ValueError(
                f"Number of columns in the VCF file is less than 10. "
                f"Current column count: {len(line_vec)}"
            )

        if "#CHROM" in line:
            vcf_head_parts.append(FORMAT_HEADER_LINES)
            vcf_head_parts.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT")
            for i in range(9, len(line_vec)):
                for _ in range(vcf_ploidy):
                    hap_map.append(line_vec[i])
                    if len(hap_map) > 0xFFFF:
                        raise ValueError(
                            "The number of haplotypes exceeds the maximum limit of 65535."
                        )
            continue

        chromosome = line_vec[0]
        ref_start = int(line_vec[1])
        ref_seq = line_vec[3]
        ref_len = len(ref_seq)
        ref_end = ref_start + ref_len - 1
        qry_seq_vec = line_vec[4].split(",")

        format_vec = line_vec[8].rstrip("\n").split(":")
        try:
            gt_index = format_vec.index("GT")
        except ValueError:
            raise ValueError(f"Genotype (GT) information is missing in FORMAT: {line}")

        # --- VCF mirror + stats (vcf_construct, runs BEFORE the skip checks,
        # matching construct_index.cpp:281 before :298) ---
        # Convention: the 9 fixed columns are separate list elements; ALL
        # per-sample GT strings are ONE tab-joined element.  At 500k sites x
        # 100 samples, per-string elements cost ~2.5 GB of Python object
        # overhead; everything that consumes the mirror either reads columns
        # 0-8 or re-joins/re-splits on tabs (serialize, interop).
        # Duplicate-site records append ADDITIONAL 10-element blocks to the
        # same start's list; note that serialize.load_graph folds everything
        # past element 9 into ONE tab-joined element on load (element
        # boundaries differ in-memory vs loaded, content is identical after
        # a tab re-split) -- any future consumer indexing elements 9+ must
        # re-split on tabs rather than trust block boundaries.
        info_list = vcf_info.setdefault(chromosome, {}).setdefault(ref_start, [])
        for qry in qry_seq_vec:
            classify_variant(ref_len, len(qry), stats)
        info_list.extend(line_vec[:9])
        gt_txts = []
        for i in range(9, len(line_vec)):
            gt_vec = gt_split(line_vec[i].split(":")[gt_index])
            if not gt_vec:
                gt_txt = "|".join(["0"] * vcf_ploidy)
            elif len(gt_vec) >= vcf_ploidy:
                gt_txt = "|".join(gt_vec[:vcf_ploidy])
            else:
                gt_txt = "|".join(gt_vec) + "|0" * (vcf_ploidy - len(gt_vec))
            gt_txts.append(gt_txt)
        info_list.append("\t".join(gt_txts))

        # --- graph construction ---
        if chromosome not in fasta_map:
            raise ValueError(f"Chromosome '{chromosome}' not found in reference genome.")
        fasta_seq = fasta_map[chromosome]

        if chromosome != tmp_chromosome:
            tmp_ref_start = 0
        if tmp_ref_start == ref_start:
            log(f"Warning: Multiple variants detected, skipping this site -> "
                f"{chromosome} {ref_start}")
            continue
        elif tmp_ref_start > ref_start:
            log(f"Warning: Variants are unsorted, skipping this site -> "
                f"{chromosome} {tmp_ref_start}>{ref_start}")
            continue

        true_ref_seq = fasta_seq[ref_start - 1 : ref_start - 1 + ref_len]
        if true_ref_seq != ref_seq:
            log("Warning: Sequence discrepancy detected between reference genome and "
                f"VCF. Replacing with sequence from reference genome -> "
                f"{chromosome}\t{ref_start}")
            ref_seq = true_ref_seq

        # filler sequences are RefSpan views into the chromosome string --
        # str copies would duplicate ~the whole genome (VERDICT r3 weak #5)
        if chromosome != tmp_chromosome:
            # tail filler of the previous chromosome
            if tmp_ref_end > 0 and tmp_ref_end < len(fasta_map[tmp_chromosome]):
                pre_start = tmp_ref_end + 1
                pre_end = len(fasta_map[tmp_chromosome])
                node = graph.get_or_create(tmp_chromosome, pre_start)
                node.seqs.append(
                    RefSpan(fasta_map[tmp_chromosome], pre_start - 1, pre_end)
                )
                node.hap_gt.append(0)
            # head filler of the new chromosome
            if ref_start > 1:
                node = graph.get_or_create(chromosome, 1)
                node.seqs.append(RefSpan(fasta_seq, 0, ref_start - 1))
                node.hap_gt.append(0)
        else:
            pre_start = tmp_ref_end + 1
            pre_end = ref_start - 1
            if pre_start <= pre_end:
                node = graph.get_or_create(chromosome, pre_start)
                node.seqs.append(RefSpan(fasta_seq, pre_start - 1, pre_end))
                node.hap_gt.append(0)

        # the variant node itself
        node = graph.get_or_create(chromosome, ref_start)
        node.seqs.append(ref_seq)
        node.hap_gt.append(0)
        node.seqs.extend(qry_seq_vec)
        graph_base_extra += sum(len(q) for q in qry_seq_vec)
        if len(node.seqs) > 0xFFFF:
            raise ValueError("The number of haplotypes exceeds the maximum limit of 65535.")

        for i in range(9, len(line_vec)):
            gt_vec = gt_split(line_vec[i].split(":")[gt_index])
            if len(gt_vec) > vcf_ploidy:
                log(f"Warning: The number of haplotypes at {chromosome}({ref_start}) "
                    "exceeds the specified parameter. Excess haplotypes have been discarded.")
                gt_vec = gt_vec[:vcf_ploidy]
            elif len(gt_vec) < vcf_ploidy:
                log(f"Warning: The number of haplotypes at {chromosome}({ref_start}) "
                    "is less than the specified parameter. Filling the deficit with zeros.")
                gt_vec = gt_vec + ["0"] * (vcf_ploidy - len(gt_vec))
            for g in gt_vec:
                node.hap_gt.append(0 if g == "." else int(g))

        tmp_ref_start = ref_start
        tmp_ref_end = ref_end
        tmp_chromosome = chromosome

    # tail filler of the last chromosome
    if tmp_chromosome and tmp_ref_end < len(fasta_map[tmp_chromosome]):
        pre_start = tmp_ref_end + 1
        node = graph.get_or_create(tmp_chromosome, pre_start)
        node.seqs.append(
            RefSpan(fasta_map[tmp_chromosome], pre_start - 1,
                    len(fasta_map[tmp_chromosome]))
        )
        node.hap_gt.append(0)

    graph.finalize()

    log(f"Parsed {stats.total()} alternative alleles ...")
    log(f"SNP: {stats.snp}  InDels: {stats.indel}  Insertion: {stats.ins}  "
        f"Deletion: {stats.dele}  Inversion: {stats.inv}  Duplication: {stats.dup}  "
        f"Other: {stats.other}")

    return graph, "".join(vcf_head_parts), vcf_info, hap_map, stats, graph_base_extra


def find_node_up_down_seq(
    haplotype: int,
    alt_gt: int,
    alt_seq: str,
    seq_len: int,
    node_idx: int,
    starts: list[int],
    nodes: list[Node],
    trace_up: list | None = None,
    trace_down: list | None = None,
) -> tuple[str, str, str]:
    """Walk neighbor nodes to collect the haplotype's sequence up to seq_len
    bases up- and downstream of a node.

    Behavioral port of reference construct_index.cpp:1266-1549, including the
    nested/overlapping-node truncation and retro-replacement rules (the
    comment diagrams at :1314-1322 and :1406-1428 are the spec).  Unlike the
    C++ (which mutates altSeq in place), the possibly-modified alt sequence is
    returned as the third element.

    The walk is a deterministic function of (alt_gt, alt_seq, node_idx) and
    the haplotype's GT at each *visited* node; visits are consecutive ranges
    (node_idx-1 downward, node_idx+1 upward).  When ``trace_up``/``trace_down``
    lists are supplied, the GT consulted at every visited node is appended in
    visit order, which lets callers memoize walks by GT signature (two
    haplotypes with the same GTs over the visited range yield the same walk).

    Returns (up_seq, down_seq, alt_seq).
    """
    node = nodes[node_idx]
    alt_start = node.start
    alt_end = alt_start + len(node.seqs[0]) - 1
    alt_len = len(alt_seq)

    # ---------------------------------------------------------------- upstream
    up_seq = ""
    pre_qry_len_vec = [alt_len]
    pre_gt_vec = [alt_gt]
    pre_node_start_vec = [alt_start]
    pre_node_end_vec = [alt_end]

    idx = node_idx
    while len(up_seq) < seq_len and idx != 0:
        idx -= 1
        node_start_tmp = starts[idx]
        node_tmp = nodes[idx]
        node_end_tmp = node_start_tmp + len(node_tmp.seqs[0]) - 1
        gt_tmp = node_tmp.hap_gt[haplotype] if haplotype < len(node_tmp.hap_gt) else 0
        if trace_up is not None:
            trace_up.append(gt_tmp)
        if gt_tmp >= len(node_tmp.seqs):
            raise ValueError(
                f"The node '{alt_start}' lacks sequence information for haplotype {gt_tmp}."
            )
        seq_tmp = node_tmp.seqs[gt_tmp]

        # overlapping/nested truncation (diagrams at construct_index.cpp:1314-1322)
        while pre_node_start_vec and node_end_tmp >= pre_node_start_vec[-1] and seq_tmp:
            if gt_tmp == 0:
                seq_tmp = seq_tmp[: pre_node_start_vec[-1] - node_start_tmp]
                break
            elif pre_gt_vec[-1] == 0 and up_seq:
                pre_qry_len_tmp = min(
                    node_end_tmp - pre_node_start_vec[-1] + 1, pre_qry_len_vec[-1]
                )
                up_seq = up_seq[pre_qry_len_tmp:]
                pre_qry_len_vec.pop()
                pre_gt_vec.pop()
                pre_node_start_vec.pop()
                pre_node_end_vec.pop()
                continue
            break

        if not seq_tmp:
            continue

        pre_node_start_vec.append(node_start_tmp)
        pre_node_end_vec.append(node_end_tmp)

        remaining = seq_len - len(up_seq)
        if len(seq_tmp) >= remaining:
            up_seq = seq_tmp[len(seq_tmp) - remaining :] + up_seq
            pre_qry_len_vec.append(remaining)
        else:
            up_seq = seq_tmp + up_seq
            pre_qry_len_vec.append(len(seq_tmp))
        pre_gt_vec.append(gt_tmp)

    # -------------------------------------------------------------- downstream
    down_seq = ""
    pre_qry_len_vec = [alt_len]
    pre_gt_vec = [alt_gt]
    pre_node_start_vec = [alt_start]
    pre_node_end_vec = [alt_end]
    pre_gt = alt_gt  # the down loop consults the running scalar (:1455,1493)

    idx = node_idx
    while len(down_seq) < seq_len and idx + 1 < len(nodes):
        idx += 1
        node_start_tmp = starts[idx]
        node_tmp = nodes[idx]
        node_len_tmp = len(node_tmp.seqs[0])
        node_end_tmp = node_start_tmp + node_len_tmp - 1
        gt_tmp = node_tmp.hap_gt[haplotype] if haplotype < len(node_tmp.hap_gt) else 0
        if trace_down is not None:
            trace_down.append(gt_tmp)
        if gt_tmp >= len(node_tmp.seqs):
            raise ValueError(
                f"The node '{alt_start}' lacks sequence information for haplotype {gt_tmp}."
            )
        seq_tmp = node_tmp.seqs[gt_tmp]

        # SNP-inside-deletion retro-replacement (diagrams at :1406-1428)
        if (
            alt_gt == 0
            and gt_tmp != 0
            and node_end_tmp <= alt_end
            and len(seq_tmp) == 1
            and node_len_tmp == 1
        ):
            off = node_start_tmp - alt_start
            alt_seq = alt_seq[:off] + seq_tmp + alt_seq[off + node_len_tmp :]

        if node_end_tmp <= alt_end:
            continue

        while pre_node_end_vec and node_end_tmp <= pre_node_end_vec[-1] and seq_tmp:
            if gt_tmp == 0:
                seq_tmp = ""
                break
            elif pre_gt == 0 and down_seq:
                pre_qry_len_tmp = min(
                    pre_node_end_vec[-1] - node_start_tmp + 1, pre_qry_len_vec[-1]
                )
                down_seq = down_seq[: len(down_seq) - pre_qry_len_tmp]
                pre_qry_len_vec.pop()
                pre_gt_vec.pop()
                pre_node_start_vec.pop()
                pre_node_end_vec.pop()
                continue
            break

        while pre_node_end_vec and node_start_tmp <= pre_node_end_vec[-1] and seq_tmp:
            if gt_tmp == 0:
                cut = pre_node_end_vec[-1] - node_start_tmp + 1
                seq_tmp = seq_tmp[cut : cut + (node_end_tmp - pre_node_end_vec[-1])]
                break
            elif pre_gt == 0 and down_seq:
                pre_qry_len_tmp = min(
                    pre_node_end_vec[-1] - node_start_tmp + 1, pre_qry_len_vec[-1]
                )
                down_seq = down_seq[: len(down_seq) - pre_qry_len_tmp]
                pre_qry_len_vec.pop()
                pre_gt_vec.pop()
                pre_node_start_vec.pop()
                pre_node_end_vec.pop()
                continue
            break

        if not seq_tmp:
            continue

        pre_node_start_vec.append(node_start_tmp)
        pre_node_end_vec.append(node_end_tmp)

        remaining = seq_len - len(down_seq)
        if len(seq_tmp) >= remaining:
            down_seq = down_seq + seq_tmp[:remaining]
            pre_qry_len_vec.append(remaining)
        else:
            down_seq = down_seq + seq_tmp
            pre_qry_len_vec.append(len(seq_tmp))
        pre_gt = gt_tmp
        pre_gt_vec.append(pre_gt)

    return up_seq, down_seq, alt_seq
