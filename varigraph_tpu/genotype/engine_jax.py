"""Device (JAX) genotyping engine.

Device formulation of the genotyping math (validated against the
extended-precision oracle in engine_np.py, which ports reference
src/genotype.cpp -- see its docstring for the file:line map):

  * hidden states + emissions: one fused jitted pass over node chunks
    producing log-emission matrices [nodes, states]; all the reference's
    per-k-mer scalar branches (ref-flag CI rule, local-bitmask verification,
    coverage rescaling, Poisson/geometric scoring) become vectorized selects
    over [chunk, states, kmers] tensors.
  * forward/backward: a lax.scan over nodes, vmapped over windows
    ([windows, maxN, S] batching).  Per-node transition matrices are
    exp(overlap * log_norecomb + (ploidy-overlap) * log_recomb), built from a
    precomputed state-overlap matrix; emissions are max-subtracted per node,
    which cancels in the reference's own per-node normalization.
  * chain resets: nodes with zero active k-mers reset the HMM (fresh flag in
    the scan carry), matching the reference's empty-HMMScoreVec behavior.
  * posterior aggregation (string-keyed genotype grouping, NAK/CAK/UK) stays
    on host -- it's tiny and tie-breaking is string-ordered.

Float32 on device; the oracle engine is the precision reference.
"""

from __future__ import annotations

import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..index.structs import GraphIndex
from ..utils.log import log
from .combos import increment_vector
from .engine_np import (
    PosteriorRecord,
    get_error_param,
    make_windows,
    poisson_interval,
    window_rng_seed,
)
from .hapselect import dirichlet_top_haps, window_hap_counts

MAX_NODE_KMERS = 128

# windows scored per device round; bounds [W, N, S] alpha/beta memory at
# genome scale (override: VARIGRAPH_WINDOW_CHUNK)
_WINDOW_GROUP = int(os.environ.get("VARIGRAPH_WINDOW_CHUNK", "256"))
# nodes per emission-kernel call; bounds the [n, K, S] emission intermediates
# when a window holds thousands of nodes (at N=8192, K=128, S=256 a single
# f32 intermediate is 1 GB; chunks of 1024 keep it ~128 MB)
_NODE_CHUNK = int(os.environ.get("VARIGRAPH_NODE_CHUNK", "1024"))


# ======================================================================
# emission kernel
# ======================================================================

def _unpack_bits32(pk: jnp.ndarray) -> jnp.ndarray:
    """[B, K, W] uint32 words -> [B, K, W*32] f32 0/1 (bit i of word w is
    used-hap index w*32+i)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    b = (pk[..., None] >> shifts) & jnp.uint32(1)
    return b.astype(jnp.float32).reshape(pk.shape[0], pk.shape[1], -1)


def _emissions_body(
    c,          # [B, K] int32   raw coverage (saturated u8)
    f,          # [B, K] int32   graph frequency
    flag,       # [B, K] bool    ref flag
    kmask,      # [B, K] bool    valid k-mer
    bits_pk,    # [B, K, W] u32  packed global hap bits for used haps
    local_pk,   # [B, K, W] u32  packed node-local hap bits for used haps
    gt0_u,      # [B, U] bool    hap's GT at this node == 0 (U = W*32)
    state_cnt,  # [U, S] f32     count of used-hap u in state s's combo
    smask,      # [S] bool       valid state
    ave,        # f32 scalar     hap k-mer coverage
    lower, upper,  # f32 scalars  95% CI
    log_p, log_q, log_prior,  # f32 scalars of the geometric model
):
    """Returns logE [B, S] (f32): per-state log emission scores.

    Haplotype bitmasks arrive as packed uint32 words (32x less host->device
    traffic than unpacked planes) and are unpacked on device; per-state
    copy-count sums (h and the verification decrement) are contractions over
    the used-hap axis against the state-count matrix -- matmuls instead of a
    [B, K, S, P] gather.  Padding u-columns are inert: their bits are 0,
    gt0_u is False, and state_cnt rows are 0.

    Both contractions keep the default matmul precision: their operands are
    0/1 and integer copy counts <= 8, which TF32 represents exactly, and
    they accumulate in f32, so the sums are exact integers on any backend.
    """
    ave = jnp.float32(ave)
    bits_u = _unpack_bits32(bits_pk)         # [B, K, U] f32 0/1
    local_u = _unpack_bits32(local_pk)
    # hTmp per (b, k, u): ref-flag CI inclusion (genotype.cpp:702)
    cf = c.astype(jnp.float32)
    ci = flag[:, :, None] & gt0_u[:, None, :] & (
        (cf >= lower) & (cf <= upper)
    )[:, :, None]
    htmp = jnp.where(ci, 1.0, bits_u)  # [B, K, U]

    # h per (b, k, s): sum of copy counts over the state's haplotypes
    h = jnp.einsum(
        "bku,us->bks", htmp, state_cnt,
        preferred_element_type=jnp.float32,
    )

    # verification (genotype.cpp:706-812) via local bitmasks
    trigger = ((cf < lower) & (f >= 2))[:, :, None] & (htmp > 0) & kmask[:, :, None]
    need_u = trigger.any(axis=1)            # [B, U]
    verify_k = (cf <= lower) & (f >= 2)     # [B, K]
    dec_u = (
        verify_k[:, :, None]
        & (htmp == 1.0)
        & need_u[:, None, :]
        & (local_u == 0.0)
    )                                        # [B, K, U]
    dec = jnp.einsum(
        "bku,us->bks", dec_u.astype(jnp.float32), state_cnt,
        preferred_element_type=jnp.float32,
    )
    h = jnp.maximum(h - dec, 0.0)

    # effective frequency (genotype.cpp:713-718)
    f_eff = jnp.where(flag & (f == 1), 2, f)[:, :, None]  # [B, K, 1]

    # coverage rescaling (find_most_likely_depth, genotype.cpp:1136-1158)
    cB = c[:, :, None].astype(jnp.float32)   # [B, K, 1]
    hf = h                                   # [B, K, S] exact small ints in f32
    ff = f_eff.astype(jnp.float32)
    cap = jnp.floor(ave * hf)                # uint8 truncation
    c_div_f = jnp.floor(cB / ff)
    cond_h_hi = (h > 0) & (cB > ave * hf)
    cond_0_hi = (h == 0) & (cB > ave)
    cond_0_lo = (h == 0) & (cB <= ave)
    zero_out = ff > (cB / jnp.float32(upper))
    cc = jnp.where(
        f_eff == 1,
        cB,
        jnp.where(
            cond_h_hi, cap,
            jnp.where(
                cond_0_hi, jnp.where(zero_out, 0.0, c_div_f),
                jnp.where(cond_0_lo, c_div_f, cB),
            ),
        ),
    )  # [B, K, S]

    # log emissions
    # h == 0: geometric = prior(p) * q^c * p^(1-c)  (genotype.cpp:1095-1120)
    log_geo = log_prior + cc * log_q + (1.0 - cc) * log_p
    # h > 0: Poisson(mean = ave*h) at cc  (genotype.cpp:1030-1039)
    mean = ave * hf
    log_poi = -mean + cc * jnp.log(jnp.maximum(mean, 1e-30)) - jax.lax.lgamma(cc + 1.0)
    terms = jnp.where(h == 0, log_geo, log_poi)          # [B, K, S]
    terms = jnp.where(kmask[:, :, None], terms, 0.0)
    logE = terms.sum(axis=1)                              # [B, S]
    return jnp.where(smask[None, :], logE, -jnp.inf)


_emissions = jax.jit(_emissions_body)

# Grouped emissions: one dispatch scores a [G, N, ...] stack of windows,
# each with its OWN state-count matrix / state mask (vmapped over the
# window axis; scalars broadcast), instead of one dispatch per window.
# Windows are independent; pad windows have smask all-False -> -inf rows.
_emissions_group = jax.jit(
    jax.vmap(
        _emissions_body,
        in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0,
                 None, None, None, None, None, None),
    )
)

# total padded node rows per grouped-emissions dispatch: bounds the
# [rows, K, S] intermediates (rows*K*S*4B*~3 live tensors; 4096 rows at
# K=S=128 is ~0.8 GB)
_EMIT_ROWS = int(os.environ.get("VARIGRAPH_EMIT_ROWS", "4096"))


# ======================================================================
# forward/backward scan
# ======================================================================

@functools.partial(jax.jit, static_argnames=("P",))
def _forward_backward(
    logE,        # [W, N, S] f32
    kind,        # [W, N] int32  0=pad 1=real 2=reset
    log_rec_f, log_norec_f,  # [W, N] f32 (forward distances)
    log_rec_b, log_norec_b,  # [W, N] f32 (backward distances)
    overlap,     # [W, S, S] int32
    log_w,       # [W, S] f32  per-state hap-frequency factor ('fre' mode)
    smask,       # [W, S] bool
    fre_mode,    # bool scalar
    P: int,
):
    """Returns (alpha, beta) [W, N, S]."""
    Pf = jnp.float32(P)
    nvalid = smask.sum(axis=-1).astype(jnp.float32)  # [W]
    # T[i,j] = norec^ov * rec^(P-ov) with ov in {0..P}: the transition
    # matrix has only P+1 DISTINCT values per step, so decompose it into
    # P+1 static 0/1 class masks (from the int overlap matrix, once per
    # window) and per-step scalar weights t_c = exp(c*lnr + (P-c)*lr).
    # alpha @ T becomes P+1 mask matvecs + a tiny weighted sum -- the old
    # per-step [S, S] exp build cost 4.2M transcendentals per scan step at
    # the production batch (fb ~17-20 s per 256-window group through every
    # round; this removes ~99% of that work with identical t values).
    cls = jnp.arange(P + 1, dtype=jnp.float32)        # [P+1]
    mcls = Pf - cls

    def step(carry, xs, M, lw, sm, nv):
        alpha, fresh = carry
        le, knd, lr, lnr = xs
        le_m = jnp.where(sm, le - jnp.max(jnp.where(sm, le, -jnp.inf)),
                         -jnp.inf)

        def real_step():
            # safe at rec==0 (class weight exponent 0 -> factor 1)
            a = jnp.where(cls == 0.0, 0.0, cls * lnr)
            b = jnp.where(mcls == 0.0, 0.0, mcls * lr)
            t = jnp.exp(a + b)                        # [P+1]
            # alpha and t are probabilities: pinned to full f32 precision,
            # since a GPU may otherwise run this contraction in TF32
            flow = jnp.where(
                fre_mode,
                alpha.sum() * jnp.exp(jnp.where(sm, lw, 0.0)),
                jnp.einsum("s,csj,c->j", alpha, M, t,
                           preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST),
            )
            # flow * exp(le_m), taken in the log domain and scaled to a
            # maximum of 1: flow (>= t_0, down to ~1e-29) times emissions can
            # fall below f32's normal range, where GPUs flush to zero while
            # CPUs keep denormals -- and such entries grow back to matter
            # within a few nodes.  The scale cancels in raw / tot.
            lg = jnp.where(fresh, le_m, jnp.log(flow) + le_m)
            raw = jnp.exp(lg - jnp.max(lg))
            tot = raw.sum()
            uniform = jnp.where(sm, 1.0 / nv, 0.0)
            return jnp.where(tot > 0, raw / tot, uniform)

        new_alpha = jax.lax.cond(knd == 1, real_step, lambda: alpha)
        new_fresh = jnp.where(knd == 1, False, jnp.where(knd == 2, True, fresh))
        out = jnp.where(knd == 1, new_alpha, jnp.zeros_like(new_alpha))
        return (new_alpha, new_fresh), out

    def run_window(le_w, kind_w, lrf, lnrf, lrb, lnrb, ov, lw, sm, nv):
        S = le_w.shape[-1]
        # [P+1, S, S] 0/1 class masks; static across the scan
        M = (ov[None, :, :] == jnp.arange(P + 1, dtype=ov.dtype)[:, None, None]
             ).astype(jnp.float32)
        init = (jnp.zeros((S,), jnp.float32), jnp.bool_(True))
        _, alpha = jax.lax.scan(
            lambda c, x: step(c, x, M, lw, sm, nv),
            init, (le_w, kind_w, lrf, lnrf),
        )
        _, beta_rev = jax.lax.scan(
            lambda c, x: step(c, x, M, lw, sm, nv),
            init,
            (le_w[::-1], kind_w[::-1], lrb[::-1], lnrb[::-1]),
        )
        return alpha, beta_rev[::-1]

    return jax.vmap(run_window)(
        logE, kind, log_rec_f, log_norec_f, log_rec_b, log_norec_b,
        overlap, log_w, smask, nvalid,
    )


# ======================================================================
# host orchestration
# ======================================================================

def _transition_logs(dist: np.ndarray, nhap: int):
    """log(recomb), log(norecomb) per distance (genotype.cpp:954-964)."""
    d = dist.astype(np.float64) * 0.000004 * 1.26 * 1e-05
    n = float(nhap)
    ex = np.exp(-d / n)
    rec = (1.0 - ex) * (1.0 / n)
    norec = ex + rec
    with np.errstate(divide="ignore"):
        return (
            np.log(rec).astype(np.float32),
            np.log(norec).astype(np.float32),
        )


def _csr_flat(off: np.ndarray, node_idx: np.ndarray) -> np.ndarray:
    """Flat row indices of the CSR segments for the given nodes, in node
    order: concat(arange(off[i], off[i+1]) for i in node_idx), vectorized."""
    lens = off[node_idx + 1] - off[node_idx]
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, np.int64)
    cum0 = np.zeros(len(node_idx), np.int64)
    np.cumsum(lens[:-1], out=cum0[1:])
    return np.repeat(off[node_idx] - cum0, lens) + np.arange(total, dtype=np.int64)


class _WindowPrep:
    """Host-side gather of one window's tensors.

    Haplotype bits arrive packed ([M, W] uint32); only this window's gathered
    rows are unpacked, so host memory stays bounded at genome scale."""

    def __init__(self, gi, cfg, chrom, lo, hi, rng, cov_u8, freq_np, hap_words,
                 refflag, hap_cov):
        self.chrom = chrom
        nodes = gi.graph.nodes[chrom]
        self.cfg = cfg
        nhap = gi.nhap

        gt_len = gi.graph.gt_len[chrom]
        variant_idx = np.arange(lo, hi, dtype=np.int64)[gt_len[lo:hi] > 1]
        tbl_off, tbl_idx, tbl_lp = gi.graph.tbl_csr[chrom]
        counts = window_hap_counts(
            [tbl_idx[_csr_flat(tbl_off, variant_idx)]],
            cov_u8, freq_np, hap_words, nhap,
        )
        haploid_num = min(cfg.haploid_num, nhap)
        self.top_hap, self.score_map = dirichlet_top_haps(counts, haploid_num, rng)
        self.states = increment_vector(
            self.top_hap, cfg.sample_type, cfg.sample_ploidy, nhap - 1
        )
        self.used_haps = sorted({h for s in self.states for h in s})

        # state-overlap matrix: |multiset intersection| of haplotype combos
        # (genotype.cpp:1217-1227) -- sum over haps of min(count_i, count_j)
        S = len(self.states)
        hap_list = self.used_haps
        hap_pos = {h: i for i, h in enumerate(hap_list)}
        cnt = np.zeros((S, len(hap_list)), np.int32)
        for si, st in enumerate(self.states):
            for h in st:
                cnt[si, hap_pos[h]] += 1
        self.overlap = np.minimum(cnt[:, None, :], cnt[None, :, :]).sum(
            axis=2, dtype=np.int32
        )

        # scorable nodes (genotype.cpp:257-277), via the dense per-chrom
        # metadata (gt_len) instead of per-node Python attribute walks
        cand = variant_idx
        if cfg.sv_genotype_only:
            vcf_info_chrom = gi.vcf_info.get(chrom, {})
            keep = []
            for i in cand:
                info = vcf_info_chrom.get(int(nodes[i].start))
                if info is None:
                    raise ValueError(
                        f"'{chrom}:{nodes[i].start}' does not exist in the VCF file."
                    )
                if len(info[3]) >= 50 or len(info[4]) >= 50:
                    keep.append(i)
            cand = np.asarray(keep, np.int64)
        self.node_idx = cand
        self.node_refs = [nodes[i] for i in cand]

        lower, upper = poisson_interval(float(hap_cov))
        self.lower, self.upper = lower, upper

        n = len(self.node_refs)
        U = len(self.used_haps)
        K = MAX_NODE_KMERS
        self.c = np.zeros((n, K), np.int32)
        self.f = np.zeros((n, K), np.int32)
        self.flag = np.zeros((n, K), bool)
        self.kmask = np.zeros((n, K), bool)
        self.bits_u = np.zeros((n, K, U), np.uint8)
        self.local_u = np.zeros((n, K, U), np.uint8)
        self.kind = np.ones(n, np.int32)

        starts = gi.graph.starts_np[chrom][cand]
        ends = gi.graph.ends_np[chrom][cand]

        # per-node GT values of the used haplotypes [n, U] (one dense gather
        # instead of an O(n*U) Python loop); gt0_u feeds the emission
        # kernel's ref-flag CI rule, G_nu feeds posterior grouping
        self.G_nu = gi.graph.gt_submatrix(chrom, cand, self.used_haps)
        self.gt0_u = self.G_nu == 0

        # flat gather across all nodes of the window: slice the resolved
        # per-chromosome CSR (no per-node numpy calls or concatenations)
        lens = tbl_off[cand + 1] - tbl_off[cand]
        if lens.sum() > 0:
            flat_rows = _csr_flat(tbl_off, cand)
            flat_idx = tbl_idx[flat_rows]
            node_of = np.repeat(np.arange(n, dtype=np.int64), lens)
            all_local = tbl_lp[flat_rows]
            from ..ops.table import unpack_hapbits

            rows_flat = unpack_hapbits(hap_words[flat_idx], nhap)
            keep_flat = rows_flat[:, self.top_hap].any(axis=1)
            act_flat = flat_idx[keep_flat]
            act_node = node_of[keep_flat]
            counts = np.bincount(act_node, minlength=n)
            offs = np.zeros(n + 1, np.int64)
            np.cumsum(counts, out=offs[1:])
            pos = np.arange(len(act_flat), dtype=np.int64) - offs[act_node]
            self.kind[counts == 0] = 2
            self.c[act_node, pos] = cov_u8[act_flat]
            self.f[act_node, pos] = freq_np[act_flat]
            self.flag[act_node, pos] = refflag[act_flat]
            self.kmask[act_node, pos] = True
            self.bits_u[act_node, pos] = rows_flat[keep_flat][:, self.used_haps]
            unpacked = np.unpackbits(
                all_local[keep_flat], axis=1, bitorder="little"
            )
            self.local_u[act_node, pos] = unpacked[:, self.used_haps]
        else:
            self.kind[:] = 2

        # distances between chain nodes (resets update anchors but do not
        # score -- genotype.cpp:371-374); vectorized shift instead of a
        # per-node loop
        dist_f = np.zeros(n, np.int64)
        dist_b = np.zeros(n, np.int64)
        if n:
            dist_f[0] = starts[0] & 0xFFFFFFFF
            dist_f[1:] = (starts[1:] - ends[:-1]) & 0xFFFFFFFF
            dist_b[n - 1] = (-ends[n - 1]) & 0xFFFFFFFF
            dist_b[:-1] = (starts[1:] - ends[:-1]) & 0xFFFFFFFF
        self.log_rec_f, self.log_norec_f = _transition_logs(dist_f, nhap)
        self.log_rec_b, self.log_norec_b = _transition_logs(dist_b, nhap)

        hap2u = {hp: i for i, hp in enumerate(self.used_haps)}
        self.state_u = np.array(
            [[hap2u[h] for h in s] for s in self.states], np.int32
        )
        with np.errstate(divide="ignore"):
            self.log_w = np.array(
                [
                    sum(math.log(self.score_map[h]) if self.score_map.get(h, 0) > 0
                        else -np.inf for h in s)
                    for s in self.states
                ],
                np.float32,
            )


def state_count_matrix(state_u: np.ndarray, U: int) -> np.ndarray:
    """[S, P] used-hap indices -> [U, S] f32 copy counts per state."""
    S = state_u.shape[0]
    cnt = np.zeros((U, S), np.float32)
    for si in range(S):
        for u in state_u[si]:
            cnt[u, si] += 1.0
    return cnt


def _pow2(n: int, lo: int = 1) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _posterior_string_fallback(rec_out, prep, post, node, nak_u, cak_num_u,
                               uk: int, hap2u: dict):
    """Exact string-keyed genotype aggregation (genotype.cpp:1441-1513) for
    nodes carrying GT values >= 10, where packed numeric keys would diverge
    from std::map's lexicographic string order."""
    hap_gt = node.hap_gt
    geno_strs = [
        "/".join(sorted(str(hap_gt[h]) for h in st)) for st in prep.states
    ]
    geno_sum: dict[str, float] = {}
    for si, gs in enumerate(geno_strs):
        geno_sum[gs] = geno_sum.get(gs, 0.0) + post[si]
    best_g, best_score = None, -1.0
    for gs in sorted(geno_sum.keys()):
        if geno_sum[gs] > best_score:
            best_score = geno_sum[gs]
            best_g = gs
    max_post = 0.0
    for si, gs in enumerate(geno_strs):
        if gs != best_g:
            continue
        rec_out.probability = float(best_score)
        if max_post < post[si]:
            max_post = post[si]
            rec_out.hap_vec = list(prep.states[si])
            rec_out.kmer_num_vec = []
            rec_out.kmer_avecov_vec = []
            for hp in rec_out.hap_vec:
                uj = hap2u[hp]
                num = int(nak_u[uj])
                rec_out.kmer_num_vec.append(num)
                rec_out.kmer_avecov_vec.append(
                    float(cak_num_u[uj]) / num if num else 0.0
                )
            rec_out.uk = uk


def genotype_jax(gi: GraphIndex, cfg, hap_cov: float, seed: int,
                 host_arrays=None) -> dict[tuple[str, int], PosteriorRecord]:
    import time as _time
    _t = {"prep": 0.0, "emit": 0.0, "fb": 0.0, "post": 0.0}
    _t0 = _time.perf_counter()
    if host_arrays is not None:
        cov_u8, freq_np, hap_words, refflag = host_arrays
    else:
        cov_u8 = gi.table.cov_u8()
        freq_np = gi.table.freq_np()
        hap_words = gi.table.hap_words_np()
        refflag = gi.table.refflag_np()

    # geometric-model scalars
    p = get_error_param(float(np.float32(hap_cov)))
    q = 1.0 - p
    variance = 0.05
    log_prior = float(
        np.log(1.0 / np.sqrt(2 * np.pi * variance))
        - (p - 0.5) ** 2 / (2 * variance)
    )

    # enumerate windows + the exact node-axis bound up front (cheap dense
    # metadata); the heavy per-window prep itself STREAMS one group ahead
    # of the device work on a worker thread -- the former prep-everything-
    # first pass serialized ~50 s of host gathers before any dispatch AND
    # held every window's [n, K, U] tensors live at once (~GBs at 500k
    # sites)
    windows_all: list[tuple[str, int, int, int]] = []
    nmax = 1
    for chrom in sorted(gi.graph.nodes.keys()):
        starts = gi.graph.starts[chrom]
        chrom_len = gi.chrom_lens.get(chrom)
        if chrom_len is None:
            raise ValueError(f"'{chrom}' does not exist in the reference genome.")
        gl = gi.graph.gt_len[chrom]
        for w_id, (lo, hi) in enumerate(
            make_windows(starts, chrom_len, cfg.granularity_bp)
        ):
            windows_all.append((chrom, w_id, lo, hi))
            nmax = max(nmax, int((gl[lo:hi] > 1).sum()))

    results: dict[tuple[str, int], PosteriorRecord] = {}
    if not windows_all:
        return results

    # multi-host: shard windows round-robin across processes -- each host
    # preps AND scores only its share, and the per-window results union at
    # the end (parallel/dist.merge_results_across_hosts).  Per-window
    # results are grouping-independent (windows are independent chains, the
    # per-window RNG is seeded by (seed, chrom, w_id), and S/U are pinned
    # up front), so the merged output is identical to a single-process run.
    # Each window is scored by exactly one process.
    n_proc = jax.process_count()
    windows_mine = windows_all
    if n_proc > 1:
        pid = jax.process_index()
        windows_mine = windows_all[pid::n_proc]
        log(f"window-sharded scoring: process {pid}/{n_proc} scores "
            f"{len(windows_mine)}/{len(windows_all)} windows",
            func="genotype_jax")

    def prep_iter():
        for chrom, w_id, lo, hi in windows_mine:
            rng = np.random.Generator(
                np.random.PCG64([seed, window_rng_seed(chrom), w_id])
            )
            prep = _WindowPrep(gi, cfg, chrom, lo, hi, rng, cov_u8, freq_np,
                               hap_words, refflag, hap_cov)
            starts = gi.graph.starts[chrom]
            log(
                f"Haplotype selection results for {chrom}-"
                f"{starts[lo] if lo < len(starts) else 0}: "
                + ", ".join(str(h) for h in prep.top_hap),
                func="haplotype_selection",
            )
            if prep.node_refs:
                yield prep

    # pad to common shapes (all axes power-of-two so shapes are reused
    # across runs with different window/state counts; U is a multiple of 32
    # so hap bitmasks pack exactly into uint32 words for the device).  The
    # node axis is exact (from metadata); S/U start from the first group's
    # maxima and grow (new pow2 -> one recompile) in the rare modes where a
    # later window needs more states/haplotypes.
    N = _pow2(nmax, 8)
    K = MAX_NODE_KMERS
    P = cfg.sample_ploidy
    # windows are processed in fixed-size groups so device memory stays
    # bounded at genome scale (a whole-genome run has thousands of 1 Mb
    # windows; [W, N, S] alpha/beta at W=3000 would be several GB)
    Wg = min(_pow2(len(windows_all), 1), _WINDOW_GROUP)
    # pin S/U to their config-derived upper bounds UP FRONT: the state list
    # is increment_vector over exactly haploid_num selected haplotypes, so
    # its size (and the used-hap count) depends only on (haploid_num,
    # sample_type, ploidy) -- growing lazily instead risks ONE late outlier
    # window triggering a recompile mid-run.  Env overrides keep an escape
    # hatch for experiments.
    hn = min(cfg.haploid_num, gi.nhap)
    if P > 2:
        # polyploid combos: one ploidy-block per selected hap, deduped
        s_bound, u_bound = hn + 1, min(gi.nhap, hn * P + 1)
    else:
        s_bound = len(
            increment_vector(list(range(hn)), cfg.sample_type, P, gi.nhap - 1)
        )
        u_bound = hn
    S = int(os.environ.get("VARIGRAPH_PIN_S", _pow2(s_bound, 4)))
    U = int(os.environ.get("VARIGRAPH_PIN_U", max(32, _pow2(u_bound, 4))))

    fre_mode = cfg.transition_pro_type != "rec"

    # local multi-device: shard the window axis of the forward/backward
    # batch across this host's devices (the HMM scan is vmapped over
    # independent windows, so partitioning W is communication-free; XLA
    # reshards the emission stack across the devices).  Composes with the
    # multi-host round-robin window split above.  A single device and tiny
    # runs (Wg % n_ldev != 0) are unaffected.
    n_ldev = jax.local_device_count()
    if getattr(cfg, "mesh_devices", 0):
        n_ldev = min(n_ldev, cfg.mesh_devices)
    w_sharding = None
    if n_ldev > 1 and Wg % n_ldev == 0:
        from jax.sharding import Mesh as _Mesh, NamedSharding as _NS, \
            PartitionSpec as _PS

        _wmesh = _Mesh(np.array(jax.local_devices()[:n_ldev]), ("data",))
        w_sharding = _NS(_wmesh, _PS("data"))
        log(f"window-sharded forward/backward over {n_ldev} local devices",
            func="genotype_jax")

    def _put_w(arr):
        return jax.device_put(arr, w_sharding) if w_sharding is not None \
            else jnp.asarray(arr)

    from ..ops.table import pack_hapbits

    import itertools
    from concurrent.futures import ThreadPoolExecutor

    it = prep_iter()
    pool = ThreadPoolExecutor(max_workers=1)
    post_pool = ThreadPoolExecutor(max_workers=1)
    post_fut = None

    def take():
        return list(itertools.islice(it, Wg))

    fut = pool.submit(take)
    while True:
        _tw = _time.perf_counter()
        group = fut.result()       # only the NON-overlapped prep time counts
        _t["prep"] += _time.perf_counter() - _tw
        fut = pool.submit(take)
        if not group:
            pool.shutdown(wait=False)
            break
        gS = _pow2(max(len(p_.states) for p_ in group), 4)
        gU = max(32, _pow2(max(len(p_.used_haps) for p_ in group), 4))
        if gS > S or gU > U:
            S, U = max(S, gS), max(U, gU)
        kind_all = np.zeros((Wg, N), np.int32)
        lrf = np.zeros((Wg, N), np.float32)
        lnrf = np.zeros((Wg, N), np.float32)
        lrb = np.zeros((Wg, N), np.float32)
        lnrb = np.zeros((Wg, N), np.float32)
        ov_all = np.zeros((Wg, S, S), np.int32)
        lw_all = np.full((Wg, S), 0.0, np.float32)
        sm_all = np.zeros((Wg, S), bool)
        Ww = U // 32
        # u8 wire types: coverage is saturated u8 and graph frequency is u8
        # by construction, and the emission kernel upcasts on device -- 4x
        # less H2D per group (c/f were the two largest emission operands)
        c_all = np.zeros((Wg, N, K), np.uint8)
        f_all = np.zeros((Wg, N, K), np.uint8)
        flag_all = np.zeros((Wg, N, K), bool)
        kmask_all = np.zeros((Wg, N, K), bool)
        bits_all = np.zeros((Wg, N, K, Ww), np.uint32)
        local_all = np.zeros((Wg, N, K, Ww), np.uint32)
        gt0_all = np.zeros((Wg, N, U), bool)
        sc_all = np.zeros((Wg, U, S), np.float32)

        _te = _time.perf_counter()
        for wi, prep in enumerate(group):
            n = len(prep.node_refs)
            s = len(prep.states)
            # pack the n real rows first, THEN place into the padded stack:
            # packing scales with the window's actual node count, not the
            # padded power-of-two shape.  Pad windows (wi >= len(group))
            # keep all-zero inputs and an all-False state mask, which the
            # emission kernel maps to -inf rows -- the former explicit pad
            # filler, computed in-batch.
            bp = pack_hapbits(prep.bits_u.reshape(n * K, -1)).reshape(n, K, -1)
            lp = pack_hapbits(prep.local_u.reshape(n * K, -1)).reshape(n, K, -1)
            bits_all[wi, :n, :, : bp.shape[2]] = bp
            local_all[wi, :n, :, : lp.shape[2]] = lp
            gt0_all[wi, :n, : prep.gt0_u.shape[1]] = prep.gt0_u
            sc = state_count_matrix(prep.state_u, U)
            sc_all[wi, :, : sc.shape[1]] = sc
            c_all[wi, :n] = prep.c
            f_all[wi, :n] = prep.f
            flag_all[wi, :n] = prep.flag
            kmask_all[wi, :n] = prep.kmask
            kind_all[wi, :n] = prep.kind
            lrf[wi, :n] = prep.log_rec_f
            lnrf[wi, :n] = prep.log_norec_f
            lrb[wi, :n] = prep.log_rec_b
            lnrb[wi, :n] = prep.log_norec_b
            ov_all[wi, :s, :s] = prep.overlap
            lw_all[wi, :s] = prep.log_w
            sm_all[wi, :s] = True

        # grouped emission dispatches: Gc windows per call (one vmapped
        # kernel), bounding the [rows, K, S] intermediates to _EMIT_ROWS
        # padded node rows.
        lo_w, up_w = group[0].lower, group[0].upper  # hap_cov-derived, equal
                                                     # for every window
        scalars = (np.float32(hap_cov), np.float32(lo_w), np.float32(up_w),
                   np.float32(np.log(p)), np.float32(np.log(q)),
                   np.float32(log_prior))
        Gc = max(1, min(Wg, _EMIT_ROWS // N))
        parts = []
        for g0 in range(0, Wg, Gc):
            g1 = g0 + Gc
            if N > _EMIT_ROWS:
                # giant windows: chunk the node axis within the window
                sub = []
                for c0 in range(0, N, _NODE_CHUNK):
                    c1 = c0 + _NODE_CHUNK
                    sub.append(_emissions(
                        jnp.asarray(c_all[g0, c0:c1]),
                        jnp.asarray(f_all[g0, c0:c1]),
                        jnp.asarray(flag_all[g0, c0:c1]),
                        jnp.asarray(kmask_all[g0, c0:c1]),
                        jnp.asarray(bits_all[g0, c0:c1]),
                        jnp.asarray(local_all[g0, c0:c1]),
                        jnp.asarray(gt0_all[g0, c0:c1]),
                        jnp.asarray(sc_all[g0]), jnp.asarray(sm_all[g0]),
                        *scalars,
                    ))
                parts.append(jnp.concatenate(sub)[None])
            else:
                parts.append(_emissions_group(
                    jnp.asarray(c_all[g0:g1]), jnp.asarray(f_all[g0:g1]),
                    jnp.asarray(flag_all[g0:g1]),
                    jnp.asarray(kmask_all[g0:g1]),
                    jnp.asarray(bits_all[g0:g1]),
                    jnp.asarray(local_all[g0:g1]),
                    jnp.asarray(gt0_all[g0:g1]), jnp.asarray(sc_all[g0:g1]),
                    jnp.asarray(sm_all[g0:g1]), *scalars,
                ))
        logE_all = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
        _t["emit"] += _time.perf_counter() - _te

        _t0b = _time.perf_counter()
        alpha, beta = _forward_backward(
            _put_w(logE_all), _put_w(kind_all),
            _put_w(lrf), _put_w(lnrf), _put_w(lrb),
            _put_w(lnrb),
            _put_w(ov_all), _put_w(lw_all), _put_w(sm_all),
            jnp.bool_(fre_mode), P,
        )
        alpha = np.asarray(alpha)
        beta = np.asarray(beta)
        _t["fb"] += _time.perf_counter() - _t0b

        # posterior runs on a single worker thread so it overlaps the NEXT
        # group's prep/upload/device work (the big numpy ops release the
        # GIL; the main thread mostly waits on the device).  One worker +
        # join-at-end keeps `results` single-writer.
        _tp = _time.perf_counter()
        if post_fut is not None:
            post_fut.result()
            _t["post"] += _time.perf_counter() - _tp
        post_fut = post_pool.submit(
            _posterior_window_group, group, alpha, beta, results
        )

    _tp = _time.perf_counter()
    if post_fut is not None:
        post_fut.result()
    post_pool.shutdown(wait=True)
    _t["post"] += _time.perf_counter() - _tp
    log(
        "engine timing: prep {prep:.2f}s emit {emit:.2f}s fb {fb:.2f}s "
        "posterior {post:.2f}s (non-overlapped)".format(**_t),
        func="genotype_jax",
    )
    if n_proc > 1:
        from ..parallel.dist import merge_results_across_hosts

        results = merge_results_across_hosts(results)
    return results


def _posterior_window_group(group, alpha, beta, results):
    # ---- posterior on host (genotype.cpp:1371-1546), vectorized per window ----
    # Genotype grouping uses string-sorted keys in the reference
    # (std::map<string>, genotype.cpp:1441-1459).  For GT values <= 9 the
    # string order of "a/b/..." (digits sorted ascending) equals the
    # lexicographic order of the ascending-sorted numeric tuples, so groups
    # are formed with packed integer keys; rare nodes carrying GT >= 10 fall
    # back to the exact string path.
    for wi, prep in enumerate(group):
        s = len(prep.states)
        n = len(prep.node_refs)
        if n == 0:
            continue
        real = prep.kind == 1
        a = alpha[wi, :n, :s].astype(np.float64)
        b = beta[wi, :n, :s].astype(np.float64)
        ab = a * b
        den = ab.sum(axis=1)
        safe_den = np.where(den != 0, den, 1.0)
        post = np.where((den != 0)[:, None], ab / safe_den[:, None], 0.0)

        # per-node GT values of the used haplotypes [n, U], gathered once
        # from the per-chrom GT matrix during prep
        G_nsp = prep.G_nu[:, prep.state_u]          # [n, S, P]
        fallback = (G_nsp.max(axis=(1, 2)) > 9) & real

        P = prep.state_u.shape[1]
        gts_sorted = np.sort(G_nsp, axis=2)          # ascending == sorted(str) for <=9
        shifts = (8 * np.arange(P - 1, -1, -1)).astype(np.int64)
        keys_ns = (gts_sorted << shifts).sum(axis=2)  # [n, S]

        # group-by per node: stable sort by key, segment sums, best = max
        # score with smallest key on ties (ascending scan with strict >)
        order = np.argsort(keys_ns, axis=1, kind="stable")
        ksort = np.take_along_axis(keys_ns, order, axis=1)
        psort = np.take_along_axis(post, order, axis=1)
        gstart = np.ones((n, s), bool)
        gstart[:, 1:] = ksort[:, 1:] != ksort[:, :-1]
        gid = np.cumsum(gstart, axis=1) - 1           # group index per position
        last_in_group = np.ones((n, s), bool)
        last_in_group[:, :-1] = gstart[:, 1:]
        csum = np.cumsum(psort, axis=1)
        # csum value just before each group's start, forward-filled within
        # the group (csum is nondecreasing, so maximum.accumulate fills)
        shifted = np.zeros_like(csum)
        shifted[:, 1:] = csum[:, :-1]
        base = np.maximum.accumulate(
            np.where(gstart, shifted, -np.inf), axis=1
        )
        totals_end = np.where(last_in_group, csum - base, -np.inf)  # [n, s]
        best_score_n = totals_end.max(axis=1)
        # first group (smallest key) achieving the max
        win_pos = np.argmax(totals_end == best_score_n[:, None], axis=1)
        win_group = np.take_along_axis(gid, win_pos[:, None], axis=1)[:, 0]

        # winner state: first (by si) strictly-max post among winner-group
        # states, matching `if max_post < post[si]` with max_post starting 0
        in_win = gid == win_group[:, None]            # positions in sorted order
        win_mask = np.zeros((n, s), bool)             # by original si
        np.put_along_axis(win_mask, order, in_win, axis=1)
        post_w = np.where(win_mask, post, -np.inf)
        max_post_n = post_w.max(axis=1)
        win_si = np.argmax(post_w == max_post_n[:, None], axis=1)
        has_winner = max_post_n > 0.0

        # NAK/CAK/UK, vectorized over the prep tensors
        nak_nu = (prep.bits_u * prep.kmask[:, :, None]).sum(axis=1)   # [n, U]
        cak_num = (prep.c[:, :, None] * prep.bits_u
                   * prep.kmask[:, :, None]).sum(axis=1)              # [n, U]
        uk_n = np.minimum(((prep.f <= 1) & prep.kmask).sum(axis=1), 255)

        hap2u = {hp: uj for uj, hp in enumerate(prep.used_haps)}
        for ni, node in enumerate(prep.node_refs):
            if not real[ni]:
                continue
            rec_out = PosteriorRecord()
            if fallback[ni]:
                _posterior_string_fallback(
                    rec_out, prep, post[ni], node, nak_nu[ni], cak_num[ni],
                    int(uk_n[ni]), hap2u,
                )
            else:
                rec_out.probability = float(best_score_n[ni])
                if has_winner[ni]:
                    si = int(win_si[ni])
                    rec_out.hap_vec = list(prep.states[si])
                    rec_out.kmer_num_vec = []
                    rec_out.kmer_avecov_vec = []
                    for hp in rec_out.hap_vec:
                        uj = hap2u[hp]
                        num = int(nak_nu[ni, uj])
                        rec_out.kmer_num_vec.append(num)
                        rec_out.kmer_avecov_vec.append(
                            float(cak_num[ni, uj]) / num if num else 0.0
                        )
                    rec_out.uk = int(uk_n[ni])
            results[(prep.chrom, node.start)] = rec_out
