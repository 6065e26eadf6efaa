"""Host-side k-mer index builder: transcriptome FASTA (+ optional GTF) ->
flat-array index (reference: seekmer index.py's build path, SURVEY.md 2.1 C3
and call stack 3.1; the reference mount was empty at survey time so behavior
follows the kallisto-class algorithm family tagged [A] there).

Everything is vectorized numpy — no Python loop touches individual k-mers:

  1. per transcript: canonical 25-mers (encoding.canonical_kmers);
  2. global sort of (key, transcript) pairs, dedupe, group by key;
  3. equivalence classes = groups of keys with identical transcript sets,
     found by 128-bit order-sensitive fingerprints over the sorted sets;
  4. bucketized placement done OFFLINE: sort keys by home bucket, rank
     within the bucket group, keep rank < bucket_size — keys whose home
     bucket is full relocate to a low-load stash table, giving the device a
     2-choice guarantee: one gather finds any key (ops/probe.py).
"""

from __future__ import annotations

import logging
from typing import Iterable, Optional, Tuple

import numpy as np

from ..config import IndexConfig
from ..encoding import canonical_kmers, seq_to_codes, split_key
from ..ops.hash import hash_kmer, hash_kmer_stash
from .store import EMPTY, KMerIndex

log = logging.getLogger(__name__)

_M1 = np.uint64(0xFF51AFD7ED558CCD)
_M2 = np.uint64(0xC4CEB9FE1A85EC53)
_M3 = np.uint64(0x9E3779B97F4A7C15)


def _mix64(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint64(33))
    x = x * _M1
    x = x ^ (x >> np.uint64(33))
    x = x * _M2
    x = x ^ (x >> np.uint64(33))
    return x


def _next_pow2(n: int) -> int:
    return 1 << max(1, (n - 1).bit_length())


def _concat_codes(seqs: list[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate transcript codes with INVALID separators.

    Returns (codes uint64-indexable uint8 array, starts int64[T]) where
    transcript t occupies codes[starts[t] : starts[t] + len_t]; separator
    bytes make windows spanning transcript boundaries invalid, so ONE
    vectorized k-mer pass covers the whole transcriptome.
    """
    lengths = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    total = int(lengths.sum()) + len(seqs)
    codes = np.full(total, 4, np.uint8)
    starts = np.zeros(len(seqs), np.int64)
    off = 0
    for t, s in enumerate(seqs):
        starts[t] = off
        c = seq_to_codes(s)
        codes[off : off + c.size] = c
        off += c.size + 1
    return codes, starts


def collect_kmer_pairs(
    seqs: Iterable[str], k: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All (canonical key, transcript id) pairs plus transcript lengths."""
    seqs = list(seqs)
    lengths = np.fromiter((len(s) for s in seqs), np.int32,
                          len(seqs)) if seqs else np.empty(0, np.int32)
    if not seqs:
        return np.empty(0, np.uint64), np.empty(0, np.int32), lengths
    codes, starts = _concat_codes(seqs)
    keys, valid = canonical_kmers(codes, k)
    pos = np.flatnonzero(valid)
    tids = (np.searchsorted(starts, pos, side="right") - 1).astype(np.int32)
    return keys[pos], tids, lengths


# Pair counts below this sort via numpy (the C radix core's win is a
# large-scale one; tests force it to 0 to exercise byte-parity).
_NATIVE_SORT_MIN = 1 << 20


def group_equivalence_classes(
    keys: np.ndarray, tids: np.ndarray, return_key_rank: bool = False
):
    """Group k-mers by identical transcript set.

    Returns (unique_keys, key_ec, ec_offsets, ec_transcripts): key_ec[i] is
    the EC id of unique_keys[i]; CSR (ec_offsets, ec_transcripts) holds each
    EC's sorted transcript ids. With ``return_key_rank`` a fifth element is
    appended: each INPUT pair's rank into unique_keys — computed by riding
    the sort already being done, which lets compute_run_lengths skip a
    searchsorted over every window of the transcriptome (a 123M x
    log2(27M) binary-search pass that cost 94 s of a 234 s GENCODE-scale
    build).
    """
    n_pairs = keys.size
    # Sort pairs by (key, tid) and drop duplicates (k-mer repeated in a
    # transcript must count once). The pair stream arrives in transcript
    # order (tids nondecreasing), so ONE stable sort by key already yields
    # (key, tid) order — the lexsort's tid pass is redundant work at 62M
    # pairs. Fall back to the full lexsort for arbitrary input.
    stream_order = tids.size == 0 or bool((np.diff(tids) >= 0).all())
    key_rank = None
    sorted_native = None
    if stream_order and n_pairs >= _NATIVE_SORT_MIN:
        # hot loop #1 (SURVEY.md 3.1): the threaded C radix core sorts
        # byte-identically to the stable argsort + gathers (+ rank
        # scatter) and measured 7.1 s vs numpy's 37.8 s at GENCODE's
        # 62M pairs on the earlier 2-CPU build host. Falls through to
        # numpy when the library is missing.
        from ..native.packer import sort_pairs_native

        sorted_native = sort_pairs_native(keys, tids,
                                          want_rank=return_key_rank)
    if sorted_native is not None:
        keys, tids, key_rank = sorted_native
    else:
        if stream_order:
            order = np.argsort(keys, kind="stable")
        else:
            order = np.lexsort((tids, keys))
        keys, tids = keys[order], tids[order]
        if return_key_rank:
            new_key_all = np.ones(n_pairs, dtype=bool)
            new_key_all[1:] = keys[1:] != keys[:-1]
            krank_sorted = np.cumsum(new_key_all, dtype=np.int64) - 1
            key_rank = np.empty(n_pairs, np.int64)
            key_rank[order] = krank_sorted
    keep = np.ones(keys.size, dtype=bool)
    keep[1:] = (keys[1:] != keys[:-1]) | (tids[1:] != tids[:-1])
    keys, tids = keys[keep], tids[keep]

    # Key-group boundaries.
    new_key = np.ones(keys.size, dtype=bool)
    new_key[1:] = keys[1:] != keys[:-1]
    starts = np.flatnonzero(new_key)
    unique_keys = keys[starts]
    group_len = np.diff(np.append(starts, keys.size)).astype(np.int64)

    # Order-sensitive 128-bit fingerprint of each group's (sorted) tid
    # list. Position-in-group via repeat (cumsum over a 17M bool + a 17M
    # gather cost more); c2 derives from c1 with shift/xor/add only —
    # 64-bit multiplies are scalar without AVX512DQ, so each one saved is
    # a full slow pass over the pair stream.
    pos = np.arange(keys.size, dtype=np.int64) - np.repeat(starts, group_len)
    t64 = tids.astype(np.uint64)
    p64 = pos.astype(np.uint64)
    c1 = _mix64(t64 * _M3 + p64)
    c2 = c1 ^ (c1 >> np.uint64(29)) ^ (t64 << np.uint64(31)) ^ _M2
    h1 = np.add.reduceat(c1, starts) if starts.size else np.empty(0, np.uint64)
    h2 = np.add.reduceat(c2, starts) if starts.size else np.empty(0, np.uint64)

    # fold the group length into the fingerprints (the order-sensitive
    # sums already encode membership; the explicit fold is free) and group
    # by 2-key lexsort: np.unique(axis=0) views rows as void dtype and
    # memcmp-sorts them — measured ~3x slower at GENCODE scale.
    gl = group_len.astype(np.uint64)
    h1 = h1 ^ _mix64(gl * _M1)
    h2 = h2 + _mix64(gl ^ _M2)
    order = np.lexsort((h2, h1))
    a, b = h1[order], h2[order]
    new_ec = np.ones(a.size, dtype=bool)
    new_ec[1:] = (a[1:] != a[:-1]) | (b[1:] != b[:-1])
    ec_sorted = np.cumsum(new_ec) - 1
    key_ec = np.empty(a.size, np.int64)
    key_ec[order] = ec_sorted
    key_ec = key_ec.astype(np.int32)
    first_idx = order[np.flatnonzero(new_ec)]

    # EC member lists from each EC's first key group.
    ec_starts = starts[first_idx]
    ec_lens = group_len[first_idx]
    ec_offsets = np.zeros(first_idx.size + 1, dtype=np.int64)
    np.cumsum(ec_lens, out=ec_offsets[1:])
    gather = ec_starts.repeat(ec_lens) + (
        np.arange(int(ec_offsets[-1]), dtype=np.int64)
        - ec_offsets[:-1].repeat(ec_lens)
    )
    ec_transcripts = tids[gather].astype(np.int32)
    out = (unique_keys, key_ec, ec_offsets.astype(np.int32), ec_transcripts)
    if return_key_rank:
        return out + (key_rank,)
    return out


def build_bucket_table(
    hi: np.ndarray,
    lo: np.ndarray,
    vals: np.ndarray,
    n_buckets: int,
    bucket: int,
    hash_fn,
    aux: Optional[np.ndarray] = None,
    return_placement: bool = False,
) -> Tuple[np.ndarray, ...]:
    """Place keys in their home bucket (hash & (n_buckets-1)); a bucket holds
    ``bucket`` slots. Keys that do not fit (home bucket full) are returned as
    the overflow mask, NOT placed — the caller routes them to the stash.

    Returns (table int32[n_buckets*bucket, 4], overflow_mask). Fully
    vectorized: sort by home bucket, rank within the bucket group, keep
    rank < bucket. ``return_placement`` appends (slot, src): placed key
    ``src[i]`` landed in table slot ``slot[i]`` — callers fill extra
    per-slot payload arrays (e.g. the FLD position tables) without a
    key->slot search pass.
    """
    mask = np.uint32(n_buckets - 1)
    homes = (hash_fn(hi.view(np.uint32), lo.view(np.uint32)) & mask).astype(
        np.int64
    )
    order = np.argsort(homes, kind="stable")
    hs = homes[order]
    idx = np.arange(hs.size, dtype=np.int64)
    first = np.ones(hs.size, dtype=bool)
    first[1:] = hs[1:] != hs[:-1]
    group_start = np.maximum.accumulate(np.where(first, idx, 0))
    rank = idx - group_start
    keep = rank < bucket

    overflow = np.zeros(hi.size, dtype=bool)
    overflow[order[~keep]] = True

    slot = hs[keep] * bucket + rank[keep]
    src = order[keep]
    table = np.full((n_buckets * bucket, 4), EMPTY, dtype=np.int32)
    table[slot, 0] = hi[src]
    table[slot, 1] = lo[src]
    table[slot, 2] = vals[src]
    table[slot, 3] = 0 if aux is None else aux[src]
    if return_placement:
        return table, overflow, slot, src
    return table, overflow


def build_tables(
    unique_keys: np.ndarray, key_ec: np.ndarray, k: int, cfg: IndexConfig,
    aux: Optional[np.ndarray] = None,
    fld: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> dict:
    """Bucketized 2-choice tables: every key lives in its main home bucket
    or (if that bucket is full) its stash home bucket — so a device lookup
    is exactly one bucket gather, plus one compacted stash gather for the
    rare overflow lanes (ops/probe.py). ``aux`` (per-key EC run lengths)
    is written at placement time — a separate fill pass cost a
    searchsorted over every occupied slot (31 s at GENCODE scale).
    ``fld`` = per-key (utid, upos) unique-occurrence payload (map/fld.py),
    scattered into per-slot arrays by the same placement."""
    hi, lo = split_key(unique_keys, k)
    n = unique_keys.size
    G = cfg.bucket_size
    n_buckets = _next_pow2(
        max(int(np.ceil(n / (cfg.load_factor * G))), 2)
    )
    table, overflow, slot, src = build_bucket_table(
        hi, lo, key_ec, n_buckets, G, hash_kmer, aux=aux,
        return_placement=True)
    n_over = int(overflow.sum())
    log.info(
        "main table: %d keys, %d buckets x %d (load %.2f), %d stashed (%.2g)",
        n, n_buckets, G, n / (n_buckets * G), n_over,
        n_over / max(n, 1),
    )

    s_hi, s_lo, s_val = hi[overflow], lo[overflow], key_ec[overflow]
    s_aux = None if aux is None else aux[overflow]
    stash_buckets = _next_pow2(
        max(cfg.stash_min_slots // G,
            int(np.ceil(max(n_over, 1) / (cfg.stash_load * G))), 2)
    )
    while True:
        stash, s_over, s_slot, s_src = build_bucket_table(
            s_hi, s_lo, s_val, stash_buckets, G, hash_kmer_stash, aux=s_aux,
            return_placement=True,
        )
        if not s_over.any():
            break
        stash_buckets *= 2  # extremely unlikely at stash_load

    out = dict(
        table=table,
        main_slots=n_buckets * G,
        stash=stash,
        stash_slots=stash_buckets * G,
        bucket=G,
    )
    if fld is not None:
        utid, upos = fld
        S = n_buckets * G + stash_buckets * G
        fld_tid = np.full(S, -1, np.int32)
        fld_pos = np.zeros(S, np.int32)
        fld_tid[slot] = utid[src]
        fld_pos[slot] = upos[src]
        over_idx = np.flatnonzero(overflow)
        fld_tid[n_buckets * G + s_slot] = utid[over_idx[s_src]]
        fld_pos[n_buckets * G + s_slot] = upos[over_idx[s_src]]
        out["fld_tid"] = fld_tid
        out["fld_pos"] = fld_pos
    return out


def build_index(
    fasta_path: str,
    gtf_path: Optional[str] = None,
    cfg: IndexConfig = IndexConfig(),
) -> KMerIndex:
    """End-to-end index build: FASTA (+GTF) -> KMerIndex."""
    from ..io.fasta import read_fasta
    from ..io.gtf import transcript_gene_map

    names, seqs = [], []
    for name, seq in read_fasta(fasta_path):
        names.append(name)
        seqs.append(seq)
    return build_index_from_seqs(names, seqs, gtf_path=gtf_path, cfg=cfg)


def compute_run_lengths(
    seqs: list[str], unique_keys: np.ndarray, key_ec: np.ndarray, k: int,
    cap: int = 127, kmer_stream=None, position_ranks=None,
) -> np.ndarray:
    """Per-k-mer EC-run guarantee ``d``: for every occurrence of the k-mer,
    in every transcript and either direction, the ``d`` adjacent windows
    have the SAME EC. Stored in the table's aux column, it lets the device
    probe sampled positions and provably skip the windows in between
    (the exact-semantics replacement for the reference mapper's skipping
    heuristic, SURVEY.md 3.3/7.4).
    """
    d_min = np.full(unique_keys.size, cap, dtype=np.int32)
    if not seqs:
        return d_min
    # one pass over the separator-joined transcriptome: separator windows
    # are invalid (ec = -1) and break runs exactly at transcript borders.
    # ``kmer_stream`` (keys, valid) lets the caller reuse the pass already
    # done by collect_kmer_pairs; ``position_ranks`` (pos, krank) — the
    # valid window positions and their unique-key ranks from
    # group_equivalence_classes(return_key_rank=True) — replaces the
    # per-window searchsorted (94 s of a 234 s GENCODE build) with two
    # O(P) gathers.
    if position_ranks is not None:
        pos, krank = position_ranks
        if kmer_stream is not None:
            P = kmer_stream[1].size
        else:
            codes, _ = _concat_codes(list(seqs))
            P = codes.size - k + 1
        ec = np.full(P, -1, dtype=np.int64)
        ec[pos] = key_ec[krank]
        ki_valid = krank
        valid_idx = pos
    else:
        if kmer_stream is not None:
            keys, valid = kmer_stream
        else:
            codes, _ = _concat_codes(list(seqs))
            keys, valid = canonical_kmers(codes, k)
        ki = np.searchsorted(unique_keys, keys)
        ki = np.minimum(ki, max(unique_keys.size - 1, 0))
        present = valid & (unique_keys[ki] == keys)
        ec = np.where(present, key_ec[ki], -1)
        ki_valid = ki[present]
        valid_idx = np.flatnonzero(present)
    P = ec.size
    change = np.ones(P, dtype=bool)
    change[1:] = ec[1:] != ec[:-1]
    starts = np.flatnonzero(change)
    run_len = np.diff(np.append(starts, P))
    # per-position run geometry via repeat (no cumsum/gather passes)
    pos_in_run = np.arange(P, dtype=np.int64) - np.repeat(starts, run_len)
    d_fwd = np.repeat(run_len, run_len) - 1 - pos_in_run
    d_bwd = pos_in_run
    d = np.minimum(np.minimum(d_fwd, d_bwd), cap).astype(np.int32)
    # per-key min via ONE value sort of (key_index << 7 | d): the first
    # entry of each key group carries its minimum d (d <= cap < 128).
    # An argsort-based reduceat costs ~6x more at GENCODE scale.
    m = (ki_valid.astype(np.int64) << 7) | d[valid_idx]
    m.sort()
    kk = m >> 7
    first = np.ones(kk.size, dtype=bool)
    first[1:] = kk[1:] != kk[:-1]
    fi = np.flatnonzero(first)
    if fi.size:
        kf = kk[fi]
        d_min[kf] = np.minimum(d_min[kf], (m[fi] & 127).astype(np.int32))
    return d_min


def build_index_from_seqs(
    names: list[str],
    seqs: list[str],
    gtf_path: Optional[str] = None,
    cfg: IndexConfig = IndexConfig(),
    genes: Optional[list[str]] = None,
) -> KMerIndex:
    # one canonical-k-mer pass over the separator-joined transcriptome,
    # shared by pair collection and the run-length pass
    seqs = list(seqs)
    lengths = np.fromiter((len(s_) for s_ in seqs), np.int32,
                          len(seqs)) if seqs else np.empty(0, np.int32)
    if seqs:
        codes, starts = _concat_codes(seqs)
        all_keys, all_valid = canonical_kmers(codes, cfg.k)
        pos = np.flatnonzero(all_valid)
        keys = all_keys[pos]
        tids = (np.searchsorted(starts, pos, side="right") - 1).astype(
            np.int32)
    else:
        all_keys = np.empty(0, np.uint64)
        all_valid = np.empty(0, bool)
        keys = np.empty(0, np.uint64)
        tids = np.empty(0, np.int32)
        pos = np.empty(0, np.int64)
    log.info("collected %d k-mer pairs from %d transcripts", keys.size, len(names))
    unique_keys, key_ec, ec_offsets, ec_transcripts, krank = (
        group_equivalence_classes(keys, tids, return_key_rank=True))
    log.info("%d distinct %d-mers in %d equivalence classes",
             unique_keys.size, cfg.k, ec_offsets.size - 1)
    aux = None
    if cfg.run_length_aux:
        aux = compute_run_lengths(seqs, unique_keys, key_ec, cfg.k,
                                  kmer_stream=(all_keys, all_valid),
                                  position_ranks=(pos, krank))
    fld = None
    if cfg.fld_positions and keys.size:
        # Per-slot payload for fragment-length estimation (map/fld.py):
        # k-mers occurring EXACTLY ONCE in the whole transcriptome pin an
        # unambiguous (transcript, position); a read-pair whose mates both
        # hit such k-mers in the same transcript yields one observed
        # fragment length.
        occ = np.bincount(krank, minlength=unique_keys.size)
        utid = np.full(unique_keys.size, -1, np.int32)
        upos = np.zeros(unique_keys.size, np.int32)
        w = np.flatnonzero(occ[krank] == 1)
        utid[krank[w]] = tids[w]
        upos[krank[w]] = (pos[w] - starts[tids[w]]).astype(np.int32)
        fld = (utid, upos)
        log.info("FLD payload: %d globally-unique k-mers (%.0f%%)",
                 int((utid >= 0).sum()),
                 100.0 * (utid >= 0).mean())
    tables = build_tables(unique_keys, key_ec, cfg.k, cfg, aux=aux, fld=fld)

    if genes is not None:
        genes = np.array(genes)
    elif gtf_path is not None:
        from ..io.gtf import transcript_gene_map

        t2g = transcript_gene_map(gtf_path)
        genes = np.array([t2g.get(n, "NA") for n in names])

    return KMerIndex(
        k=cfg.k,
        ec_offsets=ec_offsets,
        ec_transcripts=ec_transcripts,
        names=np.array(names),
        lengths=lengths,
        genes=genes,
        **tables,
    )
