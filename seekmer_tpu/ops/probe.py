"""Loop-free bucketized k-mer lookup on device.

Replaces the reference mapper's per-k-mer hash-probe walk (SURVEY.md call
stack 3.3) with static dataflow:

  * the index guarantees every key lives in its home bucket of the main
    table OR its home bucket of the stash (index/build.py), so a lookup is
    ONE wide bucket gather + vectorized compare;
  * buckets are large (32 slots) so a FULL home bucket — the only case
    that must consult the stash — is vanishingly rare;
  * the rare stash lanes are BLOCK-compacted: per-32-lane-block need flags
    (N/32 of them) drive the compaction instead of per-lane scatters, so
    the second gather costs O(needy blocks), not O(N).

Absence needs no empty-slot scanning: no match in both home buckets proves
the key is not indexed. No while_loop, no probe rounds — static dataflow
that XLA pipelines freely.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .hash import hash_kmer, hash_kmer_stash

EMPTY = jnp.int32(-1)
MISS = jnp.int32(-1)

_BLK = 32  # block-compaction granularity (lanes)

# ec and aux (EC run length, <= 127) share one int32 lane in the device
# layout: ecaux = ec << AUX_BITS | aux, -1 for empty slots. One select+max
# pass then recovers both, instead of one (N, bucket)-shaped pass over
# the gathered rows per field.
AUX_BITS = 7
AUX_MASK = (1 << AUX_BITS) - 1
MAX_EC_ID = (1 << (31 - AUX_BITS)) - 1  # 16.7M ECs (GENCODE needs ~1M)


def device_table_layout(table, bucket: int):
    """Host (S, 4) rows [hi, lo, ec, aux] -> at-rest device layout
    (n_buckets, 4*bucket): struct-of-arrays slabs
    ``[hi x G | lo x G | ecaux x G | meta x G]`` per bucket row.

    Contiguous slabs let the compare read each field directly instead of
    de-interleaving (hi, lo, ec, aux) quads from the gathered row. The
    meta slab broadcasts the per-bucket FULL flag; the lookup does not
    read it (fullness rides the match reduce's 3-state encoding, see
    _bucket_lookup), so it is dead bytes kept until the row layout is
    re-measured on the GPU."""
    S = table.shape[0]
    rows = np.asarray(table).reshape(S // bucket, bucket, 4)
    hi, lo, ec, aux = (rows[:, :, i] for i in range(4))
    occ = hi != int(EMPTY)
    if occ.any() and int(ec[occ].max()) > MAX_EC_ID:
        raise ValueError(
            f"EC id {int(ec[occ].max())} exceeds the packed-lane limit "
            f"{MAX_EC_ID} (ecaux = ec << {AUX_BITS} | aux)")
    ecaux = np.where(
        occ, (ec << AUX_BITS) | np.clip(aux, 0, AUX_MASK), -1
    ).astype(np.int32)
    meta = np.broadcast_to(
        occ.all(axis=1)[:, None], hi.shape).astype(np.int32)
    return np.concatenate(
        [hi, lo, ecaux, meta], axis=1).astype(np.int32)


def _bucket_lookup(hi, lo, table, slots: int, bucket: int, hash_fn):
    """One bucket gather + slab compare. hi/lo: int32[N]; table in the
    (n_buckets, 4*bucket) slab device layout (device_table_layout).

    Returns (ec, aux, found, full): ec int32[N] (MISS if absent), aux
    int32[N] (the matched row's aux lane, e.g. EC run length; 0 if
    absent), ``full`` marks lanes whose home bucket has no empty slot
    (lookup must consult the stash when not found).
    """
    nb = slots // bucket
    G = bucket
    hb = (hash_fn(hi.astype(jnp.uint32), lo.astype(jnp.uint32))
          & jnp.uint32(nb - 1)).astype(jnp.int32)
    rows = table[hb]  # (N, 4G) — one wide gather, slabs sliced below
    hi_slab = rows[:, :G]
    match = (hi_slab == hi[:, None]) & (rows[:, G:2 * G] == lo[:, None])
    # One 3-state max-reduce yields match payload, found, AND fullness:
    #   matched slot  -> its ecaux (>= 0; <= 1 slot can match)
    #   empty slot    -> -1   (hi lane is EMPTY; real keys pack <= 30 bits)
    #   occupied slot -> -2
    # max >= 0 = found; max == -2 = no match AND no empty slot = the home
    # bucket is full, consult the stash. Reading the broadcast meta lane
    # instead would add a second, narrow gather; this encoding rides the
    # reduce already being done.
    lane_val = jnp.where(
        match, rows[:, 2 * G:3 * G],
        jnp.where(hi_slab == EMPTY, MISS, jnp.int32(-2)))
    m = jnp.max(lane_val, axis=1)
    found = m >= 0
    ec = jnp.where(found, m >> AUX_BITS, MISS)
    aux = jnp.where(found, m & AUX_MASK, 0)
    full = m == jnp.int32(-2)
    return ec, aux, found, full


def block_compact(blk_need, max_blocks: int):
    """Compact needy 32-lane blocks (by per-BLOCK flags, not per-lane).

    Args:
      blk_need: bool[NB] per-block need flags (NB = N // 32).
      max_blocks: static cap on compacted blocks per round.

    Returns (lane_idx int32[max_blocks*32] source lane per compacted slot
    (N for filler slots), residual_blocks bool[NB] needy blocks beyond the
    cap — the caller loops on them, so the cap bounds per-round cost
    without capping coverage).

    Everything here is NB-shaped: a per-lane formulation costs ~3 full
    passes over the N lanes (block-any, block-sum, and a repeat+mask
    residual reconstruction). Callers compute blk_need with ONE N-pass
    and carry residual state at block granularity.
    """
    NB = blk_need.shape[0]
    N = NB * _BLK
    rank = jnp.cumsum(blk_need.astype(jnp.int32)) - 1
    ok = blk_need & (rank < max_blocks)
    residual_blocks = blk_need & ~ok
    pos = jnp.where(ok, rank, max_blocks)
    cb = jnp.full(max_blocks + 1, NB, jnp.int32).at[pos].set(
        jnp.arange(NB, dtype=jnp.int32), mode="drop")
    lane_idx = (cb[:max_blocks, None] * _BLK
                + jnp.arange(_BLK, dtype=jnp.int32)[None, :]).reshape(-1)
    lane_idx = jnp.minimum(lane_idx, N)  # filler blocks point past the end
    return lane_idx, residual_blocks


def _pad_to_block(x, fill):
    N = x.shape[0]
    Np = -(-N // _BLK) * _BLK
    if Np == N:
        return x
    return jnp.concatenate([x, jnp.full(Np - N, fill, x.dtype)])


def lookup_ecs_aux(
    hi, lo, valid, table, main_slots: int, stash, stash_slots: int,
    bucket: int, chunks: int = 1,
):
    """Bucketized lookup returning (ec, aux) with aux = the per-k-mer EC
    run length written by the index builder. Any input lane shape.

    ``chunks`` > 1 processes the lanes in that many sequential chunks
    (lax.map), bounding the gathered-rows transient — one bucket row is
    4*bucket int32 per lane, which reaches GBs for GENCODE-scale batches.
    """
    shape = hi.shape
    hi_f = hi.reshape(-1)
    lo_f = lo.reshape(-1)
    valid_f = valid.reshape(-1)
    N = hi_f.shape[0]

    if chunks > 1:
        Np = -(-N // (chunks * _BLK)) * (chunks * _BLK)
        pad = Np - N

        def padded(x, fill):
            return jnp.concatenate(
                [x, jnp.full(pad, fill, x.dtype)]).reshape(chunks, -1)

        def one(args):
            h, l, v = args
            return _lookup_flat(h, l, v, table, main_slots, stash,
                                stash_slots, bucket)

        ec_c, aux_c = jax.lax.map(
            one, (padded(hi_f, 0), padded(lo_f, 0), padded(valid_f, False)))
        return (ec_c.reshape(-1)[:N].reshape(shape),
                aux_c.reshape(-1)[:N].reshape(shape))

    ec, aux = _lookup_flat(hi_f, lo_f, valid_f, table, main_slots, stash,
                           stash_slots, bucket)
    return ec.reshape(shape), aux.reshape(shape)


def _lookup_flat(hi_f, lo_f, valid_f, table, main_slots: int, stash,
                 stash_slots: int, bucket: int):
    """Full lookup over flat lanes: home-bucket match + rare compacted
    stash pass."""
    N = hi_f.shape[0]
    ec, aux, found, full = _bucket_lookup(hi_f, lo_f, table, main_slots,
                                          bucket, hash_kmer)
    hit = valid_f & found
    ec = jnp.where(hit, ec, MISS)
    aux = jnp.where(hit, aux, 0)

    need0 = _pad_to_block(valid_f & ~found & full, False)
    Np = need0.shape[0]
    # Cap sized ~5x above the expected full-bucket rate (~2e-4 at load 0.5
    # with 32-slot buckets => ~N*2e-4 needy lanes, worst case one per
    # block). The compacted gather+scatter cost is the STATIC cap size, so
    # an oversized cap dominates the probe stage. Coverage is NOT capped:
    # one compacted round runs unconditionally, and residual needy blocks
    # (essentially never at the 5x margin; possible for tiny adversarial
    # tables) are drained by a while_loop over further capped rounds. The
    # common path touches the N lanes exactly once (the per-block any);
    # residual state is block-granular (see block_compact).
    max_blocks = max(Np // _BLK // 64, 16)
    blk_need0 = need0.reshape(Np // _BLK, _BLK).any(axis=1)

    def stash_round(state):
        ec, aux, blk_need = state
        lane_idx, residual_blocks = block_compact(blk_need, max_blocks)
        li = jnp.minimum(lane_idx, N - 1)
        c_hi = hi_f[li]
        c_lo = lo_f[li]
        c_need = need0[jnp.minimum(lane_idx, Np - 1)] & (lane_idx < N)
        ec2, aux2, found2, _ = _bucket_lookup(
            c_hi, c_lo, stash, stash_slots, bucket, hash_kmer_stash)
        write = c_need & found2
        dst = jnp.where(write, lane_idx, N)  # N is out of bounds -> dropped
        ec = ec.at[dst].set(jnp.where(write, ec2, 0), mode="drop")
        aux = aux.at[dst].set(jnp.where(write, aux2, 0), mode="drop")
        return ec, aux, residual_blocks

    ec, aux, residual_blocks = stash_round((ec, aux, blk_need0))
    ec, aux, _ = jax.lax.while_loop(
        lambda s: s[2].any(), stash_round, (ec, aux, residual_blocks))
    return ec, aux


def lookup_ecs(
    hi, lo, valid, table, main_slots: int, stash, stash_slots: int,
    bucket: int, chunks: int = 1,
):
    """k-mer (hi, lo) lanes -> EC ids (MISS = -1 for absent/invalid)."""
    ec, _ = lookup_ecs_aux(hi, lo, valid, table, main_slots, stash,
                           stash_slots, bucket, chunks=chunks)
    return ec


def two_phase_signatures(
    hi, lo, valid, segments, pack_fn, table, main_slots: int, stash,
    stash_slots: int, bucket: int, stride: int, max_ecs: int, sig_fn,
    sig_pad, chunks: int = 1,
    fallback_frac: float = 1.0 / 8, seg_widths=None,
    fallback_chunks: int = 1, _stage: str = "full",
    lookup_fn=None, residual_agree=None,
):
    """Two-phase early-exit probing — the opt-in fast mode
    (MapConfig.probe_sample; round-4 verdict item 1a). Attacks LANE
    COUNT: the probe's cost grows with the number of windows gathered,
    while most reads lie inside one EC run and are determined by a few
    windows.

    Phase 1 probes every ``stride``-th window (plus the last) of each
    SEGMENT (mate). Resolution is per segment: a read resolves when
    every segment's sampled hits name at most ONE distinct EC (a
    zero-hit segment contributes nothing — the paired wildcard-mate
    semantics) and at least one segment hit; its signature is the
    sorted distinct set of the segments' ECs (so mates lying in
    DIFFERENT single-EC runs — the common isoform paired case —
    resolve without dense work). Reads with any multi-EC segment
    (junction reads — their dense signature could contain transition
    ECs between samples) or zero hits anywhere (short valid spans,
    heavy errors, junk) fall back to phase 2: every segment of a
    fallback read that is NOT single-EC (ambiguous or zero-hit — a
    zero-hit segment may still have hits between samples) is
    row-compacted and probed DENSELY; a fallback read's single-EC
    segments keep their sampled EC, carrying the same subset
    approximation as resolved reads.

    Approximation (documented, measured in benchmarks/configs.py
    --sample A/B): a resolved read's dense signature would contain MORE
    ECs only if a short EC run (< stride windows) lies strictly between
    two samples that agree — then the fast signature is a SUBSET of the
    dense one. No run-length proofs are used (the strided-exact mode,
    lookup_ecs_strided, does that); this trades that exactness for lane
    count on the unambiguous majority.

    Phase 2 runs as capped compacted rounds over (read, segment) UNITS
    with a residual while_loop, the same cost-bounding pattern as the
    stash pass — coverage is exact, only per-round cost is capped. Size
    fallback_frac above the workload's fallback fraction (config.py
    sample_fallback_frac): an extra while_loop ITERATION costs
    disproportionately (its scatters copy the staging buffer through
    the carried state, measured +9 ms/batch), while an oversized cap
    wastes its filler lanes' gathers (measured at GENCODE: frac 0.5 ran
    0.7x the speed of frac 0.125 at ~10% fallback).

    ``segments`` is a list of (codes uint8[B, L], lengths) pairs whose
    packed windows, concatenated, equal (hi, lo, valid) — one entry
    single-end, two for mates; ``seg_widths`` gives each segment's
    window-column count in that concatenation (defaults to one segment
    spanning all of P). Phase 2 gathers the compacted reads' RAW CODE
    ROWS (one cheap byte-row gather) and re-packs them with ``pack_fn``
    on device instead of gathering three int32 window-row arrays (3x
    the gather lanes; measured ~2x the round cost).

    Returns (sig int32[B, C], mapped bool[B]) — same contract as
    ``sig_fn(dense ecs)``.

    ``lookup_fn(h, l, v, chunks=...)`` overrides the EC lookup for both
    phases — the prefix-sharded mapper injects its all_to_all routed
    lookup here (round-5: SAMPLED ROUTING — phase 1 routes ~1/stride of
    the window lanes, the comms model's dominant term). ``residual_agree``
    maps the fallback loop's local continue flag to a collectively
    agreed one (psum over the index axis) so every shard executes the
    same number of routed rounds; None = single-device semantics.
    """
    B, P = hi.shape
    if lookup_fn is None:
        def lookup_fn(h, l, v, chunks=1):
            return lookup_ecs(h, l, v, table, main_slots, stash,
                              stash_slots, bucket, chunks=chunks)
    s = max(stride, 2)
    if seg_widths is None:
        seg_widths = [P]
    assert sum(seg_widths) == P, (seg_widths, P)

    # static per-segment sampled columns (every s-th + each segment's
    # last), gathered in ONE lookup call so the stash machinery is paid
    # once; bounds index the sampled array per segment
    cols, bounds, off, c0 = [], [], 0, 0
    for Pg in seg_widths:
        cg = list(range(off, off + Pg, s))
        if cg[-1] != off + Pg - 1:
            cg.append(off + Pg - 1)
        cols += cg
        bounds.append((c0, c0 + len(cg)))
        c0 += len(cg)
        off += Pg
    cols_a = jnp.asarray(cols, jnp.int32)

    ec_s = lookup_fn(hi[:, cols_a], lo[:, cols_a], valid[:, cols_a],
                     chunks=chunks)
    if _stage == "phase1":  # bisect hook (benchmarks/micro_fast.py):
        return ec_s, None   # sampled probe only
    hit = ec_s >= 0

    # per-segment classification: (zero-hit | single-EC) per segment,
    # >= 1 hit overall
    C = max_ecs
    n_seg = len(seg_widths)
    oks, mxs = [], []
    any_hit = None
    for (a, b) in bounds:
        h_g = hit[:, a:b]
        e_g = ec_s[:, a:b]
        mx_g = jnp.max(jnp.where(h_g, e_g, -1), axis=1)
        one_g = jnp.all(~h_g | (e_g == mx_g[:, None]), axis=1)
        oks.append((mx_g < 0) | one_g)
        mxs.append(mx_g)
        any_hit = ((mx_g >= 0) if any_hit is None
                   else (any_hit | (mx_g >= 0)))
    resolved = any_hit
    for ok_g in oks:
        resolved = resolved & ok_g

    # Every read's signature is assembled from a per-SEGMENT staging
    # buffer: a good segment contributes its single EC (or nothing when
    # zero-hit — the paired wildcard-mate rule); a bad segment stays PAD
    # until a fallback round overwrites it with its dense distinct set.
    # One uniform merge pass (sort / dedupe / cap over n_seg*C columns)
    # then builds sig+mapped for ALL reads — resolved and probed alike.
    staging = jnp.full((B, n_seg, C), sig_pad, jnp.int32)
    for g in range(n_seg):
        staging = staging.at[:, g, 0].set(
            jnp.where(oks[g] & (mxs[g] >= 0), mxs[g], jnp.int32(sig_pad)))

    # Fallback UNITS are (read, segment): only non-single-EC segments
    # re-probe (at GENCODE-isoform scale most fallback pairs have ONE
    # multi-EC mate, so this halves phase-2 lanes vs whole-pair rounds).
    # A fallback read's ZERO-HIT segments re-probe too — they may have
    # hits strictly between samples (round-4 advisor finding: skipping
    # them dropped those hits and contradicted the documented fallback
    # semantics); its single-EC segments keep their sampled EC (the
    # documented subset approximation). Segments with NO valid window at
    # all (pad rows, short/garbage mates) are excluded — their dense
    # probe returns nothing by construction (exact), and without the
    # exclusion every pad row burned fallback-cap units (round 5).
    seg_has_valid, off_v = [], 0
    for Pg in seg_widths:
        seg_has_valid.append(valid[:, off_v:off_v + Pg].any(axis=1))
        off_v += Pg
    unit_need = jnp.stack(
        [(~resolved) & (~oks[g] | (mxs[g] < 0)) & seg_has_valid[g]
         for g in range(n_seg)],
        axis=1)  # (B, n_seg)
    # a segment alone exceeding C distinct ECs makes the whole read
    # complex (union > C) even after merge truncation
    force_unmapped = jnp.zeros(B, jnp.int32)

    # pad segment code arrays to one width so a round can lane-select
    # the probed segment (mates may sit in different length buckets)
    Lmax = max(int(c.shape[1]) for c, _ in segments)
    segs_p = []
    for c, ln in segments:
        if int(c.shape[1]) < Lmax:
            c = jnp.pad(c, ((0, 0), (0, Lmax - int(c.shape[1]))),
                        constant_values=4)
        segs_p.append((c, ln))

    if _stage == "classify":  # bisect hook: + classification/staging
        return staging, unit_need

    U = B * n_seg
    # per-round unit cap: n_seg x the read-count cap keeps the per-round
    # LANE budget equal to the old whole-read rounds (a unit is 1/n_seg
    # of a read's windows)
    capu = max(int(B * fallback_frac) * n_seg, 128)

    def unit_round(state):
        staging, force_unmapped, need = state
        nf = need.reshape(-1)  # unit u = b * n_seg + g
        rank = jnp.cumsum(nf.astype(jnp.int32)) - 1
        ok = nf & (rank < capu)
        residual = (nf & ~ok).reshape(B, n_seg)
        pos = jnp.where(ok, rank, capu)
        umap = jnp.full(capu + 1, U, jnp.int32).at[pos].set(
            jnp.arange(U, dtype=jnp.int32), mode="drop")
        units = umap[:capu]  # source unit per compacted slot; U = filler
        ub = jnp.minimum(units // n_seg, B - 1)
        ug = units % n_seg
        real = (units < U)[:, None]
        c_sel, l_sel = None, None
        for g, (c, ln) in enumerate(segs_p):
            cg, lg = c[ub], ln[ub]
            if c_sel is None:
                c_sel, l_sel = cg, lg
            else:
                m = ug == g
                c_sel = jnp.where(m[:, None], cg, c_sel)
                l_sel = jnp.where(m, lg, l_sel)
        h, l, v = pack_fn(c_sel, l_sel)
        v = v & real
        # fallback_chunks bounds the gathered-bucket-rows transient of the
        # capu*window dense re-probe exactly as ``chunks`` bounds phase 1
        # (round-4 advisor finding: unchunked, a GENCODE-paired fallback
        # round's transient approached a half-batch dense probe's)
        ec_d = lookup_fn(h, l, v, chunks=fallback_chunks)
        sig_d, mapped_d = sig_fn(ec_d, v, C)
        fu = ((sig_d[:, 0] != sig_pad) & ~mapped_d).astype(jnp.int32)
        dstb = jnp.where(units < U, ub, B)  # B out of bounds -> dropped
        staging = staging.at[dstb, ug].set(sig_d, mode="drop")
        force_unmapped = force_unmapped.at[dstb].max(fu, mode="drop")
        return staging, force_unmapped, residual

    staging, force_unmapped, residual = unit_round(
        (staging, force_unmapped, unit_need))
    if _stage == "fallback1":  # bisect hook: + the first fallback round
        return staging, force_unmapped

    def residual_cond(st):
        more = st[2].any()
        return residual_agree(more) if residual_agree is not None else more

    staging, force_unmapped, _ = jax.lax.while_loop(
        residual_cond, unit_round, (staging, force_unmapped, residual))
    if _stage == "fallback":  # bisect hook: + the residual while_loop
        return staging, force_unmapped

    # uniform merge: sorted distinct of all segment contributions
    flat = jnp.sort(staging.reshape(B, n_seg * C), axis=1)
    if n_seg * C > 1:
        dup = jnp.concatenate(
            [jnp.zeros((B, 1), bool), flat[:, 1:] == flat[:, :-1]], axis=1)
        flat = jnp.sort(jnp.where(dup, jnp.int32(sig_pad), flat), axis=1)
    sig = flat[:, :C]
    over = (flat[:, C] != sig_pad) if n_seg * C > C else jnp.zeros(B, bool)
    mapped = (flat[:, 0] != sig_pad) & ~over & (force_unmapped == 0)
    return sig, mapped


def lookup_ecs_strided(
    hi, lo, valid, table, main_slots: int, stash, stash_slots: int,
    bucket: int, stride: int, chunks: int = 1,
):
    """Strided lookup with exact gap coverage via EC run lengths.

    Probes every ``stride``-th window (plus the last), then uses the aux
    run-length ``d`` of each hit — "d adjacent windows provably share this
    EC in every indexed context" — to fill the windows between samples.
    Gaps not covered from either side (sample missed, or d too small:
    error windows, EC-run boundaries) are block-compacted and probed
    densely, so the result equals the dense lookup except for reads whose
    error-windows collide with indexed k-mers (~1e-7 per window; see
    MapConfig.probe_stride). Uncovered lanes are contiguous runs, which is
    exactly what block compaction likes.

    Returns ec int32[B, P].
    """
    if stride <= 1:
        return lookup_ecs(hi, lo, valid, table, main_slots, stash,
                          stash_slots, bucket, chunks=chunks)
    B, P = hi.shape
    s = stride
    Ps = -(-P // s)  # samples at 0, s, ..., (Ps-1)*s

    def sample(x):
        return jnp.concatenate([x[:, ::s], x[:, P - 1 :]], axis=1)

    hi_s, lo_s, valid_s = sample(hi), sample(lo), sample(valid)
    ec_s, d_s = lookup_ecs_aux(hi_s, lo_s, valid_s, table, main_slots,
                               stash, stash_slots, bucket)

    pos = jnp.arange(P, dtype=jnp.int32)
    gap = pos // s
    pl = gap * s
    pr = jnp.minimum(pl + s, P - 1)

    def spread_left(x):
        # value of the left sample for every position (repeat, not gather)
        return jnp.repeat(x[:, :Ps], s, axis=1)[:, :P]

    def spread_right(x):
        # right sample of each gap: samples 1..Ps-1 then the extra (P-1)
        rs = jnp.concatenate([x[:, 1:Ps], x[:, Ps:]], axis=1)
        return jnp.repeat(rs, s, axis=1)[:, :P]

    ec_l, d_l = spread_left(ec_s), spread_left(d_s)
    ec_r, d_r = spread_right(ec_s), spread_right(d_s)
    dist_l = pos - pl
    dist_r = pr - pos

    cov_l = (ec_l >= 0) & (d_l >= dist_l)
    cov_r = (ec_r >= 0) & (d_r >= dist_r)
    is_sample = (pos % s == 0) | (pos == P - 1)

    # sampled positions keep their probed result exactly
    ec_sampled = jnp.where(dist_l == 0, ec_l, MISS)
    ec_sampled = jnp.where(pos == P - 1, ec_s[:, -1:], ec_sampled)
    fill = jnp.where(cov_l, ec_l, jnp.where(cov_r, ec_r, MISS))
    need = ~is_sample & ~cov_l & ~cov_r & valid

    N = B * P
    need_f = _pad_to_block(need.reshape(-1), False)
    Np = need_f.shape[0]
    max_blocks = max(Np // _BLK // 2, 16)
    blk_need0 = need_f.reshape(Np // _BLK, _BLK).any(axis=1)

    ec0 = jnp.where(is_sample, ec_sampled, fill)
    hi_f = hi.reshape(-1)
    lo_f = lo.reshape(-1)

    # one compacted dense-verification round always runs; residual needy
    # blocks beyond the cap (very high error rate / tiny run lengths)
    # drain through further capped rounds — exact coverage, block-granular
    # residual state (see _lookup_flat / block_compact)
    def gap_round(state):
        ec_flat, blk_need = state
        lane_idx, residual_blocks = block_compact(blk_need, max_blocks)
        li = jnp.minimum(lane_idx, N - 1)
        c_hi, c_lo = hi_f[li], lo_f[li]
        c_need = need_f[jnp.minimum(lane_idx, Np - 1)] & (lane_idx < N)
        ec_d = lookup_ecs(c_hi, c_lo, c_need, table, main_slots, stash,
                          stash_slots, bucket)
        dst = jnp.where(c_need, lane_idx, N)  # N out of bounds -> dropped
        return ec_flat.at[dst].set(ec_d, mode="drop"), residual_blocks

    ec_flat, residual_blocks = gap_round((ec0.reshape(-1), blk_need0))
    ec_flat, _ = jax.lax.while_loop(
        lambda s: s[1].any(), gap_round, (ec_flat, residual_blocks))
    ec = ec_flat.reshape(B, P)
    return jnp.where(valid, ec, MISS)