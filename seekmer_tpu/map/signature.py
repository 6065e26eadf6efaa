"""Per-read EC signatures and the device-resident signature count table.

This solves the hard design problem of SURVEY.md 7.5.1 — the reference
discovers per-read equivalence classes dynamically (a dict keyed by
transcript set in mapper.py); under XLA's static shapes we instead:

  1. reduce each read to its SIGNATURE: the sorted distinct index-EC ids of
     its k-mer hits, capped at C = max_ecs_per_read (two row-sorts);
  2. fingerprint the signature to 64 bits (two uint32 lanes);
  3. accumulate counts in a device-resident open-addressing table keyed by
     fingerprint, claimed with a compare-and-swap-via-scatter protocol:
     a lane scatters its key row into its probe slot, re-gathers, and only
     the lane that observes its own key has won the slot — correct under
     XLA's "one duplicate update wins whole-row" scatter semantics;
  4. transcript-set intersections are resolved once per DISTINCT signature
     on the host at finalize time (seekmer_tpu/map/driver.py), so host work
     scales with signature diversity, not read count.

The table stays on device across batches (donated argument), keeping the
host out of the hot loop entirely.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.hash import (
    sig_fingerprint_init,
    sig_fingerprint_step,
    sig_slot_hash,
)

# Sentinel EC id padding signature rows (sorts after every real EC id).
SIG_PAD = jnp.int32(0x7FFFFFFF)


# Slots per key bucket: one probe round gathers a whole 8-slot (64B) key
# bucket, so chains that would take up to 8 while_loop rounds resolve in
# one — the steady-state accumulate cost is round-dominated.
KB = 8


class SigTable(NamedTuple):
    """Device signature->count open-addressing table. Keys live in
    bucketized (KB-slot) rows so a probe round is ONE 64B-row gather;
    count/sig stay flat, indexed by slot = bucket*KB + lane. Each table
    has a trailing dump bucket/row absorbing scatters from inactive
    lanes."""

    key: jnp.ndarray  # int32[S/KB + 1, KB, 2] fingerprints; (0, 0) = empty
    count: jnp.ndarray  # int32[S+1]
    sig: jnp.ndarray  # int32[S+1, C] claimed signature rows
    overflow: jnp.ndarray  # int32[] reads lost to probe overflow
    collisions: jnp.ndarray  # int32[] reads whose signature row differed
    # from the stored row of the slot their fingerprint matched (64-bit
    # fingerprint collision -> counts of two distinct signatures merged)
    # Direct per-EC counts for SINGLE-EC signatures (the measured ~90%
    # majority): int32[E+1], last slot = dump. Exact — no fingerprint,
    # no CAS, no collision exposure — and ~4x cheaper than folding the
    # majority through the CAS (accumulate_direct). Shape (1,) = the
    # placeholder of a table built without num_ecs (fusion mode, old
    # checkpoints, micro-benches): every row then folds through the CAS.
    ec_count: jnp.ndarray


def make_sig_table(bits: int, max_ecs: int, num_ecs: int = 0) -> SigTable:
    """``num_ecs`` > 0 enables the direct per-EC count vector for
    single-EC signatures (fold_batch routes on its shape)."""
    if bits < 3:
        raise ValueError("sig_table_bits must be >= 3 (one KB=8 bucket)")
    S = 1 << bits
    return SigTable(
        key=jnp.zeros((S // KB + 1, KB, 2), jnp.int32),
        count=jnp.zeros(S + 1, jnp.int32),
        sig=jnp.full((S + 1, max_ecs), SIG_PAD),
        overflow=jnp.zeros((), jnp.int32),
        collisions=jnp.zeros((), jnp.int32),
        ec_count=jnp.zeros(num_ecs + 1 if num_ecs > 0 else 1, jnp.int32),
    )


def read_signatures(ecs: jnp.ndarray, valid: jnp.ndarray, max_ecs: int):
    """Per-read sorted distinct EC ids, capped.

    Args:
      ecs: int32[B, P] per-position EC ids (-1 = miss/invalid).
      valid: bool[B, P] position validity.
      max_ecs: C, signature capacity.

    Returns:
      (sig, mapped): int32[B, C] sorted distinct ids padded with SIG_PAD;
      bool[B] False where zero hits or > C distinct ids ("complex").
    """
    x = jnp.where(valid & (ecs >= 0), ecs, SIG_PAD)
    s = jnp.sort(x, axis=1)
    prev = jnp.concatenate([jnp.full_like(s[:, :1], -1), s[:, :-1]], axis=1)
    is_new = (s != prev) & (s != SIG_PAD)
    n_distinct = is_new.sum(axis=1)
    distinct = jnp.where(is_new, s, SIG_PAD)
    sig = jnp.sort(distinct, axis=1)[:, :max_ecs]
    if sig.shape[1] < max_ecs:  # short bucket: fewer windows than C
        pad = max_ecs - sig.shape[1]
        sig = jnp.pad(sig, ((0, 0), (0, pad)), constant_values=SIG_PAD)
    mapped = (n_distinct > 0) & (n_distinct <= max_ecs)
    return sig, mapped


def fingerprint(sig: jnp.ndarray):
    """64-bit fingerprint of each signature row. Returns (fp1, fp2) int32[B];
    the all-zero pair is remapped to (1, 0) so (0, 0) can mean 'empty slot'."""
    h1, h2 = sig_fingerprint_init()
    h1 = jnp.full(sig.shape[:1], h1, jnp.uint32)
    h2 = jnp.full(sig.shape[:1], h2, jnp.uint32)
    for c in range(sig.shape[1]):  # static unroll over C
        h1, h2 = sig_fingerprint_step(h1, h2, sig[:, c].astype(jnp.uint32))
    fp1 = h1.astype(jnp.int32)
    fp2 = h2.astype(jnp.int32)
    fp1 = jnp.where((fp1 == 0) & (fp2 == 0), jnp.int32(1), fp1)
    return fp1, fp2


def accumulate(table: SigTable, sig: jnp.ndarray, mapped: jnp.ndarray,
               weights: jnp.ndarray | None = None,
               sig_probe: int = 32, audit: bool = True) -> SigTable:
    """Fold one batch of read signatures into the device table.

    Every mapped lane runs the CAS protocol directly — no batch-local dedup
    pass is needed, because the protocol is idempotent under duplicate
    fingerprints: lanes sharing a fingerprint either all match an existing
    slot, or all observe the same post-claim row and "win" together, and
    the count update is a scatter-ADD (correct under duplicates). This
    removes a multi-operand batch sort from the hot path. Donate ``table``
    at the jit boundary for in-place updates.

    ``audit`` (static; MapConfig.collision_audit) re-gathers each resolved
    lane's stored signature row and counts reads whose row differs — the
    only observable trace of a 64-bit fingerprint collision silently
    merging two distinct signatures (odds ~U^2/2^64, config.py). One
    (B, C)-row gather + compare per batch.
    """
    B, C = sig.shape
    S = table.count.shape[0] - 1  # flat slots; last row is the dump slot
    NBK = table.key.shape[0] - 1  # key buckets; last bucket is the dump
    dump = jnp.int32(S)
    dump_b = jnp.int32(NBK)

    fp1, fp2 = fingerprint(sig)
    w = jnp.where(mapped, jnp.ones(B, jnp.int32) if weights is None else weights, 0)
    active0 = w > 0

    home = (sig_slot_hash(fp1.astype(jnp.uint32), fp2.astype(jnp.uint32))
            & jnp.uint32(NBK - 1)).astype(jnp.int32)
    keyrow = jnp.stack([fp1, fp2], axis=1)

    # The while loop carries ONLY the key table (the CAS target) plus
    # per-lane (B,) records — NOT count/sigtab. Those writes commute, so
    # each lane records the slot where it resolved (and whether it won a
    # claim) and one scatter-add / one sig-row scatter run after the loop.
    # Dragging the (S, C) signature table through the loop state measured
    # ~45 ms/batch at sig_table_bits=22 (buffer copies per probe round).
    # A probe round examines a whole KB-slot key bucket in one 64B-row
    # gather; the cursor advances to the next bucket only when the bucket
    # is FULL and unmatched (a claim loser retries the same bucket — it
    # may still hold empties, or now hold its own fingerprint).
    def cond(state):
        r, active, *_ = state
        return (r < sig_probe) & jnp.any(active)

    def body(state):
        r, active, key, cursor, res_slot, won_any = state
        rows = key[cursor]  # (B, KB, 2)
        match = (rows[:, :, 0] == fp1[:, None]) & (rows[:, :, 1] == fp2[:, None])
        is_empty = (rows[:, :, 0] == 0) & (rows[:, :, 1] == 0)
        matched = active & match.any(axis=1)
        slot_in = jnp.argmax(match, axis=1).astype(jnp.int32)
        has_empty = is_empty.any(axis=1)
        first_empty = jnp.argmax(is_empty, axis=1).astype(jnp.int32)
        try_claim = active & ~matched & has_empty

        def do_claim(key):
            # claim the bucket's first empty slot via scatter, re-gather
            # to see who won (the (2,) row update is atomic under XLA's
            # one-duplicate-wins scatter semantics)
            cb = jnp.where(try_claim, cursor, dump_b)
            key = key.at[cb, first_empty].set(keyrow)
            row2 = key[cb, first_empty]  # (B, 2)
            won = try_claim & (row2[:, 0] == fp1) & (row2[:, 1] == fp2)
            return key, won

        def no_claim(key):
            return key, jnp.zeros_like(try_claim)

        # steady state (all signatures already tabled) skips the claim
        # scatter + re-gather
        key, won = jax.lax.cond(try_claim.any(), do_claim, no_claim, key)

        resolved = matched | won
        res_slot = jnp.where(
            resolved,
            cursor * KB + jnp.where(matched, slot_in, first_empty),
            res_slot)
        won_any = won_any | won
        advance = active & ~resolved & ~has_empty
        cursor = jnp.where(advance, (cursor + 1) & jnp.int32(NBK - 1), cursor)
        return r + 1, active & ~resolved, key, cursor, res_slot, won_any

    r, active, key, _, res_slot, won_any = jax.lax.while_loop(
        cond, body,
        (jnp.int32(0), active0, table.key, home, jnp.full(B, dump),
         active0 & False)
    )
    resolved = active0 & ~active
    add_slot = jnp.where(resolved, res_slot, dump)
    count = table.count.at[add_slot].add(jnp.where(resolved, w, 0))

    # The winning-signature row scatter (and the dump-bucket key scrub it
    # necessitates) only matters in batches that CLAIMED a new slot; in
    # steady state (every signature already tabled) gating it saves a
    # B-row scatter per batch — measured 6.9 -> 3.7 ms steady-state
    # accumulate at B=64k, bits=20 (back-to-back A/B, 2026-08-20). Claim
    # batches where every claimant LOSES leave junk in the dump key
    # bucket unscrubbed, which is harmless: the probe cursor is always
    # < NBK, so the dump bucket is never gathered, and the dump COUNT
    # row (which table_to_host does consult) is scrubbed every batch.
    def write_rows(ops):
        key, sigtab = ops
        sigtab = sigtab.at[jnp.where(won_any, res_slot, dump)].set(sig)
        key = key.at[dump_b].set(jnp.zeros((KB, 2), jnp.int32))
        return key, sigtab

    key, sigtab = jax.lax.cond(won_any.any(), write_rows, lambda ops: ops,
                               (key, table.sig))
    count = count.at[dump].set(0)
    lost = jnp.where(active, w, 0).sum().astype(jnp.int32)
    collisions = table.collisions
    if audit:
        # Collision audit: every resolved lane re-reads its slot's stored
        # row and compares to its own signature. A mismatch means the lane
        # fingerprint-matched a slot claimed by a DIFFERENT signature (or
        # lost a same-batch double-claim to one) — its count was merged
        # into the wrong row. Unresolved lanes gather the dump row and are
        # masked by `resolved`.
        stored = sigtab[add_slot]
        mismatch = resolved & jnp.any(stored != sig, axis=1)
        collisions = collisions + jnp.where(mismatch, w, 0).sum().astype(
            jnp.int32)
    return table._replace(key=key, count=count, sig=sigtab,
                          overflow=table.overflow + lost,
                          collisions=collisions)


def accumulate_direct(table: SigTable, sig: jnp.ndarray,
                      mapped: jnp.ndarray,
                      weights: jnp.ndarray | None = None,
                      sig_probe: int = 32, audit: bool = True) -> SigTable:
    """Split accumulate (round 4): SINGLE-EC signature rows — the
    measured ~90% majority in both probe modes — count into the table's
    exact per-EC direct vector (one scatter-add, no fingerprint, no
    collision exposure), and only multi-EC rows fold through the CAS
    table (same batch shape, single rows weight-zeroed). Semantically
    identical count totals to plain accumulate; finalize merges the
    direct vector as [e] signature rows (table_to_host), deduplicating
    against any CAS-resident copies.

    An earlier form also row-COMPACTED the multi-EC minority into capped
    CAS rounds (to make the CAS cost scale with it); measured at GENCODE
    scale it REGRESSED 7% — the residual while_loop carries the (S, C)
    signature buffer (268 MB at bits=22) through its state — so the CAS
    runs at full batch shape and this split's value is the exactness of
    the majority path, not speed (both measured within noise of plain
    accumulate at config-1)."""
    B, C = sig.shape
    E1 = table.ec_count.shape[0]
    w = jnp.where(mapped,
                  jnp.ones(B, jnp.int32) if weights is None else weights, 0)
    single = (w > 0) & (sig[:, 0] != SIG_PAD)
    if C > 1:
        single = single & (sig[:, 1] == SIG_PAD)
    tgt = jnp.where(single, sig[:, 0], jnp.int32(E1 - 1))
    ec_count = table.ec_count.at[tgt].add(jnp.where(single, w, 0))
    ec_count = ec_count.at[E1 - 1].set(0)  # scrub the dump slot
    table = table._replace(ec_count=ec_count)
    return accumulate(table, sig, mapped & ~single,
                      weights=jnp.where(single, 0, w),
                      sig_probe=sig_probe, audit=audit)


def fold_batch(table: SigTable, sig: jnp.ndarray, mapped: jnp.ndarray,
               weights: jnp.ndarray | None = None, sig_probe: int = 32,
               audit: bool = True) -> SigTable:
    """Batch-fold dispatcher: accumulate_direct when the table carries a
    real per-EC vector (make_sig_table(num_ecs=...)), else the plain CAS
    accumulate (fusion-mode tables, placeholder tables)."""
    if table.ec_count.shape[0] > 1:
        return accumulate_direct(table, sig, mapped, weights=weights,
                                 sig_probe=sig_probe, audit=audit)
    return accumulate(table, sig, mapped, weights=weights,
                      sig_probe=sig_probe, audit=audit)


def direct_rows(ec_count: np.ndarray, C: int):
    """Host-side: nonzero per-EC direct counts -> ([e, PAD...] signature
    rows, counts). The dump (last) slot is excluded."""
    ec = np.asarray(ec_count)
    nz = np.flatnonzero(ec[:-1] > 0)
    rows = np.full((nz.size, C), int(SIG_PAD), np.int32)
    if nz.size:
        rows[:, 0] = nz.astype(np.int32)
    return rows, ec[nz].astype(np.int64)


def table_to_host(table: SigTable):
    """Pull occupied rows to host: (sigs int32[U, C], counts int64[U]).
    Includes the direct per-EC counts as single-EC rows; a signature
    present in BOTH stores (e.g. after restoring a pre-direct checkpoint)
    is deduplicated by the caller's merge (merge_sig_rows)."""
    count = np.asarray(table.count)
    sig = np.asarray(table.sig)
    occ = count > 0
    sigs, counts = sig[occ], count[occ].astype(np.int64)
    ec = np.asarray(table.ec_count)
    if ec.shape[0] > 1:
        drows, dcounts = direct_rows(ec, sig.shape[1])
        if drows.shape[0]:
            sigs = np.concatenate([sigs, drows])
            counts = np.concatenate([counts, dcounts])
    return sigs, counts
