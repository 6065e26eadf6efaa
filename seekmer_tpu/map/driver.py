"""Single-chip mapping driver: FASTQ batches -> device map step -> signature
table -> resolved EC counts (reference: seekmer mapper.py's batch pipeline +
count merge, SURVEY.md 2.1 C4/C6 and call stack 3.2).

The device step (pack -> probe -> signature -> accumulate) is one jitted
function per read-length bucket with the signature table donated, so steady
state runs with zero host<->device traffic per batch; the host only streams
and packs reads. Signature->transcript-set resolution happens once at the
end, scaling with signature diversity rather than read count.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Dict, Iterable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MapConfig
from ..index.store import KMerIndex
from ..io.fastq import ReadBatch
from ..ops.kmer_pack import pack_canonical
from ..ops.probe import lookup_ecs, lookup_ecs_strided
from .signature import (
    SigTable,
    fold_batch,
    make_sig_table,
    read_signatures,
    table_to_host,
)

log = logging.getLogger(__name__)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DeviceIndex:
    """Index tables resident on device (or sharded across a mesh).

    A registered pytree: the table arrays are children, the geometry ints
    are static aux data, so a DeviceIndex flows through jit / shard_map
    boundaries and sharding annotations directly.
    """

    table: jnp.ndarray  # (n_buckets, 4*bucket) device layout
    stash: jnp.ndarray
    main_slots: int = dataclasses.field(metadata=dict(static=True))
    stash_slots: int = dataclasses.field(metadata=dict(static=True))
    bucket: int = dataclasses.field(metadata=dict(static=True))
    k: int = dataclasses.field(metadata=dict(static=True))

    @classmethod
    def from_host(cls, index: KMerIndex, device=None) -> "DeviceIndex":
        from ..ops.probe import device_table_layout

        put = functools.partial(jax.device_put, device=device)
        return cls(
            table=put(device_table_layout(index.table, index.bucket)),
            stash=put(device_table_layout(index.stash, index.bucket)),
            main_slots=index.main_slots,
            stash_slots=index.stash_slots,
            bucket=index.bucket,
            k=index.k,
        )


def merge_sig_rows(sig: np.ndarray, count: np.ndarray, total_reads: int,
                   overflow: int, collisions: int = 0) -> "MapResult":
    """Merge raw signature-table rows (possibly from many chips/hosts) into
    a MapResult — the analog of the reference worker pool's join-time dict
    merge (SURVEY.md 2.1 C6), over distinct signatures.

    Vectorized: one lexsort over the occupied rows + reduceat, no Python
    per-signature loop (the round-1 dict version measured 2.4 s for the
    merge alone at 1M signatures; the full vectorized finalize runs
    merge+resolve in ~1 s — benchmarks/micro_finalize.py)."""
    occ = count > 0
    rows = np.ascontiguousarray(sig[occ])
    cnt = count[occ].astype(np.int64)
    C = sig.shape[1]
    if rows.shape[0] == 0:
        sigs = np.empty((0, C), np.int32)
        counts = np.empty(0, np.int64)
    else:
        order = np.lexsort(rows.T[::-1])
        rs, cs = rows[order], cnt[order]
        new = np.ones(rs.shape[0], bool)
        np.any(rs[1:] != rs[:-1], axis=1, out=new[1:])
        starts = np.flatnonzero(new)
        sigs = rs[starts]
        counts = np.add.reduceat(cs, starts)
    if overflow:
        log.warning("%d mapped reads lost to signature-table overflow; "
                    "increase MapConfig.sig_table_bits", overflow)
    if collisions:
        log.warning(
            "%d reads hit a 64-bit signature-fingerprint collision (their "
            "counts merged into a different signature's row); raising "
            "max_ecs_per_read does not help — this is the documented "
            "fingerprint approximation (config.py)", collisions)
    return MapResult(sigs=sigs, sig_counts=counts, total_reads=total_reads,
                     mapped=int(counts.sum()), overflow=overflow,
                     collisions=collisions)


@dataclasses.dataclass
class MapResult:
    """Host-side mapping summary: distinct signatures + statistics."""

    sigs: np.ndarray  # int32[U, C] sorted EC ids padded with SIG_PAD
    sig_counts: np.ndarray  # int64[U]
    total_reads: int
    mapped: int
    overflow: int  # mapped reads lost to signature-table overflow
    # reads whose counts were merged into a different signature's row by a
    # 64-bit fingerprint collision (detected by MapConfig.collision_audit)
    collisions: int = 0

    @property
    def unmapped(self) -> int:
        return self.total_reads - self.mapped - self.overflow


def audit_this_batch(cfg: MapConfig, fed_batches: int) -> bool:
    """Sampled collision auditing (config.py collision_audit_every):
    audit batch 0 and every Nth after — a collision persists in the
    table, so recurring colliders are caught by sampling while unaudited
    batches skip the (B, C)-row re-gather. Shared by all three mappers."""
    if not cfg.collision_audit:
        return False
    return fed_batches % max(cfg.collision_audit_every, 1) == 0


# Fast-mode fallback-cap grid for auto-sizing (sample_fallback_frac = 0).
# The cheapest cap is the smallest one that covers the workload's
# fallback fraction in ONE round (config.py sample_fallback_frac), so the
# grid is fine where that choice matters. Margin 1.1 over the observed
# fraction absorbs batch-to-batch drift; the residual while_loop keeps
# coverage exact if a batch still overflows.
FALLBACK_FRAC_GRID = (1 / 32, 1 / 16, 3 / 32, 1 / 8, 3 / 16, 1 / 4,
                      0.3, 0.35, 0.4, 0.45, 0.5, 0.6, 0.75, 1.0)


def _pick_fallback_frac(observed: float, batch_size: int) -> float:
    target = observed * 1.1 + 2.0 / max(batch_size, 1)
    for g in FALLBACK_FRAC_GRID:
        if g >= target:
            return g
    return 1.0


def _auto_probe_chunks(cfg: MapConfig, lanes: int, bucket: int) -> int:
    """probe_chunks == 0 picks the chunk count that bounds the gathered
    bucket-rows transient (4*bucket int32 per lane) to ~4 GB — oversized
    batches then probe in sequential chunks instead of OOMing HBM."""
    if cfg.probe_chunks > 0:
        return cfg.probe_chunks
    row_bytes = 4 * bucket * 4
    return max(1, -(-lanes * row_bytes // (4 << 30)))


def map_step(device_index: DeviceIndex, cfg: MapConfig, table: SigTable,
             codes, lengths, weights, codes2=None, lengths2=None,
             bad=None, bad2=None, pad_len=None, audit=None,
             fallback_frac=None, _probe_stage=None) -> SigTable:
    """One device mapping step (jit-traced per bucket shape).

    ``pad_len`` set (static) means ``codes``/``codes2`` arrive 2-bit
    packed with ``bad`` invalid-base bitmasks (MapConfig.h2d_pack_2bit,
    2.67x less H2D); they are unpacked exactly on-device first.

    ``audit`` (static) overrides cfg.collision_audit for this step — the
    drivers sample the audit every cfg.collision_audit_every batches.

    ``fallback_frac`` (static) is the RESOLVED fast-mode phase-2 cap
    fraction: the Mapper passes its auto-calibrated value here
    (config.py sample_fallback_frac = 0); None falls back to the config
    (or 0.125 when the config says auto and no calibration happened —
    the sharded mappers' path). ``_probe_stage`` (static) truncates the
    fast mode at a named stage and returns its raw output — the
    calibration probe (observed fallback fraction) and
    benchmarks/micro_fast.py's bisect ride this."""
    di = device_index
    stride = cfg.probe_stride
    if fallback_frac is None:
        fallback_frac = cfg.sample_fallback_frac or 0.125
    if audit is None:
        audit = cfg.collision_audit
    if pad_len is not None:
        from ..ops.kmer_pack import unpack_codes_2bit

        codes = unpack_codes_2bit(codes, bad, pad_len)
        if codes2 is not None:
            codes2 = unpack_codes_2bit(codes2, bad2, pad_len)

    def lk(h, l, v):
        chunks = _auto_probe_chunks(cfg, h.shape[0] * h.shape[1], di.bucket)
        return lookup_ecs_strided(h, l, v, di.table, di.main_slots,
                                  di.stash, di.stash_slots, di.bucket,
                                  stride, chunks=chunks)

    def two_phase(h, l, v, segments, seg_widths=None):
        from ..ops.probe import two_phase_signatures
        from .signature import SIG_PAD

        chunks = _auto_probe_chunks(
            cfg, h.shape[0] * (h.shape[1] // cfg.probe_sample + 1),
            di.bucket)
        # bound the phase-2 fallback rounds' transient the same way:
        # capu units x one segment's window count lanes per round
        n_seg = len(segments)
        capu = max(int(h.shape[0] * fallback_frac) * n_seg, 128)
        win_max = max(int(c.shape[1]) for c, _ in segments) - di.k + 1
        fb_chunks = _auto_probe_chunks(cfg, capu * win_max, di.bucket)
        return two_phase_signatures(
            h, l, v, segments, lambda c, ln: pack_canonical(c, ln, di.k),
            di.table, di.main_slots, di.stash, di.stash_slots,
            di.bucket, cfg.probe_sample, cfg.max_ecs_per_read,
            read_signatures, int(SIG_PAD), chunks=chunks,
            fallback_frac=fallback_frac, seg_widths=seg_widths,
            fallback_chunks=fb_chunks,
            _stage=_probe_stage or "full")

    # the fast mode covers the dense single/paired signature paths; the
    # strided-exact and fusion modes keep their own machinery
    sample_mode = (cfg.probe_sample >= 2 and stride <= 1
                   and not cfg.fusion_pairs)

    hi, lo, valid = pack_canonical(codes, lengths, di.k)
    if codes2 is not None:
        hi2, lo2, valid2 = pack_canonical(codes2, lengths2, di.k)
        P1 = hi.shape[1]
        if stride > 1:
            # strided mode fills gaps from neighboring samples' EC run
            # lengths — concatenated mates would let coverage leak across
            # the mate boundary (position P1-1/P1 are NOT adjacent genomic
            # windows), assigning wrong ECs to boundary windows. Probe
            # each mate separately.
            ecs = jnp.concatenate([lk(hi, lo, valid), lk(hi2, lo2, valid2)],
                                  axis=1)
        elif sample_mode:
            # fast mode on pairs: PER-MATE resolution (each mate zero-hit
            # or single-EC -> pair signature = sorted distinct of the
            # mates' ECs, the paired union semantics); any multi-EC mate
            # falls back to a dense probe of the whole pair
            out = two_phase(
                jnp.concatenate([hi, hi2], axis=1),
                jnp.concatenate([lo, lo2], axis=1),
                jnp.concatenate([valid, valid2], axis=1),
                [(codes, lengths), (codes2, lengths2)],
                seg_widths=[hi.shape[1], hi2.shape[1]])
            if _probe_stage:
                return out
            sig, mapped = out
            return fold_batch(table, sig, mapped, weights=weights,
                              sig_probe=cfg.sig_probe, audit=audit)
        else:
            # dense mode: both mates through ONE lookup call (windows
            # concatenated along the position axis) so the stash round +
            # residual loop machinery is paid once per batch, not per mate
            ecs = lk(jnp.concatenate([hi, hi2], axis=1),
                     jnp.concatenate([lo, lo2], axis=1),
                     jnp.concatenate([valid, valid2], axis=1))
        valid = jnp.concatenate([valid, valid2], axis=1)
        if cfg.fusion_pairs:
            # fusion mode: keep per-mate signatures side by side so
            # discordant pairs stay resolvable (fusion.py, SURVEY C12)
            sig1, mapped1 = read_signatures(ecs[:, :P1], valid[:, :P1],
                                            cfg.max_ecs_per_read)
            sig2, mapped2 = read_signatures(ecs[:, P1:], valid[:, P1:],
                                            cfg.max_ecs_per_read)
            sig = jnp.concatenate([sig1, sig2], axis=1)
            mapped = mapped1 & mapped2
            return fold_batch(table, sig, mapped, weights=weights,
                              sig_probe=cfg.sig_probe,
                              audit=audit)
        # paired-end: union of mates' EC hits [BASELINE.json:8 semantics]
    elif sample_mode:
        out = two_phase(hi, lo, valid, [(codes, lengths)])
        if _probe_stage:
            return out
        sig, mapped = out
        return fold_batch(table, sig, mapped, weights=weights,
                          sig_probe=cfg.sig_probe, audit=audit)
    else:
        ecs = lk(hi, lo, valid)
    sig, mapped = read_signatures(ecs, valid, cfg.max_ecs_per_read)
    return fold_batch(table, sig, mapped, weights=weights,
                      sig_probe=cfg.sig_probe, audit=audit)


class Mapper:
    """Stateful single-chip mapper: feed batches, then finalize."""

    def __init__(self, index: KMerIndex, cfg: MapConfig = MapConfig(),
                 device=None):
        self.index = index
        self.cfg = cfg
        self.device_index = DeviceIndex.from_host(index, device=device)
        sig_width = cfg.max_ecs_per_read * (2 if cfg.fusion_pairs else 1)
        # fusion rows hold per-mate signature halves, so the single-EC
        # direct path cannot read them — fusion tables get the placeholder
        # ec_count and fold everything through the CAS
        self.table = make_sig_table(
            cfg.sig_table_bits, sig_width,
            num_ecs=0 if cfg.fusion_pairs else index.num_ecs)
        self.total_reads = 0
        self._fed_batches = 0
        self._steps: Dict[Tuple[int, bool, bool, bool, float], callable] = {}
        # auto-calibrated fast-mode fallback cap (sample_fallback_frac=0):
        # measured on the first fast batch, then fixed for the run
        self._auto_frac: Optional[float] = None

    def _get_step(self, bucket: int, paired: bool, packed: bool = False,
                  audit: bool = True, fb_frac: Optional[float] = None):
        key = (bucket, paired, packed, audit, fb_frac)
        if key not in self._steps:
            cfg = self.cfg
            pad_len = bucket if packed else None

            # device_index is a real argument, NOT a closure: closed-over
            # arrays are baked into the program as constants and would be
            # copied into every compiled program.
            def fn(di, table, *args, **kwargs):
                return map_step(di, cfg, table, *args, pad_len=pad_len,
                                audit=audit, fallback_frac=fb_frac,
                                **kwargs)

            self._steps[key] = jax.jit(fn, donate_argnums=(1,))
        return self._steps[key]

    def _audit_this_batch(self) -> bool:
        return audit_this_batch(self.cfg, self._fed_batches)

    def _resolve_fallback_frac(self, batch: ReadBatch, paired: bool,
                               packed: bool) -> Optional[float]:
        """Fast-mode fallback cap for this run: the configured value, or
        (sample_fallback_frac = 0) one just-fitting cap auto-sized from
        THIS batch's observed fallback-unit fraction via a one-off
        classify-stage program (one extra compile + one scalar readback;
        config.py sample_fallback_frac)."""
        cfg = self.cfg
        if not (cfg.probe_sample >= 2 and cfg.probe_stride <= 1
                and not cfg.fusion_pairs):
            return None
        if cfg.sample_fallback_frac > 0:
            return cfg.sample_fallback_frac
        if self._auto_frac is not None:
            return self._auto_frac
        pad_len = batch.bucket if packed else None

        cfg_ = self.cfg

        def observe(di, table, *args, **kwargs):
            _, unit_need = map_step(di, cfg_, table, *args,
                                    pad_len=pad_len, audit=False,
                                    fallback_frac=1.0,
                                    _probe_stage="classify", **kwargs)
            return unit_need.sum()

        kwargs = self._batch_kwargs(batch, paired, packed)
        need = jax.jit(observe)(
            self.device_index, self.table, batch.codes, batch.lengths,
            batch.weights, **kwargs)
        n_seg = 2 if paired else 1
        observed = float(need) / (max(batch.n_real, 1) * n_seg)
        self._auto_frac = _pick_fallback_frac(observed, cfg.batch_size)
        log.info(
            "fast-mode fallback cap auto-sized: observed fallback-unit "
            "fraction %.3f -> sample_fallback_frac %.4g",
            observed, self._auto_frac)
        return self._auto_frac

    @staticmethod
    def _batch_kwargs(batch: ReadBatch, paired: bool, packed: bool) -> dict:
        kwargs = {}
        if paired:
            kwargs = dict(codes2=batch.codes2, lengths2=batch.lengths2)
        if packed:
            kwargs["bad"] = batch.bad
            if paired:
                kwargs["bad2"] = batch.bad2
        return kwargs

    def feed(self, batch: ReadBatch) -> None:
        paired = batch.codes2 is not None
        packed = batch.pad_len is not None
        fb_frac = self._resolve_fallback_frac(batch, paired, packed)
        step = self._get_step(batch.bucket, paired, packed,
                              self._audit_this_batch(), fb_frac)
        self._fed_batches += 1
        kwargs = self._batch_kwargs(batch, paired, packed)
        self.table = step(self.device_index, self.table, batch.codes,
                          batch.lengths, batch.weights, **kwargs)
        self.total_reads += batch.n_real

    def run(self, batches: Iterable[ReadBatch],
            checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 50) -> "MapResult":
        """Feed all batches; optionally checkpoint the signature table +
        resume cursor every N batches (SURVEY.md 5.3: batch-granular
        restart). Saves happen at the next CURSOR-BEARING batch after
        each interval — CheckpointableBatchSource attaches cursors only
        at batch boundaries where stream offsets and pending buffers are
        consistent."""
        return _run_with_checkpoints(self, batches, checkpoint_path,
                                     checkpoint_every)

    def save_checkpoint(self, path: str,
                        stream_state: Optional[dict] = None) -> None:
        from ..utils.checkpoint import save_map_checkpoint

        save_map_checkpoint(path, self.table, self.total_reads,
                            stream_state)

    def supports_checkpoint(self) -> bool:
        return True

    def restore_checkpoint(self, path: str) -> Optional[dict]:
        """Restore table + counters; returns the stream resume cursor
        (CheckpointableBatchSource.restore input), {} when the checkpoint
        exists but carries no cursor (table restored, stream position
        unknown — NOT safely resumable), or None if no checkpoint
        exists."""
        from ..utils.checkpoint import load_map_checkpoint

        loaded = load_map_checkpoint(path)
        if loaded is None:
            return None
        table, self.total_reads, stream_state = loaded
        from ..utils.checkpoint import adapt_ec_count

        self.table = adapt_ec_count(table, self.table.ec_count.shape)
        return stream_state if stream_state is not None else {}

    def make_fld_estimator(self):
        """Fragment-length estimator sharing this mapper's device table
        (map/fld.py), or None when the index lacks the FLD payload."""
        if self.index.fld_tid is None:
            return None
        from .fld import FLDEstimator

        return FLDEstimator(self.index, self.device_index)

    def finalize(self) -> MapResult:
        # merge_sig_rows dedups signatures present in BOTH the CAS table
        # and the direct per-EC vector (possible after restoring a
        # pre-direct checkpoint) and logs overflow/collision warnings
        sigs, counts = table_to_host(self.table)
        return merge_sig_rows(sigs, counts.astype(np.int64),
                              self.total_reads, int(self.table.overflow),
                              collisions=int(self.table.collisions))


def _group_member_lists(flat: np.ndarray, lens: np.ndarray,
                        counts: np.ndarray):
    """Group ragged SORTED member lists (CSR: flat values + group lengths)
    by identical content, summing counts. Returns (member_lists, counts).

    Same order-sensitive 128-bit fingerprint grouping as the index
    builder's EC construction (index/build.group_equivalence_classes) —
    collision odds ~G^2/2^128 for G groups. No Python per-group hashing;
    the only Python loop is np.split's list construction of the output.
    """
    from ..index.build import _M1, _M2, _M3, _mix64

    G = lens.size
    offs = np.zeros(G + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    pos = np.arange(flat.size, dtype=np.int64) - offs[:-1].repeat(lens)
    t64 = flat.astype(np.uint64)
    c1 = _mix64(t64 * _M3 + pos.astype(np.uint64))
    c2 = c1 ^ (c1 >> np.uint64(29)) ^ (t64 << np.uint64(31)) ^ _M2
    h1 = np.add.reduceat(c1, offs[:-1]) if G else np.empty(0, np.uint64)
    h2 = np.add.reduceat(c2, offs[:-1]) if G else np.empty(0, np.uint64)
    gl = lens.astype(np.uint64)
    h1 = h1 ^ _mix64(gl * _M1)
    h2 = h2 + _mix64(gl ^ _M2)

    order = np.lexsort((h2, h1))
    a, b = h1[order], h2[order]
    new = np.ones(G, bool)
    new[1:] = (a[1:] != a[:-1]) | (b[1:] != b[:-1])
    firsts = order[np.flatnonzero(new)]
    # sum counts per group via sorted segment reduce
    grp = np.cumsum(new) - 1
    gcounts = np.zeros(firsts.size, np.float64)
    np.add.at(gcounts, grp, counts[order])
    # representative member slice per group
    member_lists = [
        flat[offs[i]: offs[i] + lens[i]].astype(np.int32) for i in firsts
    ]
    return member_lists, gcounts


def _run_with_checkpoints(mapper, batches: Iterable[ReadBatch],
                          checkpoint_path: Optional[str],
                          checkpoint_every: int) -> "MapResult":
    """Shared feed loop with cursor-aware checkpointing (Mapper and the
    sharded mappers). A save becomes DUE every checkpoint_every batches
    and happens at the next batch carrying a resume cursor. Multi-process
    checkpointed runs go through the round-collective variant below."""
    import jax

    if checkpoint_path and jax.process_count() > 1:
        return _run_with_checkpoints_multiprocess(
            mapper, batches, checkpoint_path, checkpoint_every)
    n = 0
    due = False
    warned = False
    last_cursor = None
    for batch in batches:
        mapper.feed(batch)
        n += 1
        cur = getattr(batch, "cursor", None)
        if cur is not None:
            last_cursor = cur
        if checkpoint_path:
            due = due or (n % checkpoint_every == 0)
            if due and cur is not None:
                mapper.save_checkpoint(checkpoint_path, stream_state=cur)
                due = False
            elif due and last_cursor is None and not warned:
                log.warning(
                    "checkpointing requested but these batches carry no "
                    "resume cursors (not from CheckpointableBatchSource); "
                    "periodic checkpoints are disabled — a final "
                    "non-resumable table snapshot will still be written")
                warned = True
    if checkpoint_path:
        mapper.save_checkpoint(checkpoint_path, stream_state=last_cursor)
    return mapper.finalize()


def _run_with_checkpoints_multiprocess(mapper, batches, checkpoint_path,
                                       checkpoint_every) -> "MapResult":
    """Checkpointed feed loop when the mesh spans processes.

    save_checkpoint is COLLECTIVE (allgather + barriers), and hosts may
    stream DIFFERENT numbers of batches (per-host FASTQ shards; DP feeds
    do not synchronize processes), so nothing about the plain loop is
    naturally aligned — a host that exhausts its shard early while
    another still wants to save would deadlock the collectives (round-3
    review finding). This loop therefore makes the iteration itself
    collective: every host joins exactly one allgather per ROUND (one
    local batch per round while it has any), reporting (exhausted,
    has-cursor). The round counter is then globally consistent: saves
    trigger on it, only when every host has a cursor to save (exhausted
    hosts keep joining rounds and offer their final cursor), and every
    host leaves the loop in the same round. Costs one small host
    allgather per batch — only on checkpointed multi-process runs."""
    import numpy as _np

    from jax.experimental import multihost_utils

    it = iter(batches)
    r = 0
    due = False
    done = False
    warned = False
    last_cursor = None
    while True:
        batch = None if done else next(it, None)
        if batch is None:
            done = True
            cur = last_cursor
        else:
            mapper.feed(batch)
            cur = getattr(batch, "cursor", None)
            if cur is not None:
                last_cursor = cur
        r += 1
        # a done host offers its FINAL cursor; a host that never saw one
        # reports False — saving a None cursor for it would restore to
        # "start fresh" on top of a table already holding its reads
        # (double count; round-3 review finding)
        flags = _np.asarray(multihost_utils.process_allgather(
            _np.asarray([done, cur is not None])))
        if flags[:, 0].all():
            break
        due = due or (r % checkpoint_every == 0)
        if due and flags[:, 1].all():
            mapper.save_checkpoint(checkpoint_path, stream_state=cur)
            due = False
        elif due and not flags[:, 1].all() and not warned:
            # warn on EVERY host, naming the blockers: a cursorless host
            # blocks periodic saves for the whole mesh, and hosts with
            # valid cursors would otherwise silently never checkpoint
            # (round-3 advisor finding). May fire on a transient
            # no-cursor round; the message says saves resume when every
            # host offers one.
            blockers = _np.nonzero(~flags[:, 1])[0].tolist()
            log.warning(
                "periodic checkpoint is blocked: host process(es) %s "
                "offered no resume cursor this round (batches not from "
                "CheckpointableBatchSource, or none seen yet); saves "
                "happen only when every host has a cursor — a final "
                "table snapshot will still be written", blockers)
            warned = True
    mapper.save_checkpoint(checkpoint_path, stream_state=last_cursor)
    return mapper.finalize()


def resolve_signatures(
    result: MapResult, index: KMerIndex
) -> Tuple[List[np.ndarray], np.ndarray, int]:
    """Distinct signatures -> final ECs (distinct transcript intersections).

    Returns (member_lists, counts, dropped); dropped = reads whose EC
    intersection is empty. Host cost scales with #distinct signatures —
    and the dominant singleton path (signature IS an index EC) is fully
    vectorized: unique+bincount over EC ids, one CSR gather of their
    member slices, fingerprint-grouped with any multi-EC intersections
    (round 1 looped Python dicts per signature; see
    benchmarks/micro_finalize.py).
    """
    pad = np.int32(0x7FFFFFFF)
    sigs, cnts = result.sigs, result.sig_counts
    if sigs.size == 0:
        return [], np.empty(0, np.float64), 0
    n_ec = (sigs != pad).sum(axis=1)
    single = n_ec == 1
    off = index.ec_offsets.astype(np.int64)
    tr = index.ec_transcripts

    # singleton path: group identical EC ids, gather their member CSR
    uniq_ec, inv = np.unique(sigs[single, 0], return_inverse=True)
    ec_counts = np.bincount(inv, weights=cnts[single].astype(np.float64),
                            minlength=uniq_ec.size)
    s_start = off[uniq_ec]
    s_len = off[uniq_ec + 1] - s_start
    o = np.zeros(uniq_ec.size + 1, np.int64)
    np.cumsum(s_len, out=o[1:])
    gather = s_start.repeat(s_len) + (
        np.arange(int(o[-1]), dtype=np.int64) - o[:-1].repeat(s_len))
    s_flat = tr[gather].astype(np.int64)

    # multi-EC signatures (rare): per-distinct-signature intersections
    dropped = 0
    extra_members: List[np.ndarray] = []
    extra_counts: List[float] = []
    for row, n in zip(sigs[~single], cnts[~single]):
        ecs = row[row != pad]
        members = index.ec_members(int(ecs[0]))
        for ec in ecs[1:]:
            members = np.intersect1d(
                members, index.ec_members(int(ec)), assume_unique=True
            )
            if members.size == 0:
                break
        if members.size == 0:
            dropped += int(n)
            continue
        extra_members.append(members.astype(np.int64))
        extra_counts.append(float(n))

    if extra_members:
        flat = np.concatenate([s_flat] + extra_members)
        lens = np.concatenate(
            [s_len, np.fromiter((m.size for m in extra_members), np.int64,
                                len(extra_members))])
        counts = np.concatenate([ec_counts, np.asarray(extra_counts)])
    else:
        flat, lens, counts = s_flat, s_len, ec_counts
    member_lists, gcounts = _group_member_lists(flat, lens, counts)
    return member_lists, gcounts, dropped
