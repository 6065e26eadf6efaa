"""Fragment-length distribution (FLD) estimation from mapped read pairs.

The reference's effective-length model needs a fragment-length mean/sd
(seekmer infer.py, SURVEY.md 3.4 — exact upstream handling is an open
parameter; kallisto-class tools estimate it from concordantly mapped
pairs). Round 1 required the user to guess ``--fragment-length``; this
module estimates it from the data.

Design: pseudoalignment keeps no positional information, so the
index carries a per-slot payload (``KMerIndex.fld_tid`` / ``fld_pos``,
index/build.py) giving, for every GLOBALLY UNIQUE k-mer (one occurrence in
the whole transcriptome), its transcript id and transcript-local window
position. For a read pair, sample a few window offsets per mate, look each
up in the main k-mer table (one bucket gather + slab compare, exactly the
hot path's probe), and take the first sampled window per mate that hits a
unique k-mer. With window offsets o1, o2 and unique positions q1, q2 in
the SAME transcript, the fragment length is orientation-independent:

    f = |q1 - q2| + k + o1 + o2

(one mate reads the fragment start forward, the other reads the fragment
end as a reverse complement; canonicalization makes the looked-up position
the forward-strand window start either way). Valid observations are
histogrammed on device; the host reads the histogram once, after the
sampling batches, so the estimator adds no per-batch syncs.

Sampling runs on the first few batches only (~100k pairs is far more than
needed for a stable mean/sd), so the steady-state mapping path pays
nothing.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..index.store import KMerIndex
from ..ops.hash import hash_kmer
from ..ops.kmer_pack import pack_canonical

log = logging.getLogger(__name__)

# Window offsets sampled per mate: spread out so one sequencing error
# cannot invalidate every sample; the first offset with a unique-k-mer hit
# wins. Offsets near the read start keep the estimate unbiased (the choice
# of o only shifts which k-mer pins the fragment, not its length).
DEFAULT_OFFSETS = (0, 7, 15, 23)


def _match_slot(hi, lo, table, slots: int, bucket: int):
    """Flat (hi, lo) lanes -> main-table slot id of the matching key
    (-1 when absent). Same bucket-gather + slab-compare as the hot probe
    (ops/probe._bucket_lookup) but returning the SLOT, which addresses the
    per-slot FLD payload arrays."""
    G = bucket
    nb = slots // G
    hb = (hash_kmer(hi.astype(jnp.uint32), lo.astype(jnp.uint32))
          & jnp.uint32(nb - 1)).astype(jnp.int32)
    rows = table[hb]  # (N, 4G) slab layout
    match = (rows[:, :G] == hi[:, None]) & (rows[:, G:2 * G] == lo[:, None])
    lane = jnp.argmax(match, axis=1).astype(jnp.int32)
    found = match.any(axis=1)
    return jnp.where(found, hb * G + lane, -1)


def _first_unique(tid, qpos, offs):
    """Per read, the first sampled offset whose k-mer is globally unique.

    Args: tid/qpos int32[B, W], offs int32[W]. Returns (t, q, o, usable).
    """
    has = tid >= 0
    j = jnp.argmax(has, axis=1)
    b = jnp.arange(tid.shape[0])
    return tid[b, j], qpos[b, j], offs[j], has.any(axis=1)


def fld_step(table, fld_tid, fld_pos, hist,
             codes, lengths, codes2, lengths2,
             k: int, main_slots: int, bucket: int,
             offsets: Tuple[int, ...] = DEFAULT_OFFSETS,
             owner_bits: int = 0):
    """One FLD sampling step over a paired batch; returns the updated
    histogram (int32[max_len + 1]; index 0 is the reject dump).

    ``owner_bits`` > 0 restricts sampling to windows whose k-mer hashes
    to prefix-shard owner 0 (``table`` is then shard 0's sub-table, an
    unbiased 1/2^bits sample of the index — the prefix-sharded mode's
    estimator, parallel/prefix_shard.shard_index_by_prefix).

    Modeling choice: fragments SHORTER than the longer mate's read length
    are rejected (the ``f >= max(len1, len2)`` filter below). Read-through
    fragments — real in degraded/short-insert libraries — are therefore
    excluded, biasing the estimated mean slightly upward there; accepting
    them would require adapter-aware trimming to measure f at all. The
    float64 oracle (tests/oracle/oracle.py) applies the identical rule,
    so oracle parity is unaffected."""
    max_len = hist.shape[0] - 1

    def mate(codes, lengths):
        hi, lo, valid = pack_canonical(codes, lengths, k)
        P = hi.shape[1]
        offs = [o for o in offsets if o < P] or [0]
        w = np.asarray(offs, np.int32)
        his, los, vs = hi[:, w], lo[:, w], valid[:, w]
        B, W = his.shape
        hif, lof = his.reshape(-1), los.reshape(-1)
        vs = vs.reshape(-1)
        if owner_bits:
            owner = hash_kmer(hif.astype(jnp.uint32),
                              lof.astype(jnp.uint32)) >> np.uint32(
                                  32 - owner_bits)
            vs = vs & (owner == 0)
        slot = _match_slot(hif, lof, table, main_slots, bucket)
        ok = vs & (slot >= 0)
        si = jnp.maximum(slot, 0)
        tid = jnp.where(ok, fld_tid[si], -1).reshape(B, W)
        qp = jnp.where(ok, fld_pos[si], 0).reshape(B, W)
        return _first_unique(tid, qp, jnp.asarray(w))

    t1, q1, o1, u1 = mate(codes, lengths)
    t2, q2, o2, u2 = mate(codes2, lengths2)
    f = jnp.abs(q1 - q2) + k + o1 + o2
    minf = jnp.maximum(lengths, lengths2).astype(jnp.int32)
    ok = (u1 & u2 & (t1 == t2)
          & (f >= minf) & (f <= max_len))
    return hist.at[jnp.where(ok, f, 0)].add(ok.astype(jnp.int32))


class _PlainTable:
    """Minimal .table holder (the replicated path passes a DeviceIndex)."""

    def __init__(self, table):
        self.table = table


class FLDEstimator:
    """Accumulates a fragment-length histogram over the first few paired
    batches; ``estimate()`` reads it back once.

    ``device_index`` (map/driver.DeviceIndex) shares the mapper's
    device-resident main table — the FLD payload arrays are the only
    extra upload (2 int32 per main slot, freed with the estimator).
    """

    def __init__(self, index: KMerIndex, device_index,
                 max_len: int = 1024, sample_batches: int = 4,
                 min_samples: int = 100):
        if index.fld_tid is None:
            raise ValueError("index has no FLD payload "
                             "(built with fld_positions=False)")
        self.k = index.k
        self.main_slots = index.main_slots
        self.bucket = index.bucket
        self.owner_bits = 0
        self.offsets = DEFAULT_OFFSETS
        self._table_ref = device_index  # DeviceIndex (table read at feed)
        # main-table part only: stash-resident k-mers (~2e-4 of keys) are
        # simply never sampled
        self.fld_tid = jnp.asarray(index.fld_tid[: index.main_slots])
        self.fld_pos = jnp.asarray(index.fld_pos[: index.main_slots])
        self.hist = jnp.zeros(max_len + 1, jnp.int32)
        self.sample_batches = sample_batches
        self.min_samples = min_samples
        self._fed = 0
        self._steps: Dict[int, callable] = {}

    @classmethod
    def for_prefix_shard0(cls, index: KMerIndex, shard0_table,
                          fld_tid0, fld_pos0, n_shards: int,
                          max_len: int = 1024, sample_batches: int = 4,
                          min_samples: int = 100) -> "FLDEstimator":
        """Estimator over prefix-shard 0's sub-table (an unbiased
        1/n_shards key sample; parallel/prefix_shard). Samples more
        window offsets per mate to offset the 1/n_shards yield."""
        self = cls.__new__(cls)
        self.k = index.k
        self.bucket = index.bucket
        self.main_slots = int(shard0_table.shape[0]) * (
            shard0_table.shape[1] // 4)
        self.owner_bits = int(np.log2(n_shards))
        self.offsets = tuple(range(0, 64, 4))  # 16 offsets for yield
        table = jnp.asarray(shard0_table)
        self._table_ref = _PlainTable(table)
        self.fld_tid = jnp.asarray(fld_tid0)
        self.fld_pos = jnp.asarray(fld_pos0)
        self.hist = jnp.zeros(max_len + 1, jnp.int32)
        self.sample_batches = sample_batches
        self.min_samples = min_samples
        self._fed = 0
        self._steps = {}
        return self

    @property
    def active(self) -> bool:
        return self._fed < self.sample_batches

    def _get_step(self, bucket_shape: int, packed: bool = False):
        key = (bucket_shape, packed)
        if key not in self._steps:
            k, ms, G = self.k, self.main_slots, self.bucket
            ob, offs = self.owner_bits, self.offsets
            L = bucket_shape if packed else None

            def fn(table, fld_tid, fld_pos, hist, c1, l1, c2, l2,
                   bad1=None, bad2=None):
                if L is not None:  # 2-bit-packed H2D batches
                    from ..ops.kmer_pack import unpack_codes_2bit

                    c1 = unpack_codes_2bit(c1, bad1, L)
                    c2 = unpack_codes_2bit(c2, bad2, L)
                return fld_step(table, fld_tid, fld_pos, hist, c1, l1,
                                c2, l2, k, ms, G, offsets=offs,
                                owner_bits=ob)

            self._steps[key] = jax.jit(fn, donate_argnums=(3,))
        return self._steps[key]

    def feed(self, batch) -> None:
        """Sample a paired ReadBatch (no-op once enough batches are fed)."""
        if not self.active or batch.codes2 is None:
            return
        packed = batch.pad_len is not None
        step = self._get_step(batch.bucket, packed)
        extra = (batch.bad, batch.bad2) if packed else ()
        self.hist = step(self._table_ref.table, self.fld_tid,
                         self.fld_pos, self.hist, batch.codes,
                         batch.lengths, batch.codes2, batch.lengths2,
                         *extra)
        self._fed += 1
        if not self.active:  # free the payload HBM once sampling is done
            self.fld_tid = self.fld_pos = None
            self._steps.clear()

    def estimate(self) -> Optional[Tuple[float, float, int]]:
        """(mean, sd, n_samples), or None if too few observations."""
        hist = np.asarray(self.hist)
        hist = hist.copy()
        hist[0] = 0  # reject dump
        n = int(hist.sum())
        if n < self.min_samples:
            return None
        f = np.arange(hist.size, dtype=np.float64)
        mean = float((f * hist).sum() / n)
        var = float(((f - mean) ** 2 * hist).sum() / max(n - 1, 1))
        return mean, float(np.sqrt(var)), n
