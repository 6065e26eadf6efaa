"""Device mapping path vs oracle: packing, probing, signatures, accumulation
(SURVEY.md section 4 items 2-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seekmer_tpu import encoding as enc
from seekmer_tpu.config import IndexConfig, MapConfig
from seekmer_tpu.index.build import build_index_from_seqs
from seekmer_tpu.io.fastq import batch_reads
from seekmer_tpu.map.driver import Mapper
from seekmer_tpu.map.signature import (
    SIG_PAD,
    accumulate,
    fingerprint,
    make_sig_table,
    read_signatures,
    table_to_host,
)
from seekmer_tpu.ops.kmer_pack import pack_canonical
from seekmer_tpu.ops.probe import lookup_ecs
from seekmer_tpu.utils.simulate import random_transcriptome, simulate_reads
from tests.oracle import oracle


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(99)
    names, seqs = random_transcriptome(
        rng, num_transcripts=40, min_len=150, max_len=800,
        shared_prefix_frac=0.6,
    )
    index = build_index_from_seqs(names, seqs, cfg=IndexConfig())
    sim = simulate_reads(rng, seqs, num_reads=500, read_len=100,
                         error_rate=0.01)
    return index, seqs, sim


def test_pack_canonical_matches_host(rng):
    k = 25
    B, L = 8, 64
    seqs = []
    for _ in range(B):
        s = "".join(rng.choice(list("ACGTN"), size=L, p=[0.24, 0.24, 0.24, 0.24, 0.04]))
        seqs.append(s)
    codes = np.stack([enc.seq_to_codes(s) for s in seqs])
    lengths = np.full(B, L, np.int32)
    lengths[0] = 40  # short read: tail positions invalid
    hi, lo, valid = jax.jit(pack_canonical, static_argnums=2)(
        jnp.asarray(codes), jnp.asarray(lengths), k
    )
    hi, lo, valid = map(np.asarray, (hi, lo, valid))
    for b in range(B):
        keys, v_host = enc.canonical_kmers(codes[b, : lengths[b]], k)
        P_host = lengths[b] - k + 1
        assert (valid[b, :P_host] == v_host).all()
        assert not valid[b, P_host:].any()
        h_host, l_host = enc.split_key(keys, k)
        ok = v_host
        assert (hi[b, :P_host][ok] == h_host[ok]).all()
        assert (lo[b, :P_host][ok] == l_host[ok]).all()


def test_pack_canonical_known_sequence():
    """A hand-written sequence with an N: windows over the N are invalid,
    the rest match the host encoder's canonical keys."""
    k = 5
    seq = "ACGTTTGCA" + "N" + "ACGTA"
    codes = enc.seq_to_codes(seq)[None, :]
    lengths = np.array([len(seq)], np.int32)
    hi, lo, v = pack_canonical(jnp.asarray(codes), jnp.asarray(lengths), k)
    keys, valid = enc.canonical_kmers(enc.seq_to_codes(seq), k)
    np.testing.assert_array_equal(np.asarray(v)[0], valid)
    assert valid.sum() == 5 + 1 and not valid[5:10].any()
    h_host, l_host = enc.split_key(keys, k)
    np.testing.assert_array_equal(np.asarray(hi)[0][valid], h_host[valid])
    np.testing.assert_array_equal(np.asarray(lo)[0][valid], l_host[valid])


@pytest.fixture(scope="module")
def bucket4_index():
    """The setup world indexed with 4-slot buckets: full home buckets are
    common, so the stash holds keys."""
    rng = np.random.default_rng(99)
    names, seqs = random_transcriptome(
        rng, num_transcripts=40, min_len=150, max_len=800,
        shared_prefix_frac=0.6,
    )
    index = build_index_from_seqs(names, seqs, cfg=IndexConfig(bucket_size=4))
    assert (index.stash[:, 0] != -1).any(), "fixture needs stashed keys"
    return index


def _read_lanes(index, sim):
    reads = sim.reads1[:64]
    L = max(len(r) for r in reads)
    codes = np.full((len(reads), L), 4, np.uint8)
    lengths = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        c = enc.seq_to_codes(r)
        codes[i, : c.size] = c
        lengths[i] = c.size
    hi, lo, valid = pack_canonical(jnp.asarray(codes), jnp.asarray(lengths),
                                   index.k)
    return np.asarray(hi), np.asarray(lo), np.asarray(valid)


def _table_lanes(rows, limit=2048):
    occ = np.flatnonzero(rows[:, 0] != -1)[:limit]
    return rows[occ, 0], rows[occ, 1], np.ones(occ.size, bool)


@pytest.mark.parametrize("lanes", ["reads", "absent_and_invalid",
                                   "stash_resident", "every_indexed"])
def test_lookup_matches_dict(setup, bucket4_index, lanes):
    """lookup_ecs == the oracle's k-mer dict, lane for lane: k-mers of
    simulated reads; random keys (mostly absent) with random invalid
    lanes; keys the builder placed in the stash; and keys of the main
    table."""
    index, seqs, sim = setup
    rng = np.random.default_rng(7)
    if lanes == "reads":
        hi, lo, valid = _read_lanes(index, sim)
    elif lanes == "absent_and_invalid":
        n = 300
        hi = rng.integers(0, 1 << 30, n, dtype=np.int32)
        lo = rng.integers(0, 1 << 20, n, dtype=np.int32)
        valid = rng.random(n) < 0.7
        # a few real keys among the random ones, some of them invalid
        khi, klo, _ = _table_lanes(index.table, 40)
        hi[:40], lo[:40] = khi, klo
    elif lanes == "stash_resident":
        index = bucket4_index
        hi, lo, valid = _table_lanes(index.stash)
    else:
        hi, lo, valid = _table_lanes(index.table)
    from seekmer_tpu.ops.probe import device_table_layout

    ecs = lookup_ecs(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid),
        jnp.asarray(device_table_layout(index.table, index.bucket)),
        index.main_slots,
        jnp.asarray(device_table_layout(index.stash, index.bucket)),
        index.stash_slots, index.bucket)
    ecs = np.asarray(ecs)
    kdict = oracle.build_kmer_dict(index)
    keys = enc.join_key(hi.reshape(-1), lo.reshape(-1), index.k)
    expect = np.array([kdict.get(int(key), -1) for key in keys.tolist()],
                      np.int32).reshape(hi.shape)
    expect = np.where(valid, expect, -1)
    np.testing.assert_array_equal(ecs, expect)
    if lanes != "absent_and_invalid":
        assert (ecs[valid] >= 0).any()


def test_synthetic_stash_hit():
    """Hand-built tables: a key whose main home bucket is full and that
    lives only in the stash resolves through the stash pass, with its
    aux lane; an absent key misses."""
    from seekmer_tpu.ops.hash import hash_kmer, hash_kmer_stash
    from seekmer_tpu.ops.probe import device_table_layout, lookup_ecs_aux

    bucket, nb, nb_s = 4, 8, 4
    main = np.full((nb * bucket, 4), -1, np.int32)
    stash = np.full((nb_s * bucket, 4), -1, np.int32)
    key = (np.int32(12345), np.int32(678))
    hb = int(hash_kmer(np.uint32(key[0]), np.uint32(key[1])) & (nb - 1))
    # fill the key's main home bucket with decoys sharing no key
    for s in range(bucket):
        main[hb * bucket + s] = (1000 + s, 2000 + s, 7 + s, 0)
    sb = int(hash_kmer_stash(np.uint32(key[0]), np.uint32(key[1]))
             & (nb_s - 1))
    stash[sb * bucket + 1] = (key[0], key[1], 42, 3)

    hi = jnp.asarray([key[0], 999999], jnp.int32)
    lo = jnp.asarray([key[1], 999999], jnp.int32)
    ec, aux = lookup_ecs_aux(
        hi, lo, jnp.ones(2, bool),
        jnp.asarray(device_table_layout(main, bucket)), nb * bucket,
        jnp.asarray(device_table_layout(stash, bucket)), nb_s * bucket,
        bucket)
    assert np.asarray(ec).tolist() == [42, -1]
    assert np.asarray(aux).tolist() == [3, 0]


def test_read_signatures_basic():
    ecs = jnp.asarray(
        np.array([
            [3, 1, 3, -1, 1],     # distinct {1,3}
            [-1, -1, -1, -1, -1],  # no hits -> unmapped
            [5, 5, 5, 5, 5],       # single EC
            [0, 1, 2, 3, 4],       # 5 distinct > C=3 -> complex/unmapped
        ], np.int32)
    )
    valid = jnp.asarray(np.array([
        [1, 1, 1, 1, 1],
        [1, 1, 1, 1, 1],
        [1, 1, 1, 1, 0],
        [1, 1, 1, 1, 1],
    ], bool))
    sig, mapped = read_signatures(ecs, valid, max_ecs=3)
    sig, mapped = np.asarray(sig), np.asarray(mapped)
    assert mapped.tolist() == [True, False, True, False]
    assert sig[0].tolist() == [1, 3, int(SIG_PAD)]
    assert sig[2].tolist() == [5, int(SIG_PAD), int(SIG_PAD)]


def _signatures_reference(ecs, valid, C):
    """numpy reference of read_signatures: sorted distinct valid hits;
    mapped iff 1..C of them."""
    sig = np.full((ecs.shape[0], C), int(SIG_PAD), np.int32)
    mapped = np.zeros(ecs.shape[0], bool)
    for b in range(ecs.shape[0]):
        d = np.unique(ecs[b][valid[b] & (ecs[b] >= 0)])
        mapped[b] = 0 < d.size <= C
        sig[b, :min(d.size, C)] = d[:C]
    return sig, mapped


@pytest.mark.parametrize("case", ["random_lanes", "no_hits_and_complex",
                                  "wide_window_axis", "exactly_c_distinct"])
def test_read_signatures_matches_numpy(case):
    rng = np.random.default_rng(1234)
    if case == "random_lanes":
        B, P, C = 24, 76, 8
        ecs = rng.integers(-1, 40, size=(B, P)).astype(np.int32)
        valid = rng.random((B, P)) < 0.8
    elif case == "no_hits_and_complex":
        B, P, C = 16, 50, 4
        ecs = rng.integers(0, 1000, size=(B, P)).astype(np.int32)
        ecs[0] = -1                      # zero hits -> unmapped
        ecs[1] = 7                       # single EC everywhere
        valid = np.ones((B, P), bool)
        valid[2] = False                 # all-invalid -> unmapped
    elif case == "wide_window_axis":
        B, P, C = 8, 200, 16
        ecs = rng.integers(-1, 25, size=(B, P)).astype(np.int32)
        valid = rng.random((B, P)) < 0.9
    else:
        B, P, C = 4, 30, 5
        ecs = np.tile(np.arange(5, dtype=np.int32), (B, 6))
        valid = np.ones((B, P), bool)
    sig, mapped = read_signatures(jnp.asarray(ecs), jnp.asarray(valid), C)
    ref_sig, ref_mapped = _signatures_reference(ecs, valid, C)
    np.testing.assert_array_equal(np.asarray(mapped), ref_mapped)
    np.testing.assert_array_equal(np.asarray(sig)[ref_mapped],
                                  ref_sig[ref_mapped])
    if case == "no_hits_and_complex":
        assert ref_mapped[1] and not ref_mapped[0] and not ref_mapped[2]
        assert not ref_mapped[3:].any()  # ~50 distinct ids > C
    if case == "exactly_c_distinct":
        assert ref_mapped.all()


def test_accumulate_matches_counter(rng):
    """Device signature table == Python Counter over many random batches."""
    C = 4
    # 512 slots vs <= 298 possible distinct signatures: high load pressure
    # (collision chains) without overflow.
    table = make_sig_table(bits=9, max_ecs=C)
    from collections import Counter

    truth = Counter()
    acc = jax.jit(accumulate, static_argnames=("sig_probe",),
                  donate_argnums=(0,))
    for _ in range(5):
        B = 256
        n_ecs = rng.integers(0, 4, size=B)
        sig = np.full((B, C), int(SIG_PAD), np.int32)
        for i in range(B):
            ids = np.sort(rng.choice(12, size=n_ecs[i], replace=False))
            sig[i, : ids.size] = ids
        mapped = n_ecs > 0
        weights = (rng.random(B) < 0.9).astype(np.int32)  # some pad rows
        for i in range(B):
            if mapped[i] and weights[i]:
                truth[tuple(sig[i][sig[i] != int(SIG_PAD)].tolist())] += 1
        table = acc(table, jnp.asarray(sig), jnp.asarray(mapped),
                    weights=jnp.asarray(weights), sig_probe=256)
    sigs, counts = table_to_host(table)
    got = Counter()
    for row, n in zip(sigs, counts):
        got[tuple(row[row != int(SIG_PAD)].tolist())] += int(n)
    assert int(table.overflow) == 0
    assert int(table.collisions) == 0  # real 64-bit fps: no collisions
    assert got == truth


def _const_fp(sig):
    """Degenerate fingerprint: every signature collides."""
    B = sig.shape[0]
    return jnp.full((B,), 7, jnp.int32), jnp.full((B,), 9, jnp.int32)


def test_collision_audit_detects_forced_collision(monkeypatch):
    """Two DISTINCT signatures forced onto one 64-bit fingerprint: the
    audit (MapConfig.collision_audit -> accumulate(audit=True)) counts the
    reads whose counts silently merged into another signature's row."""
    import seekmer_tpu.map.signature as sigmod

    monkeypatch.setattr(sigmod, "fingerprint", _const_fp)
    C = 4
    pad = int(SIG_PAD)
    sig1 = np.full((2, C), pad, np.int32)
    sig1[:, 0] = 3
    sig2 = np.full((2, C), pad, np.int32)
    sig2[:, 0] = 5
    mapped = jnp.asarray(np.array([True, True]))

    table = sigmod.make_sig_table(bits=4, max_ecs=C)
    table = sigmod.accumulate(table, jnp.asarray(sig1), mapped)
    assert int(table.collisions) == 0  # duplicates of ONE signature: fine
    table = sigmod.accumulate(table, jnp.asarray(sig2), mapped)
    assert int(table.collisions) == 2  # both reads merged into sig1's row
    # counts DID merge (the approximation the audit reports):
    _, counts = table_to_host(table)
    assert counts.tolist() == [4]

    # same-batch double-claim: one row wins the slot, the other lane's
    # read is the collision
    table2 = sigmod.make_sig_table(bits=4, max_ecs=C)
    both = np.stack([sig1[0], sig2[0]])
    table2 = sigmod.accumulate(table2, jnp.asarray(both), mapped)
    assert int(table2.collisions) == 1

    # audit off: undetected (steady-state cost knob)
    table3 = sigmod.make_sig_table(bits=4, max_ecs=C)
    table3 = sigmod.accumulate(table3, jnp.asarray(sig1), mapped)
    table3 = sigmod.accumulate(table3, jnp.asarray(sig2), mapped,
                               audit=False)
    assert int(table3.collisions) == 0


def test_mapper_matches_oracle(setup):
    """End-to-end mapping (batched, padded, device tables) == oracle dicts."""
    index, seqs, sim = setup
    cfg = MapConfig(batch_size=128, max_ecs_per_read=8, sig_table_bits=12)
    mapper = Mapper(index, cfg)
    reads_b = [r.encode() for r in sim.reads1]
    result = mapper.run(batch_reads(reads_b, cfg))

    o_sigs, o_unmapped = oracle.map_reads(sim.reads1, index, cfg)
    assert result.total_reads == len(sim.reads1)
    assert result.overflow == 0
    assert result.unmapped == o_unmapped

    got = {}
    for row, n in zip(result.sigs, result.sig_counts):
        got[tuple(row[row != int(SIG_PAD)].tolist())] = int(n)
    assert got == dict(o_sigs)


def test_paired_strided_matches_dense(rng):
    """Stride coverage must not leak across the mate boundary: strided
    paired mapping equals dense paired mapping on error-free mates."""
    from seekmer_tpu.config import MapConfig
    from seekmer_tpu.index.build import build_index_from_seqs
    from seekmer_tpu.io.fastq import ReadBatch
    from seekmer_tpu.map.driver import Mapper, merge_sig_rows
    from seekmer_tpu.utils.simulate import (
        isoform_transcriptome, simulate_packed_pairs,
    )

    names, seqs, genes = isoform_transcriptome(rng, num_genes=12)
    c1, c2, _ = simulate_packed_pairs(rng, seqs, 1, 128, read_len=96,
                                      error_rate=0.0)
    L = np.full(128, 96, np.int32)
    w = np.ones(128, np.int32)
    index = build_index_from_seqs(names, seqs, genes=genes)
    results = {}
    for stride in (1, 3):
        cfg = MapConfig(batch_size=128, paired_end=True, sig_table_bits=12,
                        probe_stride=stride)
        m = Mapper(index, cfg)
        m.feed(ReadBatch(c1[0], L, w, codes2=c2[0], lengths2=L))
        r = m.finalize()
        results[stride] = {tuple(s.tolist()): int(n)
                           for s, n in zip(r.sigs, r.sig_counts)}
    assert results[1] == results[3]


def test_mapper_packed_h2d_matches_unpacked(setup):
    """Feeding 2-bit-packed batches (MapConfig.h2d_pack_2bit path) gives
    the identical MapResult as unpacked rows — the unpack is exact."""
    from seekmer_tpu.io.fastq import pack_batch_2bit
    from seekmer_tpu.utils.prefetch import device_put_batches

    index, seqs, sim = setup
    cfg = MapConfig(batch_size=128, max_ecs_per_read=8, sig_table_bits=12)
    reads_b = [r.encode() for r in sim.reads1]

    m1 = Mapper(index, cfg)
    r1 = m1.run(batch_reads(reads_b, cfg))
    m2 = Mapper(index, cfg)
    r2 = m2.run(device_put_batches(batch_reads(reads_b, cfg),
                                   pack_2bit=True))
    assert r1.total_reads == r2.total_reads
    assert r1.mapped == r2.mapped
    assert (r1.sigs == r2.sigs).all()
    assert (r1.sig_counts == r2.sig_counts).all()

    # the FAST mode composes with packed H2D: map_step unpacks on-device
    # BEFORE two_phase sees the code rows, so phase-2's re-pack of
    # compacted units reads the exact codes
    cfg_f = MapConfig(batch_size=128, max_ecs_per_read=8,
                      sig_table_bits=12, probe_sample=4)
    rf1 = Mapper(index, cfg_f).run(batch_reads(reads_b, cfg_f))
    rf2 = Mapper(index, cfg_f).run(device_put_batches(
        batch_reads(reads_b, cfg_f), pack_2bit=True))
    assert rf1.mapped == rf2.mapped
    assert (rf1.sigs == rf2.sigs).all()
    assert (rf1.sig_counts == rf2.sig_counts).all()


def test_sharded_mappers_reject_packed_batches(setup):
    from seekmer_tpu.config import ShardConfig
    from seekmer_tpu.io.fastq import pack_batch_2bit, ReadBatch
    from seekmer_tpu.parallel.data_parallel import DataParallelMapper

    index, seqs, sim = setup
    cfg = MapConfig(batch_size=16, sig_table_bits=10)
    dp = DataParallelMapper(index, cfg, ShardConfig(data_axis=8))
    b = ReadBatch(codes=np.full((16, 64), 4, np.uint8),
                  lengths=np.full(16, 64, np.int32),
                  weights=np.ones(16, np.int32))
    with pytest.raises(ValueError, match="single-chip"):
        dp.feed(pack_batch_2bit(b))


def test_audit_sampling_schedule():
    from seekmer_tpu.map.driver import audit_this_batch

    cfg = MapConfig(collision_audit_every=4)
    assert [audit_this_batch(cfg, i) for i in range(6)] == \
        [True, False, False, False, True, False]
    assert audit_this_batch(MapConfig(collision_audit_every=1), 3)
    assert not audit_this_batch(MapConfig(collision_audit=False), 0)


def _sig_dict(result):
    return {tuple(row[row != int(SIG_PAD)].tolist()): int(n)
            for row, n in zip(result.sigs, result.sig_counts)}


def test_two_phase_single_ec_world_exact():
    """FAST mode (MapConfig.probe_sample): in a world where every read
    lies inside one EC run (single transcript — every k-mer maps to EC 0),
    every read resolves in phase 1 and the result equals dense exactly."""
    rng = np.random.default_rng(5)
    seq = "".join(rng.choice(list("ACGT"), size=3000))
    index = build_index_from_seqs(["t0"], [seq])
    sim = simulate_reads(rng, [seq], num_reads=300, read_len=100,
                         error_rate=0.0)
    reads_b = [r.encode() for r in sim.reads1]
    res = {}
    for sample in (0, 4):
        cfg = MapConfig(batch_size=128, sig_table_bits=12,
                        probe_sample=sample)
        res[sample] = Mapper(index, cfg).run(batch_reads(reads_b, cfg))
    assert _sig_dict(res[4]) == _sig_dict(res[0])
    assert res[4].mapped == res[0].mapped == 300


def test_two_phase_ambiguous_reads_fall_back_exact(setup):
    """Reads whose samples see >= 2 ECs (junction reads) or zero hits
    (junk) must be re-probed densely — their signatures equal the dense
    mapper's EXACTLY. Error-free reads on a shared-prefix transcriptome
    exercise both resolved and fallback classes; with stride 2 every
    EC-run transition of length >= 2 is sampled, so any difference is
    confined to single-window runs (none in this fixture — assert
    full equality)."""
    index, seqs, _ = setup
    rng = np.random.default_rng(17)
    sim = simulate_reads(rng, seqs, num_reads=400, read_len=100,
                        error_rate=0.0)
    junk = ["".join(rng.choice(list("ACGT"), size=100)) for _ in range(40)]
    reads_b = [r.encode() for r in list(sim.reads1) + junk]
    res = {}
    for sample in (0, 2):
        cfg = MapConfig(batch_size=128, sig_table_bits=12,
                        max_ecs_per_read=8, probe_sample=sample)
        res[sample] = Mapper(index, cfg).run(batch_reads(reads_b, cfg))
    d0, d2 = _sig_dict(res[0]), _sig_dict(res[2])
    assert res[2].total_reads == res[0].total_reads
    # fast signatures are subsets of dense ones; with stride 2 on clean
    # reads they should agree outright here
    assert d2 == d0
    assert res[2].mapped == res[0].mapped


def test_two_phase_residual_rounds_cover_all_reads():
    """A fallback cap smaller than the ambiguous-read count must drain
    through residual while_loop rounds with exact coverage (the same
    pattern as the stash pass)."""
    from seekmer_tpu.map.driver import DeviceIndex
    from seekmer_tpu.map.signature import read_signatures
    from seekmer_tpu.ops.probe import two_phase_signatures

    rng = np.random.default_rng(23)
    names, seqs = random_transcriptome(
        rng, num_transcripts=30, min_len=150, max_len=600,
        shared_prefix_frac=0.8)
    index = build_index_from_seqs(names, seqs)
    sim = simulate_reads(rng, seqs, num_reads=256, read_len=100,
                         error_rate=0.02)
    cfg = MapConfig(batch_size=256, sig_table_bits=12)
    di = DeviceIndex.from_host(index)
    codes = np.full((256, 100), 4, np.uint8)
    code_of = {"A": 0, "C": 1, "G": 2, "T": 3}
    for i, r in enumerate(sim.reads1):
        codes[i, :len(r)] = [code_of[b] for b in r]
    lengths = jnp.full(256, 100, jnp.int32)
    hi, lo, valid = pack_canonical(jnp.asarray(codes), lengths, index.k)

    dense_ec = lookup_ecs(hi, lo, valid, di.table, di.main_slots, di.stash,
                          di.stash_slots, di.bucket)
    sig_ref, mapped_ref = read_signatures(dense_ec, valid,
                                          cfg.max_ecs_per_read)

    for frac in (1.0, 1.0 / 64):  # cap 256 (one round) and cap 128+... 4
        sig, mapped = two_phase_signatures(
            hi, lo, valid, [(jnp.asarray(codes), lengths)],
            lambda c, ln: pack_canonical(c, ln, index.k),
            di.table, di.main_slots, di.stash,
            di.stash_slots, di.bucket, 2, cfg.max_ecs_per_read,
            read_signatures, int(SIG_PAD), fallback_frac=frac)
        sig, mapped = np.asarray(sig), np.asarray(mapped)
        # every read is either phase-1 resolved (single-EC subset) or
        # exactly dense; here check the invariants read by read
        for i in range(256):
            ref_sig = set(np.asarray(sig_ref)[i].tolist()) - {int(SIG_PAD)}
            got_sig = set(sig[i].tolist()) - {int(SIG_PAD)}
            if got_sig != ref_sig:
                assert got_sig and got_sig.issubset(ref_sig), (i, got_sig,
                                                               ref_sig)
            if not mapped[i]:
                assert not np.asarray(mapped_ref)[i] or len(ref_sig) > \
                    cfg.max_ecs_per_read


def test_two_phase_paired_matches_dense_on_clean_pairs(rng):
    """Paired fast mode: clean same-EC pairs resolve; discordant-ish pairs
    fall back. Equality with dense on an error-free isoform world."""
    from seekmer_tpu.io.fastq import ReadBatch
    from seekmer_tpu.utils.simulate import (
        isoform_transcriptome, simulate_packed_pairs,
    )

    names, seqs, genes = isoform_transcriptome(rng, num_genes=10)
    c1, c2, _ = simulate_packed_pairs(rng, seqs, 1, 128, read_len=96,
                                      error_rate=0.0)
    L = np.full(128, 96, np.int32)
    w = np.ones(128, np.int32)
    index = build_index_from_seqs(names, seqs, genes=genes)
    res = {}
    for sample in (0, 2):
        cfg = MapConfig(batch_size=128, paired_end=True, sig_table_bits=12,
                        probe_sample=sample)
        m = Mapper(index, cfg)
        m.feed(ReadBatch(c1[0], L, w, codes2=c2[0], lengths2=L))
        res[sample] = m.finalize()
    assert _sig_dict(res[2]) == _sig_dict(res[0])


def test_two_phase_zero_hit_mate_reprobed_densely(rng):
    """A fallback pair's ZERO-SAMPLED-HIT mate must re-probe densely:
    its between-sample hits belong in the pair signature (round-4
    advisor finding — they were silently dropped).

    Construction: mate 1 straddles t0's shared/unique junction (two ECs
    sampled -> the pair falls back); mate 2 carries a t1-unique k-mer
    run confined strictly BETWEEN probe_sample=16's sampled windows
    (0, 16, 32, 48, 64, 71), so its sampled hits are zero while its
    dense signature names t1's unique EC."""
    from seekmer_tpu.io.fastq import ReadBatch

    t0 = "".join(rng.choice(list("ACGT"), size=600))
    t1 = t0[:300] + "".join(rng.choice(list("ACGT"), size=300))
    index = build_index_from_seqs(["t0", "t1"], [t0, t1])

    # mate 1: t0[220:316] — sampled windows 0..48 lie in the shared
    # prefix (EC {t0,t1}), 64/71 in t0's unique tail (EC {t0})
    mate1 = t0[220:316]
    # mate 2: 40 bp of t1's unique region, first base flipped (kills
    # window 0), then 56 bp junk (windows >= 16 miss): dense hits only
    # in windows 1..15 — none sampled at stride 16
    u = t1[350:390]
    flip = {"A": "C", "C": "G", "G": "T", "T": "A"}
    mate2 = flip[u[0]] + u[1:] + "".join(rng.choice(list("ACGT"), size=56))
    assert len(mate1) == len(mate2) == 96

    def codes_of(seq):
        return enc.seq_to_codes(seq)[None, :]

    L = np.full(1, 96, np.int32)
    w = np.ones(1, np.int32)
    res = {}
    for sample in (0, 16):
        cfg = MapConfig(batch_size=1, paired_end=True, sig_table_bits=10,
                        probe_sample=sample)
        m = Mapper(index, cfg)
        m.feed(ReadBatch(codes_of(mate1), L, w,
                         codes2=codes_of(mate2), lengths2=L))
        res[sample] = m.finalize()
    d0, d16 = _sig_dict(res[0]), _sig_dict(res[16])
    # dense sees three ECs (shared, t0-unique, t1-unique); the fast pair
    # must agree exactly — dropping mate 2 would lose t1's unique EC
    (sig0,) = d0.keys()
    assert len(sig0) == 3
    assert d16 == d0


def test_fallback_cap_auto_sizing_matches_explicit(rng):
    """sample_fallback_frac=0 (AUTO, the default) calibrates a cap from
    the first batch's observed fallback fraction; results must equal an
    explicit-cap run exactly (the cap only schedules work — round 5)."""
    from seekmer_tpu.io.fastq import ReadBatch
    from seekmer_tpu.map.driver import _pick_fallback_frac
    from seekmer_tpu.utils.simulate import (
        isoform_transcriptome, simulate_packed_pairs,
    )

    names, seqs, genes = isoform_transcriptome(rng, num_genes=10)
    index = build_index_from_seqs(names, seqs, genes=genes)
    c1, c2, _ = simulate_packed_pairs(rng, seqs, 2, 128, read_len=96,
                                      error_rate=0.01)
    L = np.full(128, 96, np.int32)
    w = np.ones(128, np.int32)
    res = {}
    for frac in (0.0, 0.5):
        cfg = MapConfig(batch_size=128, paired_end=True, sig_table_bits=12,
                        probe_sample=4, sample_fallback_frac=frac)
        m = Mapper(index, cfg)
        for i in range(2):
            m.feed(ReadBatch(c1[i], L, w, codes2=c2[i], lengths2=L))
        if frac == 0.0:
            assert m._auto_frac is not None  # calibration happened
        res[frac] = m.finalize()
    assert _sig_dict(res[0.0]) == _sig_dict(res[0.5])
    assert res[0.0].mapped == res[0.5].mapped

    # the grid picker: just-fitting, with margin; monotone; bounded
    assert _pick_fallback_frac(0.0, 65536) == 1 / 32
    assert _pick_fallback_frac(0.082, 65536) == 3 / 32
    assert _pick_fallback_frac(0.315, 65536) == 0.35
    assert _pick_fallback_frac(0.99, 65536) == 1.0


def test_all_invalid_segment_never_burns_fallback_units():
    """A segment with NO valid window (pad rows, all-N mates) is excluded
    from fallback units — dense re-probe of it returns nothing by
    construction (round 5: every pad row used to burn a cap unit)."""
    from seekmer_tpu.map.driver import DeviceIndex
    from seekmer_tpu.map.signature import read_signatures
    from seekmer_tpu.ops.probe import two_phase_signatures

    rng = np.random.default_rng(31)
    names, seqs = random_transcriptome(rng, num_transcripts=10)
    index = build_index_from_seqs(names, seqs)
    di = DeviceIndex.from_host(index)
    B, L = 8, 100
    codes = np.full((B, L), 4, np.uint8)  # every row fully invalid
    lengths = jnp.full(B, L, jnp.int32)
    hi, lo, valid = pack_canonical(jnp.asarray(codes), lengths, index.k)
    staging, unit_need = two_phase_signatures(
        hi, lo, valid, [(jnp.asarray(codes), lengths)],
        lambda c, ln: pack_canonical(c, ln, index.k),
        di.table, di.main_slots, di.stash, di.stash_slots, di.bucket,
        4, 8, read_signatures, int(SIG_PAD), _stage="classify")
    assert not np.asarray(unit_need).any()
    # and the full path still maps them as unmapped, not a crash
    sig, mapped = two_phase_signatures(
        hi, lo, valid, [(jnp.asarray(codes), lengths)],
        lambda c, ln: pack_canonical(c, ln, index.k),
        di.table, di.main_slots, di.stash, di.stash_slots, di.bucket,
        4, 8, read_signatures, int(SIG_PAD))
    assert not np.asarray(mapped).any()
