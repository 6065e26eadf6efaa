"""Checkpoint/resume tests (SURVEY.md 5.3/5.4): interrupting the mapping
stream mid-run and resuming must reproduce the uninterrupted result."""

import os

import numpy as np
import pytest

from seekmer_tpu.config import EMConfig, MapConfig
from seekmer_tpu.em.em import build_ec_table, run_em
from seekmer_tpu.index.build import build_index_from_seqs
from seekmer_tpu.io.fastq import batch_reads
from seekmer_tpu.map.driver import Mapper
from seekmer_tpu.map.signature import SIG_PAD
from seekmer_tpu.utils.checkpoint import (
    load_em_snapshot,
    save_em_snapshot,
)
from seekmer_tpu.utils.simulate import random_transcriptome, simulate_reads


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(42)
    names, seqs = random_transcriptome(rng, num_transcripts=30,
                                      shared_prefix_frac=0.5)
    index = build_index_from_seqs(names, seqs)
    sim = simulate_reads(rng, seqs, num_reads=600, read_len=100)
    return index, [r.encode() for r in sim.reads1]


def _as_dict(res):
    return {tuple(r[r != int(SIG_PAD)].tolist()): int(n)
            for r, n in zip(res.sigs, res.sig_counts)}


def _write_fastq_plain(path, reads):
    with open(path, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@r{i}\n{r.decode()}\n+\n{'I' * len(r)}\n")


def test_map_checkpoint_resume_offsets(tmp_path, world):
    """Offset-cursor resume: interrupt after a checkpoint, CORRUPT the
    already-consumed file prefix, resume — identical result proves the
    consumed bytes are never re-read (plain files seek; VERDICT round-1
    item 7)."""
    from seekmer_tpu.io.fastq import CheckpointableBatchSource

    index, reads = world
    cfg = MapConfig(batch_size=128, sig_table_bits=12)
    fq = str(tmp_path / "reads.fq")
    _write_fastq_plain(fq, reads)
    ckpt = str(tmp_path / "map.ckpt.npz")

    # uninterrupted baseline
    full = Mapper(index, cfg).run(iter(
        CheckpointableBatchSource([fq], cfg=cfg)))

    # interrupted: feed 2 batches, checkpoint at a cursor-bearing batch.
    # small decode chunks keep the cursor mid-file so the corruption
    # check below is meaningful.
    m1 = Mapper(index, cfg)
    src_obj = CheckpointableBatchSource([fq], cfg=cfg)
    src_obj.CHUNK = 256
    src = iter(src_obj)
    saved = None
    for n, b in enumerate(src, 1):
        m1.feed(b)
        if n >= 2 and b.cursor is not None:
            m1.save_checkpoint(ckpt, stream_state=b.cursor)
            saved = b.cursor
            break
    assert saved is not None

    # corrupt every byte strictly BEFORE the saved offset: a resume that
    # re-reads any consumed input would now see garbage
    off = saved["s1"][1]
    assert off > 0
    with open(fq, "r+b") as fh:
        fh.write(b"X" * off)

    m2 = Mapper(index, cfg)
    src2 = CheckpointableBatchSource([fq], cfg=cfg)
    state = m2.restore_checkpoint(ckpt)
    assert state is not None and state["s1"] == saved["s1"]
    src2.restore(state)
    res = m2.run(iter(src2))

    assert res.total_reads == full.total_reads
    assert _as_dict(res) == _as_dict(full)


def test_paired_checkpoint_resume(tmp_path, world):
    from seekmer_tpu.io.fastq import CheckpointableBatchSource
    from seekmer_tpu.utils.simulate import simulate_reads

    index, _ = world
    rng = np.random.default_rng(42)
    _, seqs = random_transcriptome(rng, num_transcripts=30,
                                   shared_prefix_frac=0.5)
    sim = simulate_reads(rng, seqs, num_reads=500, read_len=100,
                         paired=True, mean_frag=180.0, sd_frag=15.0)
    fq1, fq2 = str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")
    _write_fastq_plain(fq1, [r.encode() for r in sim.reads1])
    _write_fastq_plain(fq2, [r.encode() for r in sim.reads2])
    cfg = MapConfig(batch_size=128, sig_table_bits=12, paired_end=True)
    ckpt = str(tmp_path / "pmap.ckpt.npz")

    full = Mapper(index, cfg).run(iter(
        CheckpointableBatchSource([fq1], [fq2], cfg)))

    m1 = Mapper(index, cfg)
    for n, b in enumerate(iter(CheckpointableBatchSource([fq1], [fq2],
                                                         cfg)), 1):
        m1.feed(b)
        if b.cursor is not None:
            m1.save_checkpoint(ckpt, stream_state=b.cursor)
            break

    m2 = Mapper(index, cfg)
    src2 = CheckpointableBatchSource([fq1], [fq2], cfg)
    state = m2.restore_checkpoint(ckpt)
    assert state["paired"] is True
    src2.restore(state)
    res = m2.run(iter(src2))
    assert res.total_reads == full.total_reads == 500
    assert _as_dict(res) == _as_dict(full)


def test_dp_mapper_checkpoint_resume(tmp_path, world):
    """Multi-chip checkpoint/resume on the fake mesh (VERDICT round-1
    item 7: 'allgather + save the sharded SigTable for the DP mapper')."""
    from seekmer_tpu.config import ShardConfig
    from seekmer_tpu.io.fastq import CheckpointableBatchSource
    from seekmer_tpu.parallel.data_parallel import DataParallelMapper
    from seekmer_tpu.parallel.mesh import make_mesh

    index, reads = world
    cfg = MapConfig(batch_size=128, sig_table_bits=12)
    shard_cfg = ShardConfig(data_axis=8)
    mesh = make_mesh(shard_cfg)
    fq = str(tmp_path / "reads.fq")
    _write_fastq_plain(fq, reads)
    ckpt = str(tmp_path / "dp.ckpt.npz")

    full = DataParallelMapper(index, cfg, shard_cfg, mesh=mesh).run(
        iter(CheckpointableBatchSource([fq], cfg=cfg)))

    m1 = DataParallelMapper(index, cfg, shard_cfg, mesh=mesh)
    for b in iter(CheckpointableBatchSource([fq], cfg=cfg)):
        m1.feed(b)
        if b.cursor is not None:
            m1.save_checkpoint(ckpt, stream_state=b.cursor)
            break

    m2 = DataParallelMapper(index, cfg, shard_cfg, mesh=mesh)
    src2 = CheckpointableBatchSource([fq], cfg=cfg)
    state = m2.restore_checkpoint(ckpt)
    assert state is not None
    src2.restore(state)
    res = m2.run(iter(src2))
    assert res.total_reads == full.total_reads
    assert _as_dict(res) == _as_dict(full)


def test_prefix_mapper_checkpoint_resume(tmp_path, world):
    """Checkpoint/resume for the PREFIX-SHARDED mapper on the fake mesh
    (VERDICT round-2 item 3): same sharded-table save/restore pattern as
    the DP mapper, table sharded over both mesh axes. Paired-end to cover
    the concatenated-mates routing path."""
    from seekmer_tpu.config import ShardConfig
    from seekmer_tpu.io.fastq import CheckpointableBatchSource
    from seekmer_tpu.parallel.mesh import make_mesh
    from seekmer_tpu.parallel.prefix_shard import PrefixShardedMapper

    index, _ = world
    rng = np.random.default_rng(42)
    _, seqs = random_transcriptome(rng, num_transcripts=30,
                                   shared_prefix_frac=0.5)
    sim = simulate_reads(rng, seqs, num_reads=500, read_len=100,
                         paired=True, mean_frag=180.0, sd_frag=15.0)
    fq1, fq2 = str(tmp_path / "p1.fq"), str(tmp_path / "p2.fq")
    _write_fastq_plain(fq1, [r.encode() for r in sim.reads1])
    _write_fastq_plain(fq2, [r.encode() for r in sim.reads2])
    cfg = MapConfig(batch_size=128, sig_table_bits=12, paired_end=True)
    shard_cfg = ShardConfig(data_axis=2, index_axis=4, index_mode="prefix")
    mesh = make_mesh(shard_cfg)
    ckpt = str(tmp_path / "px.ckpt.npz")

    full = PrefixShardedMapper(index, cfg, shard_cfg, mesh=mesh).run(
        iter(CheckpointableBatchSource([fq1], [fq2], cfg)))

    m1 = PrefixShardedMapper(index, cfg, shard_cfg, mesh=mesh)
    assert m1.supports_checkpoint()
    for b in iter(CheckpointableBatchSource([fq1], [fq2], cfg)):
        m1.feed(b)
        if b.cursor is not None:
            m1.save_checkpoint(ckpt, stream_state=b.cursor)
            break

    m2 = PrefixShardedMapper(index, cfg, shard_cfg, mesh=mesh)
    src2 = CheckpointableBatchSource([fq1], [fq2], cfg)
    state = m2.restore_checkpoint(ckpt)
    assert state is not None and state["paired"] is True
    src2.restore(state)
    res = m2.run(iter(src2))
    assert res.total_reads == full.total_reads == 500
    assert _as_dict(res) == _as_dict(full)

    # and the single-chip mapper agrees (routing exactness)
    single = Mapper(index, cfg)
    ref = single.run(iter(CheckpointableBatchSource([fq1], [fq2], cfg)))
    assert _as_dict(res) == _as_dict(ref)


def test_gz_offset_resume(tmp_path, world):
    """.gz inputs resume through the C reader's in-library seek."""
    import gzip

    from seekmer_tpu.io.fastq import CheckpointableBatchSource

    index, reads = world
    cfg = MapConfig(batch_size=128, sig_table_bits=12)
    fq = str(tmp_path / "reads.fq.gz")
    with gzip.open(fq, "wt") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@r{i}\n{r.decode()}\n+\n{'I' * len(r)}\n")
    ckpt = str(tmp_path / "gz.ckpt.npz")

    full = Mapper(index, cfg).run(iter(
        CheckpointableBatchSource([fq], cfg=cfg)))

    m1 = Mapper(index, cfg)
    for b in iter(CheckpointableBatchSource([fq], cfg=cfg)):
        m1.feed(b)
        if b.cursor is not None:
            m1.save_checkpoint(ckpt, stream_state=b.cursor)
            break

    m2 = Mapper(index, cfg)
    src2 = CheckpointableBatchSource([fq], cfg=cfg)
    src2.restore(m2.restore_checkpoint(ckpt))
    res = m2.run(iter(src2))
    assert res.total_reads == full.total_reads
    assert _as_dict(res) == _as_dict(full)


def test_restore_missing_checkpoint(tmp_path, world):
    index, _ = world
    m = Mapper(index, MapConfig(batch_size=128))
    assert m.restore_checkpoint(str(tmp_path / "nope.npz")) is None


def test_em_snapshot_roundtrip_and_warm_start(tmp_path, world):
    index, reads = world
    cfg = MapConfig(batch_size=128, sig_table_bits=12)
    from seekmer_tpu.map.driver import resolve_signatures

    result = Mapper(index, cfg).run(batch_reads(reads, cfg))
    members, counts, _ = resolve_signatures(result, index)
    ec = build_ec_table(members, counts, index.num_transcripts)
    em_cfg = EMConfig(rel_tol=1e-6)

    alpha, it = run_em(ec, index.lengths, em_cfg)
    p = str(tmp_path / "em.npz")
    save_em_snapshot(p, np.asarray(alpha), int(it))
    alpha2, it2, conv2 = load_em_snapshot(p)
    np.testing.assert_array_equal(alpha2, np.asarray(alpha))
    assert (it2, conv2) == (int(it), False)
    save_em_snapshot(p, np.asarray(alpha), int(it), converged=True)
    assert load_em_snapshot(p)[2] is True

    # warm start from the converged alpha: converges immediately
    alpha3, it3 = run_em(ec, index.lengths, em_cfg,
                         alpha_init=np.asarray(alpha))
    # converges at the first block boundary at/after min_iters
    assert int(it3) <= em_cfg.min_iters + em_cfg.check_every
    np.testing.assert_allclose(np.asarray(alpha3), np.asarray(alpha),
                               rtol=1e-5, atol=1e-5)


def _ec_world(world):
    from seekmer_tpu.map.driver import resolve_signatures

    index, reads = world
    cfg = MapConfig(batch_size=128, sig_table_bits=12)
    result = Mapper(index, cfg).run(batch_reads(reads, cfg))
    members, counts, _ = resolve_signatures(result, index)
    return index, build_ec_table(members, counts, index.num_transcripts)


def test_em_interrupt_resume_exact(world):
    """Kill the CHUNKED EM at its first snapshot sync, resume from the
    snapshot state, and land on the uninterrupted run's result EXACTLY
    (VERDICT round-2 item 2's done-criterion: snapshots are genuine block
    boundaries, so the resumed run replays the identical iterate
    sequence)."""
    index, ec = _ec_world(world)
    em_cfg = EMConfig(rel_tol=1e-10, check_every=8, max_iters=400)

    full_alpha, full_it = run_em(ec, index.lengths, em_cfg, chunked=True)
    assert int(full_it) > em_cfg.check_every  # multiple blocks ran

    class Boom(Exception):
        pass

    saves = []

    def on_sync(a, it):
        saves.append((a.copy(), it))
        raise Boom  # simulated crash right after the first snapshot

    with pytest.raises(Boom):
        run_em(ec, index.lengths, em_cfg, chunked=True, on_sync=on_sync)
    a0, it0 = saves[-1]
    assert 0 < it0 < int(full_it)

    alpha_r, it_r = run_em(ec, index.lengths, em_cfg, alpha_init=a0,
                           it_init=it0, chunked=True)
    assert int(it_r) == int(full_it)
    np.testing.assert_array_equal(np.asarray(alpha_r),
                                  np.asarray(full_alpha))


def test_bootstrap_interrupt_resume_exact(world):
    """Same kill-and-resume criterion for the CHUNKED batched bootstrap:
    resampling is seeded, so the resumed run regenerates the identical
    count matrix and replays the identical batched iterate sequence."""
    from seekmer_tpu.em.bootstrap import run_bootstrap

    index, ec = _ec_world(world)
    em_cfg = EMConfig(rel_tol=1e-10, check_every=8, max_iters=400,
                      bootstrap_samples=6, bootstrap_seed=3)

    full = np.asarray(run_bootstrap(ec, index.lengths, em_cfg,
                                    chunked=True))

    class Boom(Exception):
        pass

    saves = []

    def on_sync(a, it):
        saves.append((a.copy(), it))
        raise Boom

    with pytest.raises(Boom):
        run_bootstrap(ec, index.lengths, em_cfg, chunked=True,
                      on_sync=on_sync)
    a0, it0 = saves[-1]
    assert a0.shape == (index.num_transcripts, 6) and it0 > 0

    res = np.asarray(run_bootstrap(ec, index.lengths, em_cfg,
                                   alpha_init=a0, it_init=it0,
                                   chunked=True))
    np.testing.assert_array_equal(res, full)


def test_pipeline_em_snapshot_lifecycle(tmp_path, world):
    """Pipeline-level wiring: a leftover EM snapshot (simulated crash
    residue) warm-starts the quantifier without changing the answer, and
    a completed run cleans its stage snapshots up."""
    from seekmer_tpu.config import PipelineConfig
    from seekmer_tpu.io.fastq import CheckpointableBatchSource
    from seekmer_tpu.models.quantifier import Quantifier

    index, reads = world
    fq = str(tmp_path / "reads.fq")
    _write_fastq_plain(fq, reads)
    ckpt = str(tmp_path / "run.ckpt.npz")
    cfg = PipelineConfig().replace(
        map=MapConfig(batch_size=128, sig_table_bits=12),
        em=EMConfig(rel_tol=1e-6, bootstrap_samples=4))

    fresh = Quantifier(index, cfg).quantify_files([fq],
                                                  checkpoint_path=ckpt)
    # completed run leaves no stage snapshots behind
    assert not os.path.exists(ckpt + ".em.npz")
    assert not os.path.exists(ckpt + ".boot.npz")

    # plant a converged-EM snapshot (crash-after-EM residue): resumed run
    # must produce the same abundances and clean up again
    save_em_snapshot(ckpt + ".em.npz", fresh.est_counts, 64)
    resumed = Quantifier(index, cfg).quantify_files([fq],
                                                    checkpoint_path=ckpt)
    np.testing.assert_allclose(resumed.est_counts, fresh.est_counts,
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(resumed.bootstrap_counts,
                                  fresh.bootstrap_counts)
    assert not os.path.exists(ckpt + ".em.npz")

    # wrong-shape snapshot is ignored, not fatal
    save_em_snapshot(ckpt + ".em.npz", np.ones(3), 7)
    again = Quantifier(index, cfg).quantify_files([fq],
                                                  checkpoint_path=ckpt)
    np.testing.assert_allclose(again.est_counts, fresh.est_counts,
                               rtol=1e-5, atol=1e-4)

    # a CONVERGED pin skips the EM stage EXACTLY on resume
    save_em_snapshot(ckpt + ".em.npz", fresh.est_counts,
                     fresh.em_iterations, converged=True)
    skipped = Quantifier(index, cfg).quantify_files([fq],
                                                    checkpoint_path=ckpt)
    np.testing.assert_array_equal(skipped.est_counts, fresh.est_counts)
    assert skipped.em_iterations == fresh.em_iterations


def test_capped_em_pins_unconverged(tmp_path, world, monkeypatch):
    """A max_iters-capped EM stage must pin converged=False so resume
    CONTINUES iterating under a raised budget, while a truly converged
    stage pins converged=True (exact skip). Observed by crashing the run
    during bootstrap — the realistic scenario the pin exists for — which
    leaves the stage snapshots on disk (round-3 review finding)."""
    from seekmer_tpu import em as em_pkg
    from seekmer_tpu.config import PipelineConfig
    from seekmer_tpu.models.quantifier import Quantifier
    from seekmer_tpu.utils.checkpoint import load_em_snapshot

    index, reads = world
    fq = str(tmp_path / "reads.fq")
    _write_fastq_plain(fq, reads)
    ckpt = str(tmp_path / "cap.ckpt.npz")

    def boom(*a, **k):
        raise RuntimeError("simulated crash during bootstrap")

    monkeypatch.setattr(em_pkg.bootstrap, "run_bootstrap", boom)

    def run(max_iters):
        cfg = PipelineConfig().replace(
            map=MapConfig(batch_size=128, sig_table_bits=12),
            em=EMConfig(rel_tol=1e-6, max_iters=max_iters,
                        bootstrap_samples=2))
        with pytest.raises(RuntimeError, match="simulated crash"):
            Quantifier(index, cfg).quantify_files([fq],
                                                  checkpoint_path=ckpt)
        pin = load_em_snapshot(ckpt + ".em.npz")
        assert pin is not None
        os.remove(ckpt + ".em.npz")
        return pin

    _, it_capped, conv_capped = run(max_iters=8)
    assert conv_capped is False and it_capped >= 8  # capped: must resume

    _, _, conv_ok = run(max_iters=5000)
    assert conv_ok is True  # converged: resume skips the stage exactly


def test_old_format_checkpoint_rejected(tmp_path):
    import json

    import numpy as np
    import pytest

    from seekmer_tpu.utils import checkpoint as cp

    path = str(tmp_path / "old.ckpt")
    meta = dict(format=2, total_reads=5, stream_state={})
    with open(path, "wb") as fh:
        np.savez_compressed(
            fh,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            key=np.zeros((17, 2), np.int32), count=np.zeros(17, np.int32),
            sig=np.zeros((17, 4), np.int32), overflow=np.zeros((), np.int32))
    with pytest.raises(ValueError, match="format"):
        cp.load_map_checkpoint(path)


def test_write_h5_roundtrip(tmp_path):
    """kallisto-compatible abundance.h5 schema (sleuth-consumable)."""
    h5py = pytest.importorskip("h5py")
    import numpy as np

    from seekmer_tpu.io.writer import write_h5

    T, B = 7, 3
    rng = np.random.default_rng(0)
    names = np.array([f"t{i}" for i in range(T)])
    lengths = rng.integers(200, 900, T).astype(np.int32)
    eff = lengths - 150.0
    est = rng.random(T) * 100
    boot = rng.random((B, T)) * 100
    path = str(tmp_path / "abundance.h5")
    ok = write_h5(path, names, lengths, eff, est, boot_counts=boot,
                  run_info={"total_reads": 1234, "call": "test"})
    assert ok
    with h5py.File(path) as f:
        np.testing.assert_allclose(f["est_counts"][:], est)
        assert [x.decode() for x in f["aux/ids"][:]] == list(names)
        np.testing.assert_array_equal(f["aux/lengths"][:], lengths)
        np.testing.assert_allclose(f["aux/eff_lengths"][:], eff)
        assert int(f["aux/num_bootstrap"][0]) == B
        assert int(f["aux/num_processed"][0]) == 1234
        np.testing.assert_allclose(f["bootstrap/bs1"][:], boot[1])


def test_multifile_offset_resume_crosses_file_boundary(tmp_path, world):
    """Cursor spanning several input files: checkpoint lands inside file 2;
    files 0/1 and the consumed prefix of file 2 are then corrupted —
    resume must not touch them."""
    from seekmer_tpu.io.fastq import CheckpointableBatchSource

    index, reads = world
    cfg = MapConfig(batch_size=128, sig_table_bits=12)
    files = []
    for i in range(3):
        p = str(tmp_path / f"part{i}.fq")
        _write_fastq_plain(p, reads[i * 200:(i + 1) * 200])
        files.append(p)
    ckpt = str(tmp_path / "mf.ckpt.npz")

    full = Mapper(index, cfg).run(iter(
        CheckpointableBatchSource(files, cfg=cfg)))

    m1 = Mapper(index, cfg)
    src = CheckpointableBatchSource(files, cfg=cfg)
    src.CHUNK = 96  # small chunks -> cursors advance within files
    saved = None
    for b in iter(src):
        m1.feed(b)
        if b.cursor is not None and b.cursor["s1"][0] >= 2:
            m1.save_checkpoint(ckpt, stream_state=b.cursor)
            saved = b.cursor
            break
    assert saved is not None and saved["s1"][0] == 2

    # corrupt everything already consumed
    for i in range(2):
        with open(files[i], "r+b") as fh:
            fh.write(b"X" * os.path.getsize(files[i]))
    if saved["s1"][1] > 0:
        with open(files[2], "r+b") as fh:
            fh.write(b"X" * saved["s1"][1])

    m2 = Mapper(index, cfg)
    src2 = CheckpointableBatchSource(files, cfg=cfg)
    src2.restore(m2.restore_checkpoint(ckpt))
    res = m2.run(iter(src2))
    assert res.total_reads == full.total_reads == 600
    assert _as_dict(res) == _as_dict(full)


def test_mixed_length_pending_buffers_resume(tmp_path, world):
    """Reads in several length buckets: the checkpoint carries one
    pending buffer per bucket; resume reproduces the uninterrupted
    result exactly."""
    from seekmer_tpu.io.fastq import CheckpointableBatchSource

    index, reads = world
    rng = np.random.default_rng(3)
    mixed = [r[: int(rng.integers(60, 101))] for r in reads]
    cfg = MapConfig(batch_size=64, sig_table_bits=12)
    fq = str(tmp_path / "mixed.fq")
    _write_fastq_plain(fq, mixed)
    ckpt = str(tmp_path / "mx.ckpt.npz")

    full = Mapper(index, cfg).run(iter(
        CheckpointableBatchSource([fq], cfg=cfg)))

    m1 = Mapper(index, cfg)
    src = CheckpointableBatchSource([fq], cfg=cfg)
    src.CHUNK = 100
    fed = 0
    saved = None
    for b in iter(src):
        m1.feed(b)
        fed += 1
        if fed >= 3 and b.cursor is not None:
            assert b.cursor["pending"], "fixture should have pending rows"
            m1.save_checkpoint(ckpt, stream_state=b.cursor)
            saved = b.cursor
            break
    assert saved is not None

    m2 = Mapper(index, cfg)
    src2 = CheckpointableBatchSource([fq], cfg=cfg)
    src2.restore(m2.restore_checkpoint(ckpt))
    res = m2.run(iter(src2))
    assert res.total_reads == full.total_reads == len(mixed)
    assert _as_dict(res) == _as_dict(full)


def test_cursorless_checkpoint_starts_fresh(tmp_path, world):
    """A checkpoint with no stream cursor cannot be resumed safely: the
    quantifier must discard the restored table and start fresh, not
    double-count the consumed reads (round-2 review finding)."""
    from seekmer_tpu.config import PipelineConfig
    from seekmer_tpu.models.quantifier import Quantifier

    index, reads = world
    cfg = PipelineConfig().replace(
        map=MapConfig(batch_size=128, sig_table_bits=12))
    fq = str(tmp_path / "reads.fq")
    _write_fastq_plain(fq, reads)
    ckpt = str(tmp_path / "nocursor.ckpt.npz")

    # a full run whose final checkpoint we then strip of its cursor by
    # re-saving without stream_state
    m = Mapper(index, cfg.map)
    from seekmer_tpu.io.fastq import CheckpointableBatchSource

    m.run(iter(CheckpointableBatchSource([fq], cfg=cfg.map)))
    m.save_checkpoint(ckpt, stream_state=None)

    baseline = Quantifier(index, cfg).quantify_files([fq])
    resumed = Quantifier(index, cfg).quantify_files([fq],
                                                    checkpoint_path=ckpt)
    assert resumed.total_reads == baseline.total_reads == 600
    assert resumed.mapped == baseline.mapped  # NOT doubled
    np.testing.assert_allclose(resumed.est_counts, baseline.est_counts,
                               rtol=1e-5)


def test_multiprocess_checkpoint_step_mismatch_refused(tmp_path, world):
    """A multi-process checkpoint whose global table and host cursor
    sidecar carry different save steps (crash mid-save, or a resume under
    a different process count) must be REFUSED, not silently resumed
    (parallel/ckpt_mp.py)."""
    from seekmer_tpu.map.signature import make_sig_table
    from seekmer_tpu.parallel.ckpt_mp import restore_sharded_checkpoint
    from seekmer_tpu.utils.checkpoint import (
        save_host_cursor, save_map_checkpoint)

    path = str(tmp_path / "mp.ckpt.npz")
    table = make_sig_table(bits=4, max_ecs=4)
    save_map_checkpoint(path, table, -1, None, step=2)
    save_host_cursor(path, 0, None, total_reads=10, step=1)  # stale
    with pytest.raises(ValueError, match="inconsistent"):
        restore_sharded_checkpoint(path)

    # matching steps restore fine and return the per-host counter
    save_host_cursor(path, 0, None, total_reads=10, step=2)
    got = restore_sharded_checkpoint(path)
    assert got is not None
    _table, total_reads, cursor, step = got
    assert (total_reads, cursor, step) == (10, None, 2)

    # missing sidecar (host joined that never saved) also refused
    import os

    os.remove(path + ".host0.npz")
    with pytest.raises(ValueError, match="inconsistent"):
        restore_sharded_checkpoint(path)


def test_multiprocess_checkpoint_refused_single_process(tmp_path, world):
    """A checkpoint written by a MULTI-process save (total_reads is the -1
    sentinel; the authoritative counters live in per-host sidecars) must be
    refused by a single-process restore — silently restoring it leaves
    mapper.total_reads negative and MapResult.unmapped nonsensical
    (round-3 advisor finding)."""
    from seekmer_tpu.config import ShardConfig
    from seekmer_tpu.map.signature import SigTable
    from seekmer_tpu.parallel.data_parallel import DataParallelMapper
    from seekmer_tpu.parallel.mesh import make_mesh
    from seekmer_tpu.utils.checkpoint import save_map_checkpoint

    index, _ = world
    shard = ShardConfig(data_axis=8)
    dp = DataParallelMapper(index, MapConfig(batch_size=128,
                                             sig_table_bits=12),
                            shard, mesh=make_mesh(shard))
    path = str(tmp_path / "mp_single.ckpt.npz")
    host = SigTable(*(np.asarray(x) for x in dp.table))
    save_map_checkpoint(path, host, -1, None, step=3)
    with pytest.raises(ValueError, match="multi-process"):
        dp.restore_checkpoint(path)
