"""Native C FASTQ packer vs the pure-Python path (SURVEY.md 7.5 item 4:
host ingest keeping chips fed; the one C component of the build)."""

import gzip

import numpy as np
import pytest

from seekmer_tpu.config import MapConfig
from seekmer_tpu.io.fastq import batch_reads, batch_reads_native, read_fastq_many
from seekmer_tpu.native.packer import get_lib, pack_chunk, stream_packed
from seekmer_tpu.utils.simulate import simulate_reads, random_transcriptome, write_fastq

pytestmark = pytest.mark.skipif(
    get_lib() is None, reason="no C compiler for native packer"
)


def _mk_fastq(tmp_path, reads, gz=False, name="r.fq"):
    p = str(tmp_path / (name + (".gz" if gz else "")))
    write_fastq(p, reads)
    return p


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(8)
    _, seqs = random_transcriptome(rng, num_transcripts=10)
    sim = simulate_reads(rng, seqs, num_reads=500, read_len=87)
    # mix in odd lengths and N bases
    out = list(sim.reads1)
    out[0] = out[0][:30]
    out[1] = out[1][:10] + "N" * 5 + out[1][15:]
    out[2] = out[2].lower()
    return out


def test_pack_chunk_basic():
    buf = b"@r0\nACGTN\n+\nIIIII\n@r1\nggcc\n+\nIIII\n"
    codes, lengths, consumed = pack_chunk(buf, 10, 8)
    assert consumed == len(buf)
    assert lengths.tolist() == [5, 4]
    assert codes[0].tolist() == [0, 1, 2, 3, 4, 4, 4, 4]
    assert codes[1].tolist() == [2, 2, 1, 1, 4, 4, 4, 4]


def test_pack_chunk_partial_record():
    buf = b"@r0\nACGT\n+\nIIII\n@r1\nACG"
    codes, lengths, consumed = pack_chunk(buf, 10, 8)
    assert lengths.tolist() == [4]
    assert consumed == 16  # only the complete record


def test_pack_chunk_malformed():
    with pytest.raises(ValueError):
        pack_chunk(b"not a fastq\nxx\n", 4, 8)


@pytest.mark.parametrize("gz", [False, True])
def test_stream_matches_python(tmp_path, reads, gz):
    p = _mk_fastq(tmp_path, reads, gz=gz)
    got_lens, got_first = [], []
    for codes, lengths in stream_packed(p, max_len=512, chunk_reads=7):
        got_lens.extend(lengths.tolist())
        got_first.extend(codes[:, 0].tolist())
    assert got_lens == [len(r) for r in reads]


def test_paired_native_equals_python(tmp_path, reads):
    from seekmer_tpu.io.fastq import batch_read_pairs, batch_read_pairs_native

    mates = [r[::-1] for r in reads]  # arbitrary distinct mate content
    p1 = _mk_fastq(tmp_path, reads, name="r1.fq")
    p2 = _mk_fastq(tmp_path, mates, gz=True, name="r2.fq")
    cfg = MapConfig(batch_size=64)
    a = list(batch_read_pairs_native([p1], [p2], cfg))
    b = list(batch_read_pairs(
        zip((r.encode() for r in reads), (m.encode() for m in mates)), cfg))

    def flatten(batches):
        rows = []
        for batch in batches:
            for i in range(batch.codes.shape[0]):
                if batch.weights[i]:
                    rows.append((
                        tuple(batch.codes[i, : batch.lengths[i]].tolist()),
                        tuple(batch.codes2[i, : batch.lengths2[i]].tolist()),
                    ))
        return sorted(rows)

    assert flatten(a) == flatten(b)


def test_paired_native_unequal_counts(tmp_path, reads):
    from seekmer_tpu.io.fastq import batch_read_pairs_native

    p1 = _mk_fastq(tmp_path, reads, name="u1.fq")
    p2 = _mk_fastq(tmp_path, reads[:-5], name="u2.fq")
    with pytest.raises(ValueError, match="unequal"):
        list(batch_read_pairs_native([p1], [p2], MapConfig(batch_size=64)))


def test_batches_native_equals_python(tmp_path, reads):
    p = _mk_fastq(tmp_path, reads)
    cfg = MapConfig(batch_size=64)
    a = list(batch_reads_native([p], cfg))
    b = list(batch_reads((r.encode() for r in reads), cfg))

    def flatten(batches):
        rows = []
        for batch in batches:
            for i in range(batch.codes.shape[0]):
                if batch.weights[i]:
                    rows.append(
                        tuple(batch.codes[i, : batch.lengths[i]].tolist()))
        return sorted(rows)

    assert flatten(a) == flatten(b)


def _flatten_rows(batches, paired=False):
    rows = []
    for batch in batches:
        for i in range(batch.codes.shape[0]):
            if batch.weights[i]:
                r = tuple(batch.codes[i, : batch.lengths[i]].tolist())
                if paired:
                    r = (r, tuple(
                        batch.codes2[i, : batch.lengths2[i]].tolist()))
                rows.append(r)
    return sorted(rows)


def test_parallel_ingest_equals_serial(tmp_path, reads):
    """Multi-file threaded decode yields the same multiset of reads."""
    paths = []
    for i in range(3):
        part = reads[i::3]
        paths.append(_mk_fastq(tmp_path, part, gz=True, name=f"p{i}.fq"))
    serial = MapConfig(batch_size=64, io_workers=1)
    par = MapConfig(batch_size=64, io_workers=3)
    a = _flatten_rows(batch_reads_native(paths, serial))
    b = _flatten_rows(batch_reads_native(paths, par))
    assert a == b


def test_parallel_paired_ingest_equals_serial(tmp_path, reads):
    from seekmer_tpu.io.fastq import batch_read_pairs_native

    n = len(reads) // 2
    r1, r2 = reads[:n], reads[n:2 * n]
    paths1, paths2 = [], []
    for i in range(2):
        paths1.append(_mk_fastq(tmp_path, r1[i::2], gz=True, name=f"a{i}.fq"))
        paths2.append(_mk_fastq(tmp_path, r2[i::2], gz=True, name=f"b{i}.fq"))
    serial = MapConfig(batch_size=64, io_workers=1, paired_end=True)
    par = MapConfig(batch_size=64, io_workers=2, paired_end=True)
    a = _flatten_rows(batch_read_pairs_native(paths1, paths2, serial),
                      paired=True)
    b = _flatten_rows(batch_read_pairs_native(paths1, paths2, par),
                      paired=True)
    assert a == b


def test_truncated_gz_raises(tmp_path, reads):
    """A .gz cut short must raise, not silently succeed with fewer reads."""
    import gzip

    p = str(tmp_path / "t.fq.gz")
    write_fastq(p, reads)
    blob = open(p, "rb").read()
    cut = str(tmp_path / "cut.fq.gz")
    with open(cut, "wb") as fh:
        fh.write(blob[: len(blob) // 2])
    with pytest.raises((OSError, ValueError)):
        for _ in stream_packed(cut, 512):
            pass


def test_parallel_chunks_worker_cap_and_abort(tmp_path, reads):
    """More files than workers completes correctly; abandoning the
    consumer mid-stream must not deadlock (cancel path)."""
    from seekmer_tpu.io.fastq import _parallel_chunks

    paths = [_mk_fastq(tmp_path, reads[i::5], gz=True, name=f"w{i}.fq")
             for i in range(5)]
    makers = [(lambda p=p: stream_packed(p, 512, chunk_reads=16))
              for p in paths]
    total = sum(c.shape[0] for c, _ in _parallel_chunks(makers, workers=2))
    assert total == len(reads)
    # early abandon: take one item, close the generator
    gen = _parallel_chunks([(lambda p=p: stream_packed(p, 512,
                                                       chunk_reads=4))
                            for p in paths], workers=2)
    next(gen)
    gen.close()  # must not hang


# ---- adversarial inputs (VERDICT round-1 item 9): both readers must agree


def _write(tmp_path, name, text, gz=False):
    import gzip as _gz

    p = str(tmp_path / name)
    if gz:
        with _gz.open(p, "wt") as fh:
            fh.write(text)
    else:
        with open(p, "w") as fh:
            fh.write(text)
    return p


def test_n_heavy_reads_map_as_invalid(tmp_path):
    """N-heavy and lowercase reads: code 4 windows are invalid, never a
    crash; both readers produce identical codes."""
    text = ("@a\nNNNNNNNNNNNNNNNNNNNNNNNNNNNNNN\n+\nIIIIIIIIIIIIIIIIIIIIIIIIIIIIII\n"
            "@b\nacgtACGTnNacgtACGTacgtACGTacgt\n+\nIIIIIIIIIIIIIIIIIIIIIIIIIIIIII\n"
            "@c\nACGTRYKMSWBDHVacgtACGTACGTACGT\n+\nIIIIIIIIIIIIIIIIIIIIIIIIIIIIII\n")
    p = _write(tmp_path, "n.fq", text)
    from seekmer_tpu.encoding import seq_to_codes

    c_codes = np.concatenate([c for c, _ in stream_packed(p, 64)])
    py = [b"NNNNNNNNNNNNNNNNNNNNNNNNNNNNNN",
          b"acgtACGTnNacgtACGTacgtACGTacgt",
          b"ACGTRYKMSWBDHVacgtACGTACGTACGT"]
    for row, s in zip(c_codes, py):
        np.testing.assert_array_equal(row[: len(s)], seq_to_codes(s))
        assert (row[len(s):] == 4).all()
    assert (c_codes[0] == 4).all()  # all-N row fully invalid


def test_reads_shorter_than_k(tmp_path):
    """Reads shorter than k=25 produce zero valid windows, map as
    unmapped — not a crash — through the full pipeline."""
    from seekmer_tpu.config import MapConfig
    from seekmer_tpu.index.build import build_index_from_seqs
    from seekmer_tpu.models.quantifier import Quantifier
    from seekmer_tpu.config import PipelineConfig
    from seekmer_tpu.utils.simulate import random_transcriptome

    rng = np.random.default_rng(0)
    names, seqs = random_transcriptome(rng, num_transcripts=10)
    index = build_index_from_seqs(names, seqs)
    short = ["ACGT", "A", seqs[0][:24], seqs[0][:100]]
    q = Quantifier(index, PipelineConfig().replace(
        map=MapConfig(batch_size=64, sig_table_bits=10)))
    res = q.quantify_reads(short)
    assert res.total_reads == 4
    assert res.mapped == 1  # only the 100bp read has valid windows


def test_malformed_fastq_python_reader(tmp_path):
    from seekmer_tpu.io.fastq import read_fastq

    p = _write(tmp_path, "bad.fq", "not a fastq\nACGT\n+\nIIII\n")
    with pytest.raises(ValueError, match="malformed"):
        list(read_fastq(p))


def test_malformed_fastq_c_reader(tmp_path):
    p = _write(tmp_path, "bad2.fq", "@ok\nACGT\n+\nIIII\nnot a record\n")
    with pytest.raises(ValueError, match="malformed"):
        for _ in stream_packed(p, 64):
            pass


def test_malformed_fastq_checkpoint_source(tmp_path):
    from seekmer_tpu.config import MapConfig
    from seekmer_tpu.io.fastq import CheckpointableBatchSource

    p = _write(tmp_path, "bad3.fq", "garbage\n")
    src = CheckpointableBatchSource([p], cfg=MapConfig(batch_size=8))
    with pytest.raises(ValueError, match="malformed"):
        list(iter(src))


def test_empty_fastq(tmp_path):
    from seekmer_tpu.config import MapConfig
    from seekmer_tpu.io.fastq import CheckpointableBatchSource, batch_reads_native

    for gz in (False, True):
        p = _write(tmp_path, f"empty{gz}.fq" + (".gz" if gz else ""),
                   "", gz=gz)
        assert list(batch_reads_native([p], MapConfig(batch_size=8))) == []
        assert list(iter(CheckpointableBatchSource(
            [p], cfg=MapConfig(batch_size=8)))) == []


def test_checkpoint_source_native_equals_python(tmp_path, reads):
    """The C-bucketer CheckpointableBatchSource path must yield the same
    real rows per bucket as the pure-Python path (round-5: the consumer
    bucket-copy moved into GIL-released C)."""
    from seekmer_tpu.io.fastq import CheckpointableBatchSource

    rng = np.random.default_rng(11)
    mixed = [r[: int(rng.integers(20, len(r) + 1))] for r in reads]
    mates = [r[::-1] for r in mixed]
    p1 = _mk_fastq(tmp_path, mixed, name="cs1.fq")
    p2 = _mk_fastq(tmp_path, mates, gz=True, name="cs2.fq")
    cfg = MapConfig(batch_size=64)

    for mate_paths in (None, [p2]):
        src = CheckpointableBatchSource([p1], mate_paths, cfg)
        src.CHUNK = 37
        native = list(src._iter_native())
        src2 = CheckpointableBatchSource([p1], mate_paths, cfg)
        src2.CHUNK = 37
        python = list(src2._iter_py())
        paired = mate_paths is not None
        assert _flatten_rows(native, paired) == _flatten_rows(python, paired)
        # identical cursor-bearing snapshots at the end of each chunk
        n_cur = [b.cursor for b in native if b.cursor is not None]
        p_cur = [b.cursor for b in python if b.cursor is not None]
        assert len(n_cur) == len(p_cur) > 0
        assert n_cur[-1]["s1"] == p_cur[-1]["s1"]


def test_bucketer_pending_roundtrip(reads):
    """Bucketer pending export -> restore reproduces the same batches as
    an uninterrupted run."""
    from seekmer_tpu.native.packer import Bucketer

    rng = np.random.default_rng(5)
    L = 128
    n = 150
    codes = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    lengths = rng.integers(10, L + 1, size=n).astype(np.int32)
    for i in range(n):
        codes[i, lengths[i]:] = 4

    def run(split):
        bk = Bucketer(32, L, 32, paired=False)
        out = []
        bk.feed(codes[:split], lengths[:split])
        out.extend(bk.pop_ready())
        state = bk.pending_state()
        bk2 = Bucketer(32, L, 32, paired=False)
        bk2.restore_pending(state)
        bk.close()
        bk2.feed(codes[split:], lengths[split:])
        out.extend(bk2.pop_ready())
        out.extend(bk2.flush())
        bk2.close()
        rows = []
        for c1, l1, _, _, fill in out:
            for i in range(fill):
                rows.append(tuple(c1[i, : l1[i]].tolist()))
        return sorted(rows)

    base = run(0)
    assert run(77) == base
    assert len(base) == n


def test_cpu_baseline_matches_oracle():
    """The compiled single-core baseline (bench.py's vs_baseline stand-in
    for the reference's Cython mapper core) must agree with the oracle on
    mapped count and distinct-signature count — it is a BASELINE, so its
    work has to be the real work."""
    np_rng = np.random.default_rng(7)
    from seekmer_tpu.index.build import build_index_from_seqs
    from seekmer_tpu.native.cpu_baseline import CpuBaselineMapper, get_lib
    from seekmer_tpu.utils.simulate import random_transcriptome, simulate_reads
    from seekmer_tpu.config import MapConfig
    from tests.oracle import oracle

    if get_lib() is None:
        pytest.skip("no C toolchain")
    names, seqs = random_transcriptome(
        np_rng, num_transcripts=30, min_len=150, max_len=600,
        shared_prefix_frac=0.5)
    index = build_index_from_seqs(names, seqs)
    sim = simulate_reads(np_rng, seqs, num_reads=400, read_len=100,
                         error_rate=0.02)
    # pack reads like the device path does (uint8 code rows, pad with 4)
    from seekmer_tpu import encoding as enc

    L = 100
    codes = np.full((len(sim.reads1), L), 4, np.uint8)
    for i, r in enumerate(sim.reads1):
        c = enc.seq_to_codes(r)
        codes[i, : c.size] = c

    cfg = MapConfig()
    o_sigs, o_unmapped = oracle.map_reads(sim.reads1, index, cfg)
    m = CpuBaselineMapper(index, sig_bits=12)
    mapped = m.map(codes, max_ecs=cfg.max_ecs_per_read)
    assert mapped == len(sim.reads1) - o_unmapped
    assert m.distinct_signatures == len(o_sigs)
    assert m.total_mapped == mapped
    m.close()
