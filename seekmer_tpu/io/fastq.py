"""Streaming FASTQ(.gz) reading and device-batch packing (reference: the
FASTQ reader feeding seekmer's mapper worker pool, SURVEY.md 2.1 C5/C6).

Reads are 2-bit encoded host-side and bucket-padded to a few static lengths
(multiples of MapConfig.length_bucket) so XLA compiles one mapper executable
per bucket instead of one per read length (SURVEY.md 7.5 item 5). Padding
rows (weight 0) fill the final partial batch of each bucket.
"""

from __future__ import annotations

import dataclasses
import gzip
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

from ..config import MapConfig
from ..encoding import INVALID, seq_to_codes


def _open_bytes(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_fastq(path: str) -> Iterator[bytes]:
    """Yield raw sequence lines of a FASTQ(.gz) file."""
    with _open_bytes(path) as fh:
        while True:
            header = fh.readline()
            if not header:
                return
            seq = fh.readline().strip()
            fh.readline()  # +
            fh.readline()  # quality
            if not header.startswith(b"@"):
                raise ValueError(f"malformed FASTQ record near {header[:40]!r}")
            yield seq


def read_fastq_many(paths: Iterable[str]) -> Iterator[bytes]:
    for p in paths:
        yield from read_fastq(p)


@dataclasses.dataclass
class ReadBatch:
    """One padded device batch (single- or paired-end)."""

    codes: np.ndarray  # uint8[B, L] (INVALID-padded); 2-bit-packed
    # uint8[B, (L+3)//4] when pad_len is set (encoding.pack_codes_2bit)
    lengths: np.ndarray  # int32[B]
    weights: np.ndarray  # int32[B] 1 = real read, 0 = pad row
    codes2: Optional[np.ndarray] = None  # mate 2 (paired-end)
    lengths2: Optional[np.ndarray] = None
    # 2-bit H2D packing (MapConfig.h2d_pack_2bit, set by
    # utils.prefetch.device_put_batches): invalid-base bitmasks + the
    # unpacked padded length L; pad_len is not None <=> codes are packed
    bad: Optional[np.ndarray] = None  # uint8[B, (L+7)//8]
    bad2: Optional[np.ndarray] = None
    pad_len: Optional[int] = None
    # set by utils.prefetch.device_put_batches before weights moves to the
    # device, so n_real never forces a device sync in the feed loop
    n_real_cached: Optional[int] = None
    # resume cursor valid AFTER this batch is consumed (set only by
    # CheckpointableBatchSource, at batch boundaries where stream offsets
    # and pending buffers are consistent); host-only, never device_put
    cursor: Optional[dict] = None

    @property
    def n_real(self) -> int:
        if self.n_real_cached is not None:
            return self.n_real_cached
        return int(np.asarray(self.weights).sum())

    @property
    def bucket(self) -> int:
        return self.pad_len if self.pad_len is not None \
            else self.codes.shape[1]


def pack_batch_2bit(b: ReadBatch) -> ReadBatch:
    """2-bit-pack a batch's code rows host-side (no-op if already packed).

    Cuts H2D bytes 2.67x (encoding.pack_codes_2bit); the device map step
    unpacks exactly (ops/kmer_pack.unpack_codes_2bit)."""
    if b.pad_len is not None:
        return b
    from ..encoding import pack_codes_2bit

    L = b.codes.shape[1]
    codes, bad = pack_codes_2bit(b.codes)
    codes2 = bad2 = None
    if b.codes2 is not None:
        codes2, bad2 = pack_codes_2bit(b.codes2)
    return dataclasses.replace(b, codes=codes, bad=bad, codes2=codes2,
                               bad2=bad2, pad_len=L)


def _bucket_of(length: int, cfg: MapConfig) -> int:
    length = min(max(length, 1), cfg.max_read_len)
    b = cfg.length_bucket
    return ((length + b - 1) // b) * b


def _pack(seqs: list[bytes], L: int, B: int) -> Tuple[np.ndarray, np.ndarray]:
    codes = np.full((B, L), INVALID, dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    for i, s in enumerate(seqs):
        c = seq_to_codes(s[:L])
        codes[i, : c.size] = c
        lengths[i] = c.size
    return codes, lengths


def batch_reads(
    seqs: Iterable[bytes], cfg: MapConfig
) -> Iterator[ReadBatch]:
    """Group single-end reads into fixed-shape batches per length bucket."""
    pending: dict[int, list[bytes]] = {}
    B = cfg.batch_size
    for seq in seqs:
        bucket = _bucket_of(len(seq), cfg)
        lst = pending.setdefault(bucket, [])
        lst.append(seq)
        if len(lst) == B:
            codes, lengths = _pack(lst, bucket, B)
            yield ReadBatch(codes, lengths, np.ones(B, np.int32))
            pending[bucket] = []
    for bucket, lst in pending.items():
        if not lst:
            continue
        codes, lengths = _pack(lst, bucket, B)
        w = np.zeros(B, np.int32)
        w[: len(lst)] = 1
        yield ReadBatch(codes, lengths, w)


def batch_read_pairs(
    pairs: Iterable[Tuple[bytes, bytes]], cfg: MapConfig
) -> Iterator[ReadBatch]:
    """Paired-end batching; both mates padded to the pair's max bucket."""
    pending: dict[int, list[Tuple[bytes, bytes]]] = {}
    B = cfg.batch_size
    for r1, r2 in pairs:
        bucket = _bucket_of(max(len(r1), len(r2)), cfg)
        lst = pending.setdefault(bucket, [])
        lst.append((r1, r2))
        if len(lst) == B:
            yield _pack_pairs(lst, bucket, B, np.ones(B, np.int32))
            pending[bucket] = []
    for bucket, lst in pending.items():
        if not lst:
            continue
        w = np.zeros(B, np.int32)
        w[: len(lst)] = 1
        yield _pack_pairs(lst, bucket, B, w)


def _pack_pairs(lst, bucket: int, B: int, w: np.ndarray) -> ReadBatch:
    codes1, len1 = _pack([a for a, _ in lst], bucket, B)
    codes2, len2 = _pack([b for _, b in lst], bucket, B)
    return ReadBatch(codes1, len1, w, codes2=codes2, lengths2=len2)


class _BucketAccumulator:
    """Groups pre-packed code rows into fixed-shape per-bucket batches."""

    def __init__(self, cfg: MapConfig):
        self.cfg = cfg
        self.pending: dict[int, tuple[np.ndarray, np.ndarray, int]] = {}

    def _bucket_ids(self, lengths: np.ndarray) -> np.ndarray:
        b = self.cfg.length_bucket
        return np.minimum(
            (np.maximum(lengths, 1) + b - 1) // b * b, self.cfg.max_read_len
        )

    def add(self, codes: np.ndarray, lengths: np.ndarray):
        """Yields full ReadBatch objects as buckets fill."""
        B = self.cfg.batch_size
        for bucket in np.unique(self._bucket_ids(lengths)):
            sel = self._bucket_ids(lengths) == bucket
            rows = codes[sel, :bucket]
            ls = np.minimum(lengths[sel], bucket).astype(np.int32)
            buf, lbuf, fill = self.pending.get(bucket) or (
                np.full((B, bucket), INVALID, np.uint8),
                np.zeros(B, np.int32), 0)
            i = 0
            while i < rows.shape[0]:
                take = min(B - fill, rows.shape[0] - i)
                buf[fill : fill + take] = rows[i : i + take]
                lbuf[fill : fill + take] = ls[i : i + take]
                fill += take
                i += take
                if fill == B:
                    yield ReadBatch(buf, lbuf, np.ones(B, np.int32))
                    buf = np.full((B, bucket), INVALID, np.uint8)
                    lbuf = np.zeros(B, np.int32)
                    fill = 0
            self.pending[bucket] = (buf, lbuf, fill)

    def flush(self):
        B = self.cfg.batch_size
        for bucket, (buf, lbuf, fill) in self.pending.items():
            if fill:
                w = np.zeros(B, np.int32)
                w[:fill] = 1
                yield ReadBatch(buf, lbuf, w)
        self.pending = {}


_DONE = object()


def _parallel_chunks(make_streams, workers: int, queue_depth: int = 8):
    """Run the chunk-iterators over at most ``workers`` threads; yield
    items as they arrive. Order is preserved WITHIN each stream, arbitrary
    across streams. gzip inflate and the ctypes packer both release the
    GIL, so multi-file decode scales to ~min(workers, n_files) (SURVEY.md
    7.5 item 4: host ingest must keep the chips fed — gzip decode is
    ~0.4M reads/s single-threaded vs a >1M reads/s device map rate).

    Each worker drains one stream fully before taking the next (a stream
    is never touched by two threads). If the consumer abandons the
    generator or a stream raises, a cancel flag unblocks producers stuck
    on the bounded queue and every stream generator is closed
    deterministically (its ``finally`` releases file handles / C reader
    state) — without it, aborted ingests leaked blocked daemon threads.
    """
    import contextlib
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
    cancel = threading.Event()
    pending = list(enumerate(make_streams))
    lock = threading.Lock()
    n_streams = len(pending)

    def put(item) -> bool:
        while True:
            try:
                q.put(item, timeout=0.25)
                return True
            except queue.Full:
                if cancel.is_set():
                    return False

    def worker():
        while not cancel.is_set():
            with lock:
                if not pending:
                    return
                _, make = pending.pop(0)
            try:
                stream = make()
                with contextlib.closing(stream):
                    for item in stream:
                        # check BEFORE the put: a producer whose queue
                        # slot is free would otherwise keep decoding a
                        # whole further chunk per free slot after the
                        # consumer cancelled
                        if cancel.is_set() or not put(item):
                            return
                if not put(_DONE):
                    return
            except BaseException as e:  # surface in the consumer
                put(e)
                return

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(1, min(workers, n_streams)))]
    for t in threads:
        t.start()
    done = 0
    try:
        while done < n_streams:
            item = q.get()
            if item is _DONE:
                done += 1
                continue
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        cancel.set()
        # drain until every producer has exited (one drain pass can refill
        # from producers already past their cancel check)
        import time as _time

        while any(t.is_alive() for t in threads):
            try:
                q.get_nowait()
            except queue.Empty:
                _time.sleep(0.01)


def _effective_io_workers(cfg: MapConfig, n_streams: int) -> int:
    w = cfg.io_workers if cfg.io_workers > 0 else 4
    return min(w, n_streams)


def _bucketer_batches(chunk_iter, cfg: MapConfig, paired: bool
                      ) -> Iterator[ReadBatch]:
    """Drain decoded chunks through the C bucketer (native.packer.Bucketer):
    bucket placement runs in GIL-released C, removing the numpy bucket-copy
    that capped the full ingest pipeline at ~1.3M reads/s against a 3.5M
    reads/s raw decode (benchmarks/micro_ingest.py, earlier build host)."""
    from ..native.packer import Bucketer

    B = cfg.batch_size
    bk = Bucketer(B, cfg.max_read_len, cfg.length_bucket, paired)
    try:
        for chunk in chunk_iter:
            if paired:
                c1, l1, c2, l2 = chunk
            else:
                (c1, l1), c2, l2 = chunk, None, None
            if bk.feed(c1, l1, c2, l2):
                for c1b, l1b, c2b, l2b, _ in bk.pop_ready():
                    yield ReadBatch(c1b, l1b, np.ones(B, np.int32),
                                    codes2=c2b, lengths2=l2b)
        for c1b, l1b, c2b, l2b, fill in bk.flush():
            w = np.zeros(B, np.int32)
            w[:fill] = 1
            yield ReadBatch(c1b, l1b, w, codes2=c2b, lengths2=l2b)
    finally:
        bk.close()


def batch_reads_native(
    paths, cfg: MapConfig
) -> Iterator[ReadBatch]:
    """Single-end batching through the C packer (falls back to Python).

    Decode AND bucket placement both run inside GIL-released C calls. With
    multiple input files and cfg.io_workers != 1, files are decoded
    concurrently (read order interleaves across files; counts are
    order-independent). Callers needing a deterministic stream order
    (checkpoint resume) use CheckpointableBatchSource instead."""
    from ..native.packer import get_lib, stream_packed

    if get_lib() is None:
        yield from batch_reads(read_fastq_many(paths), cfg)
        return
    paths = list(paths)
    workers = _effective_io_workers(cfg, len(paths))
    if workers > 1:
        makers = [
            (lambda p=p: stream_packed(p, cfg.max_read_len)) for p in paths
        ]
        chunk_iter = _parallel_chunks(makers, workers)
    else:
        def serial():
            for path in paths:
                yield from stream_packed(path, cfg.max_read_len)

        chunk_iter = serial()
    yield from _bucketer_batches(chunk_iter, cfg, paired=False)


def _aligned_chunks(stream1, stream2):
    """Zip two (codes, lengths) block streams into row-aligned sub-blocks."""
    buf1 = buf2 = None
    pos1 = pos2 = 0
    while True:
        if buf1 is None or pos1 == buf1[0].shape[0]:
            buf1, pos1 = next(stream1, None), 0
        if buf2 is None or pos2 == buf2[0].shape[0]:
            buf2, pos2 = next(stream2, None), 0
        if buf1 is None or buf2 is None:
            if (buf1 is None) != (buf2 is None):
                raise ValueError("paired FASTQ files have unequal read counts")
            return
        n = min(buf1[0].shape[0] - pos1, buf2[0].shape[0] - pos2)
        yield (buf1[0][pos1 : pos1 + n], buf1[1][pos1 : pos1 + n],
               buf2[0][pos2 : pos2 + n], buf2[1][pos2 : pos2 + n])
        pos1 += n
        pos2 += n


def batch_read_pairs_native(
    paths1, paths2, cfg: MapConfig
) -> Iterator[ReadBatch]:
    """Paired-end batching through the C packer; mates bucket together by
    the pair's max length. Falls back to the Python path."""
    from ..native.packer import get_lib, stream_packed

    if get_lib() is None:
        pairs = zip(read_fastq_many(paths1), read_fastq_many(paths2))
        yield from batch_read_pairs(pairs, cfg)
        return

    def stream(paths):
        for p in paths:
            yield from stream_packed(p, cfg.max_read_len)

    paths1, paths2 = list(paths1), list(paths2)
    # Paired parallel decode is OPT-IN (io_workers explicitly > 1), never
    # auto: it pairs files index-by-index, which errors on the legal (if
    # exotic) layout where R1/R2 totals match but per-file counts differ —
    # the serial default aligns the two CHAINED streams and handles it.
    parallel_ok = (cfg.io_workers > 1 and len(paths1) == len(paths2)
                   and len(paths1) > 1)
    if cfg.io_workers > 1 and not parallel_ok:
        import logging

        logging.getLogger(__name__).info(
            "paired decode falling back to serial despite io_workers=%d: "
            "parallel mode needs > 1 mate-file pair matched index-by-index "
            "(got %d R1 / %d R2 files)",
            cfg.io_workers, len(paths1), len(paths2))
    if parallel_ok:
        def pair_stream(p1, p2):
            try:
                yield from _aligned_chunks(
                    stream_packed(p1, cfg.max_read_len),
                    stream_packed(p2, cfg.max_read_len))
            except ValueError as e:
                raise ValueError(
                    f"{e} ({p1} / {p2}): with --io-workers > 1, mate files "
                    "must pair index-by-index; re-run with --io-workers 1 "
                    "to align the concatenated streams instead") from e

        makers = [
            (lambda a=p1, b=p2: pair_stream(a, b))
            for p1, p2 in zip(paths1, paths2)
        ]
        chunk_iter = _parallel_chunks(makers, min(cfg.io_workers,
                                                  len(paths1)))
    else:
        chunk_iter = _aligned_chunks(stream(paths1), stream(paths2))

    yield from _bucketer_batches(chunk_iter, cfg, paired=True)


# ---- checkpointable (offset-cursor) batching -------------------------------


class _PyOffsetFileStream:
    """Pure-Python fallback for native.packer.PackedFileStream: same
    next_chunk/tell contract over uncompressed byte offsets (gzip.GzipFile
    tell/seek operate in uncompressed coordinates)."""

    def __init__(self, path: str, max_len: int, start_offset: int = 0):
        self.path = path
        self.max_len = max_len
        self._fh = _open_bytes(path)
        if start_offset:
            self._fh.seek(start_offset)

    def next_chunk(self, max_reads: int):
        rows: list[bytes] = []
        for _ in range(max_reads):
            header = self._fh.readline()
            if not header:
                break
            seq = self._fh.readline().strip()
            self._fh.readline()  # +
            self._fh.readline()  # quality
            if not header.startswith(b"@"):
                raise ValueError(
                    f"malformed FASTQ record near {header[:40]!r}")
            rows.append(seq)
        if not rows:
            return None
        codes, lengths = _pack(rows, self.max_len, len(rows))
        return codes, lengths

    def tell(self) -> int:
        return self._fh.tell()

    def close(self) -> None:
        self._fh.close()


class _OffsetStream:
    """Chained multi-file FASTQ stream with an exact (file_idx, offset)
    cursor; offset = uncompressed byte position of the next unparsed
    record. Resume reopens there: plain files seek (no re-read), .gz
    skips via one in-C decompress-discard (native.packer.seekmer_open_at)."""

    def __init__(self, paths, max_len: int, file_idx: int = 0,
                 offset: int = 0):
        self.paths = list(paths)
        self.max_len = max_len
        self.file_idx = file_idx
        self.offset = offset
        self._cur = None

    def _open(self):
        from ..native.packer import PackedFileStream, get_lib

        cls = PackedFileStream if get_lib() is not None else _PyOffsetFileStream
        return cls(self.paths[self.file_idx], self.max_len,
                   start_offset=self.offset)

    def read_n(self, n: int):
        """Up to ``n`` reads (fewer only at end of ALL files), advancing
        the cursor; None when exhausted."""
        out_c, out_l = [], []
        got = 0
        while got < n and self.file_idx < len(self.paths):
            if self._cur is None:
                self._cur = self._open()
            chunk = self._cur.next_chunk(n - got)
            if chunk is None:
                self._cur.close()
                self._cur = None
                self.file_idx += 1
                self.offset = 0
                continue
            self.offset = self._cur.tell()
            out_c.append(chunk[0])
            out_l.append(chunk[1])
            got += chunk[0].shape[0]
        if not out_c:
            return None
        if len(out_c) == 1:
            return out_c[0], out_l[0]
        return np.concatenate(out_c), np.concatenate(out_l)

    def cursor(self):
        return [self.file_idx, self.offset]

    def close(self) -> None:
        if self._cur is not None:
            self._cur.close()
            self._cur = None


class CheckpointableBatchSource:
    """Serial FASTQ batching with an exact resume cursor (SURVEY.md 5.3).

    The cursor is per-stream (file index, uncompressed byte offset of the
    next unparsed record) PLUS the partial per-bucket batch buffers, so a
    checkpoint taken at a batch boundary resumes without re-reading or
    re-batching consumed input — the reads the bucketing layer was holding
    ride along in the checkpoint (utils/checkpoint serializes them).

    Cursors are attached to the LAST batch produced from each decoded
    chunk (ReadBatch.cursor) — the points where stream offsets and pending
    buffers are mutually consistent; Mapper.run checkpoints at the next
    cursor-bearing batch after each checkpoint_every interval.

    Round 1 resumed by re-decoding and itertools.islice-skipping the whole
    consumed stream (VERDICT item 7); this replaces that entirely.
    """

    CHUNK = 16384

    def __init__(self, paths, mate_paths=None, cfg: MapConfig = MapConfig()):
        self.paths = list(paths)
        self.mates = list(mate_paths) if mate_paths else None
        self.cfg = cfg
        self._restore_state: Optional[dict] = None

    def restore(self, state: dict) -> None:
        if state.get("v") == "pack1":
            raise ValueError(
                "checkpoint was taken on a --pack-cache run (its cursor "
                "indexes cached batches, not file offsets); resume with "
                "--pack-cache, or delete the checkpoint to start fresh")
        if state.get("paired", False) != (self.mates is not None):
            raise ValueError("checkpoint cursor pairing does not match "
                             "the current input files")
        self._restore_state = state

    def _snapshot(self, s1, s2, pending) -> dict:
        pend = {}
        for bucket, st in pending.items():
            fill = st[4]
            if not fill:
                continue
            d = {"c1": st[0][:fill].copy(), "l1": st[1][:fill].copy()}
            if st[2] is not None:
                d["c2"] = st[2][:fill].copy()
                d["l2"] = st[3][:fill].copy()
            pend[int(bucket)] = d
        return {
            "v": 1,
            "paired": self.mates is not None,
            "s1": s1.cursor(),
            "s2": s2.cursor() if s2 is not None else None,
            "pending": pend,
        }

    def __iter__(self) -> Iterator[ReadBatch]:
        from ..native.packer import get_lib

        if get_lib() is not None:
            yield from self._iter_native()
        else:
            yield from self._iter_py()

    def _open_streams(self):
        cfg = self.cfg
        st0 = self._restore_state or {}
        f1, o1 = st0.get("s1") or (0, 0)
        s1 = _OffsetStream(self.paths, cfg.max_read_len, f1, o1)
        s2 = None
        if self.mates is not None:
            f2, o2 = st0.get("s2") or (0, 0)
            s2 = _OffsetStream(self.mates, cfg.max_read_len, f2, o2)
        return st0, s1, s2

    def _snapshot_native(self, s1, s2, bk) -> dict:
        return {
            "v": 1,
            "paired": self.mates is not None,
            "s1": s1.cursor(),
            "s2": s2.cursor() if s2 is not None else None,
            "pending": bk.pending_state(),
        }

    def _iter_native(self) -> Iterator[ReadBatch]:
        """C decode + C bucket placement with the same cursor contract as
        the Python path: every ctypes call releases the GIL, so the
        checkpointable (serial) production path runs at the decoder's
        rate instead of the numpy bucket-copy's (benchmarks/micro_ingest.py)."""
        from ..native.packer import Bucketer

        cfg = self.cfg
        B = cfg.batch_size
        st0, s1, s2 = self._open_streams()
        paired = s2 is not None
        bk = Bucketer(B, cfg.max_read_len, cfg.length_bucket, paired)
        try:
            if st0.get("pending"):
                bk.restore_pending(
                    {int(k): v for k, v in st0["pending"].items()})
            while True:
                ch1 = s1.read_n(self.CHUNK)
                if ch1 is None:
                    if s2 is not None and s2.read_n(1) is not None:
                        raise ValueError(
                            "paired FASTQ files have unequal read counts")
                    break
                c1, l1 = ch1
                c2 = l2 = None
                if paired:
                    ch2 = s2.read_n(c1.shape[0])
                    if ch2 is None or ch2[0].shape[0] != c1.shape[0]:
                        raise ValueError(
                            "paired FASTQ files have unequal read counts")
                    c2, l2 = ch2
                bk.feed(c1, l1, c2, l2)
                out = [
                    ReadBatch(a, b, np.ones(B, np.int32),
                              codes2=cc, lengths2=dd)
                    for a, b, cc, dd, _ in bk.pop_ready()
                ]
                for batch in out[:-1]:
                    yield batch
                if out:
                    out[-1].cursor = self._snapshot_native(s1, s2, bk)
                    yield out[-1]
            # flush partial buckets; as in the Python path, each flushed
            # batch's cursor excludes buckets already flushed
            for a, b, cc, dd, fill in bk.flush():
                w = np.zeros(B, np.int32)
                w[:fill] = 1
                batch = ReadBatch(a, b, w, codes2=cc, lengths2=dd)
                batch.cursor = self._snapshot_native(s1, s2, bk)
                yield batch
        finally:
            bk.close()
            s1.close()
            if s2 is not None:
                s2.close()

    def _iter_py(self) -> Iterator[ReadBatch]:
        cfg = self.cfg
        B, lb = cfg.batch_size, cfg.length_bucket
        st0 = self._restore_state or {}
        f1, o1 = st0.get("s1") or (0, 0)
        s1 = _OffsetStream(self.paths, cfg.max_read_len, f1, o1)
        s2 = None
        if self.mates is not None:
            f2, o2 = st0.get("s2") or (0, 0)
            s2 = _OffsetStream(self.mates, cfg.max_read_len, f2, o2)
        paired = s2 is not None

        def new_bufs(bucket):
            return [np.full((B, bucket), INVALID, np.uint8),
                    np.zeros(B, np.int32),
                    np.full((B, bucket), INVALID, np.uint8) if paired else None,
                    np.zeros(B, np.int32) if paired else None,
                    0]

        pending: dict[int, list] = {}
        for bucket, d in (st0.get("pending") or {}).items():
            bucket = int(bucket)
            st = new_bufs(bucket)
            fill = d["c1"].shape[0]
            st[0][:fill] = d["c1"][:, :bucket]
            st[1][:fill] = d["l1"]
            if paired:
                st[2][:fill] = d["c2"][:, :bucket]
                st[3][:fill] = d["l2"]
            st[4] = fill
            pending[bucket] = st

        def fill_pending(c1, l1, c2, l2):
            """Distribute one decoded chunk into pending; yield full
            batches."""
            eff = np.maximum(l1, l2) if paired else l1
            bucket_ids = np.minimum(
                (np.maximum(eff, 1) + lb - 1) // lb * lb, cfg.max_read_len)
            for bucket in np.unique(bucket_ids):
                sel = bucket_ids == bucket
                r1 = c1[sel, :bucket]
                s1_ = np.minimum(l1[sel], bucket).astype(np.int32)
                if paired:
                    r2 = c2[sel, :bucket]
                    s2_ = np.minimum(l2[sel], bucket).astype(np.int32)
                st = pending.get(bucket)
                if st is None:
                    st = pending[bucket] = new_bufs(int(bucket))
                i = 0
                while i < r1.shape[0]:
                    take = min(B - st[4], r1.shape[0] - i)
                    f = st[4]
                    st[0][f : f + take] = r1[i : i + take]
                    st[1][f : f + take] = s1_[i : i + take]
                    if paired:
                        st[2][f : f + take] = r2[i : i + take]
                        st[3][f : f + take] = s2_[i : i + take]
                    st[4] += take
                    i += take
                    if st[4] == B:
                        yield ReadBatch(
                            st[0], st[1], np.ones(B, np.int32),
                            codes2=st[2], lengths2=st[3])
                        pending[bucket] = st = new_bufs(int(bucket))

        while True:
            ch1 = s1.read_n(self.CHUNK)
            if ch1 is None:
                if s2 is not None and s2.read_n(1) is not None:
                    raise ValueError(
                        "paired FASTQ files have unequal read counts")
                break
            c1, l1 = ch1
            c2 = l2 = None
            if paired:
                ch2 = s2.read_n(c1.shape[0])
                if ch2 is None or ch2[0].shape[0] != c1.shape[0]:
                    raise ValueError(
                        "paired FASTQ files have unequal read counts")
                c2, l2 = ch2
            out = list(fill_pending(c1, l1, c2, l2))
            for b in out[:-1]:
                yield b
            if out:
                out[-1].cursor = self._snapshot(s1, s2, pending)
                yield out[-1]

        # flush partial buckets; each flush batch's cursor drops the
        # buckets already flushed (resume after the final batch re-reads
        # nothing and re-feeds nothing)
        for bucket in sorted(pending):
            st = pending.pop(bucket)
            if not st[4]:
                continue
            w = np.zeros(B, np.int32)
            w[: st[4]] = 1
            batch = ReadBatch(st[0], st[1], w, codes2=st[2], lengths2=st[3])
            batch.cursor = self._snapshot(s1, s2, pending)
            yield batch
        s1.close()
        if s2 is not None:
            s2.close()
