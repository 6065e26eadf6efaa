"""ctypes loader + streaming driver for the native FASTQ packer.

Builds libseekmer_packer.so from packer.c on first use (plain `cc`, no
pybind11 — SURVEY.md 2.1 note: C++/C via ctypes is the sanctioned native
path in this environment). Falls back to the pure-Python packer in
io/fastq.py when no compiler is available.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Iterator, Optional

import numpy as np

log = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "packer.c")
_SO = os.path.join(_HERE, "libseekmer_packer.so")

_lib = None
_tried = False


def _build() -> Optional[str]:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    for cc in ("cc", "gcc", "clang"):
        try:
            subprocess.run(
                [cc, "-O3", "-shared", "-fPIC", "-pthread", _SRC, "-lz",
                 "-o", _SO],
                check=True, capture_output=True, timeout=60,
            )
            return _SO
        except (FileNotFoundError, subprocess.CalledProcessError,
                subprocess.TimeoutExpired) as e:
            log.debug("native packer build with %s failed: %s", cc, e)
    return None


def get_lib():
    """The loaded shared library, or None if unavailable."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    so = _build()
    if so is None:
        log.warning("native packer unavailable; using Python FASTQ packing")
        return None
    lib = ctypes.CDLL(so)
    lib.seekmer_pack_fastq.restype = ctypes.c_long
    lib.seekmer_pack_fastq.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.seekmer_open.restype = ctypes.c_void_p
    lib.seekmer_open.argtypes = [ctypes.c_char_p]
    lib.seekmer_next.restype = ctypes.c_long
    lib.seekmer_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_long, ctypes.c_long,
    ]
    lib.seekmer_close.restype = None
    lib.seekmer_close.argtypes = [ctypes.c_void_p]
    lib.seekmer_tell.restype = ctypes.c_long
    lib.seekmer_tell.argtypes = [ctypes.c_void_p]
    lib.seekmer_open_at.restype = ctypes.c_void_p
    lib.seekmer_open_at.argtypes = [ctypes.c_char_p, ctypes.c_long]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.seekmer_bucketer_new.restype = ctypes.c_void_p
    lib.seekmer_bucketer_new.argtypes = [
        ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_int]
    lib.seekmer_bucketer_free.restype = None
    lib.seekmer_bucketer_free.argtypes = [ctypes.c_void_p]
    lib.seekmer_bucketer_feed.restype = ctypes.c_long
    lib.seekmer_bucketer_feed.argtypes = [
        ctypes.c_void_p, u8p, i32p, u8p, i32p, ctypes.c_long]
    lib.seekmer_bucketer_ready_width.restype = ctypes.c_long
    lib.seekmer_bucketer_ready_width.argtypes = [ctypes.c_void_p]
    lib.seekmer_bucketer_pop.restype = ctypes.c_long
    lib.seekmer_bucketer_pop.argtypes = [ctypes.c_void_p, u8p, i32p, u8p, i32p]
    lib.seekmer_bucketer_flush_one.restype = ctypes.c_long
    lib.seekmer_bucketer_flush_one.argtypes = [ctypes.c_void_p]
    lib.seekmer_bucketer_pending.restype = ctypes.c_long
    lib.seekmer_bucketer_pending.argtypes = [
        ctypes.c_void_p, ctypes.c_long, u8p, i32p, u8p, i32p]
    lib.seekmer_bucketer_nb.restype = ctypes.c_long
    lib.seekmer_bucketer_nb.argtypes = [ctypes.c_void_p]
    lib.seekmer_pack2bit.restype = None
    lib.seekmer_pack2bit.argtypes = [
        u8p, ctypes.c_long, ctypes.c_long, u8p, u8p]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.seekmer_sort_pairs.restype = ctypes.c_long
    lib.seekmer_sort_pairs.argtypes = [
        u64p, i32p, ctypes.c_long, u64p, i32p, i64p, ctypes.c_int]
    _lib = lib
    return _lib


def _require_lib():
    lib = get_lib()
    if lib is None:
        raise RuntimeError(
            "native FASTQ packer unavailable (no working C toolchain); "
            "use the pure-Python reader path (io/fastq.batch_reads)")
    return lib


def pack_chunk(buf: bytes, max_reads: int, max_len: int):
    """Parse complete FASTQ records from ``buf``.

    Returns (codes uint8[n, max_len], lengths int32[n], consumed_bytes).
    Raises ValueError on malformed input.
    """
    lib = _require_lib()
    codes = np.empty((max_reads, max_len), dtype=np.uint8)
    lengths = np.empty(max_reads, dtype=np.int32)
    consumed = ctypes.c_long(0)
    n = lib.seekmer_pack_fastq(
        buf, len(buf),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_reads, max_len, ctypes.byref(consumed),
    )
    if n < 0:
        raise ValueError("malformed FASTQ input")
    return codes[:n], lengths[:n], consumed.value


def stream_packed(path: str, max_len: int, chunk_reads: int = 16384
                  ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Stream a FASTQ(.gz) file as (codes[n, max_len], lengths[n]) chunks.

    Uses the C streaming reader: file read + gzip inflate + parse + pack
    happen inside ONE ctypes call per chunk, with the GIL released — this
    is what makes io_workers-threaded multi-file ingest scale (the Python
    gzip.read loop's per-chunk glue capped 4-thread decode at ~1.3x)."""
    with PackedFileStream(path, max_len) as s:
        while True:
            chunk = s.next_chunk(chunk_reads)
            if chunk is None:
                return
            yield chunk


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def sort_pairs_native(keys: np.ndarray, tids: np.ndarray,
                      want_rank: bool = False, nthreads: int = 0):
    """Stable sort of (key, tid) pairs by key via the threaded C radix
    core — the index builder's hot loop #1 (SURVEY.md 3.1). Returns
    (sorted_keys, sorted_tids, key_rank_or_None) — byte-identical to
    np.argsort(keys, kind='stable') + gathers (+ the rank scatter) —
    or None when the library is unavailable or allocation fails."""
    lib = get_lib()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, np.uint64)
    tids = np.ascontiguousarray(tids, np.int32)
    n = keys.size
    if nthreads <= 0:
        # core count: an isolated 62M-pair micro favored 2x
        # oversubscription (7.1 s vs 11.4 s — the scatter is
        # latency-bound), but inside the full index build — where numpy
        # passes compete for the same cores — the alternating A/B read
        # nt=2 91.5 s vs nt=4 96.1 s total build, so core count wins
        nthreads = min(os.cpu_count() or 1, 8)
    keys_out = np.empty(n, np.uint64)
    tids_out = np.empty(n, np.int32)
    rank = np.empty(n, np.int64) if want_rank else None
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    got = lib.seekmer_sort_pairs(
        keys.ctypes.data_as(u64p), _i32p(tids), n,
        keys_out.ctypes.data_as(u64p), _i32p(tids_out),
        rank.ctypes.data_as(i64p) if want_rank else None, nthreads)
    if got < 0:
        return None
    return keys_out, tids_out, rank


def pack_codes_2bit_native(codes: np.ndarray):
    """C form of encoding.pack_codes_2bit (identical layout); returns
    (packed uint8[n, (L+3)//4], bad uint8[n, (L+7)//8]) or None when the
    library is unavailable. One GIL-released call per batch."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n, L = codes.shape
    out = np.empty((n, (L + 3) // 4), np.uint8)
    bad = np.empty((n, (L + 7) // 8), np.uint8)
    lib.seekmer_pack2bit(_u8p(codes), n, L, _u8p(out), _u8p(bad))
    return out, bad


class Bucketer:
    """C-side bucket placement: feed decoded (codes, lengths) chunks, pop
    fixed-shape (B, W) batches as buckets fill — the consumer half of the
    ingest pipeline, GIL-released end-to-end (the numpy bucket-copy was the
    measured ~1.3M reads/s pipeline ceiling; benchmarks/micro_ingest.py).
    Matches io/fastq._BucketAccumulator semantics exactly,
    including checkpoint pending-buffer export (``pending_state``)."""

    def __init__(self, batch_size: int, max_len: int, length_bucket: int,
                 paired: bool):
        self._lib = _require_lib()
        self.B = batch_size
        self.max_len = max_len
        self.lb = length_bucket
        self.paired = paired
        self._h = self._lib.seekmer_bucketer_new(
            batch_size, max_len, length_bucket, 1 if paired else 0)
        if not self._h:
            raise MemoryError("bucketer allocation failed")

    def feed(self, c1, l1, c2=None, l2=None) -> int:
        """Add decoded rows (width max_len); returns ready batch count."""
        c1 = np.ascontiguousarray(c1, np.uint8)
        l1 = np.ascontiguousarray(l1, np.int32)
        if self.paired:
            c2 = np.ascontiguousarray(c2, np.uint8)
            l2 = np.ascontiguousarray(l2, np.int32)
        n = self._lib.seekmer_bucketer_feed(
            self._h, _u8p(c1), _i32p(l1),
            _u8p(c2) if self.paired else None,
            _i32p(l2) if self.paired else None, c1.shape[0])
        if n < 0:
            raise MemoryError("bucketer feed failed")
        return n

    def _pop_one(self):
        w = self._lib.seekmer_bucketer_ready_width(self._h)
        if w == 0:
            return None
        c1 = np.empty((self.B, w), np.uint8)
        l1 = np.empty(self.B, np.int32)
        c2 = np.empty((self.B, w), np.uint8) if self.paired else None
        l2 = np.empty(self.B, np.int32) if self.paired else None
        fill = self._lib.seekmer_bucketer_pop(
            self._h, _u8p(c1), _i32p(l1),
            _u8p(c2) if self.paired else None,
            _i32p(l2) if self.paired else None)
        return c1, l1, c2, l2, int(fill)

    def pop_ready(self):
        """Yield (c1, l1, c2, l2, n_real) for every ready batch."""
        while True:
            item = self._pop_one()
            if item is None:
                return
            yield item

    def flush(self):
        """Promote and yield every pending partial bucket (ascending W)."""
        while True:
            fill = self._lib.seekmer_bucketer_flush_one(self._h)
            if fill < 0:
                raise MemoryError("bucketer flush failed")
            if fill == 0:
                return
            item = self._pop_one()
            assert item is not None and item[4] == fill
            yield item

    def pending_state(self) -> dict:
        """Checkpoint snapshot: {bucket_width: {"c1", "l1"[, "c2", "l2"]}}
        of pending (not yet full) rows — same shape contract as
        io/fastq.CheckpointableBatchSource._snapshot."""
        out = {}
        nb = self._lib.seekmer_bucketer_nb(self._h)
        for idx in range(nb):
            fill = self._lib.seekmer_bucketer_pending(
                self._h, idx, None, None, None, None)
            if fill == 0:
                continue
            w = min((idx + 1) * self.lb, self.max_len)
            c1 = np.empty((fill, w), np.uint8)
            l1 = np.empty(fill, np.int32)
            c2 = np.empty((fill, w), np.uint8) if self.paired else None
            l2 = np.empty(fill, np.int32) if self.paired else None
            self._lib.seekmer_bucketer_pending(
                self._h, idx, _u8p(c1), _i32p(l1),
                _u8p(c2) if self.paired else None,
                _i32p(l2) if self.paired else None)
            d = {"c1": c1, "l1": l1}
            if self.paired:
                d["c2"] = c2
                d["l2"] = l2
            out[int(w)] = d
        return out

    def restore_pending(self, pending: dict) -> None:
        """Re-feed snapshot rows (bucketing is deterministic by length, so
        each row lands back in its original bucket in order)."""
        for _, d in sorted(pending.items()):
            c1 = np.asarray(d["c1"], np.uint8)
            fill, w = c1.shape
            wide1 = np.full((fill, self.max_len), 4, np.uint8)
            wide1[:, :w] = c1
            wide2 = None
            if self.paired:
                c2 = np.asarray(d["c2"], np.uint8)
                wide2 = np.full((fill, self.max_len), 4, np.uint8)
                wide2[:, :w] = c2
            if self.feed(wide1, np.asarray(d["l1"], np.int32), wide2,
                         None if not self.paired
                         else np.asarray(d["l2"], np.int32)):
                raise ValueError("restored pending rows filled a batch — "
                                 "snapshot cannot contain full buckets")

    def close(self) -> None:
        if self._h:
            self._lib.seekmer_bucketer_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PackedFileStream:
    """The C streaming reader as an object: ``next_chunk`` + ``tell``.

    ``tell()`` is the UNCOMPRESSED byte offset of the next unparsed
    record; ``start_offset`` reopens there (plain files: one lseek, no
    re-read; .gz: zlib decompress-and-discard inside one C call) — the
    checkpoint/resume cursor (utils/checkpoint, SURVEY.md 5.3).
    """

    def __init__(self, path: str, max_len: int, start_offset: int = 0):
        self._lib = _require_lib()
        self.path = path
        self.max_len = max_len
        if start_offset:
            self._h = self._lib.seekmer_open_at(os.fsencode(path),
                                                start_offset)
        else:
            self._h = self._lib.seekmer_open(os.fsencode(path))
        if not self._h:
            raise OSError(f"cannot open FASTQ file at offset "
                          f"{start_offset}: {path}")

    def next_chunk(self, max_reads: int):
        """(codes uint8[n, max_len], lengths int32[n]) or None at EOF."""
        codes = np.empty((max_reads, self.max_len), dtype=np.uint8)
        lengths = np.empty(max_reads, dtype=np.int32)
        n = self._lib.seekmer_next(
            self._h,
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            max_reads, self.max_len,
        )
        if n == 0:
            return None
        if n == -1:
            raise ValueError(f"malformed FASTQ input in {self.path}")
        if n < 0:
            raise OSError(f"I/O error reading {self.path}")
        return codes[:n], lengths[:n]

    def tell(self) -> int:
        return int(self._lib.seekmer_tell(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.seekmer_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
