"""Host ingest pipeline throughput: raw C decode vs full bucketed batching.

Round-5 verdict item 2: the full pipeline was capped at ~1.3M reads/s by
the consumer-side numpy bucket-copy (single GIL thread) while the threaded
C decode fed 1.7-3.5M reads/s. The C bucketer (native/packer.c
seekmer_bucketer_*) moves that copy into GIL-released C; this micro
measures the pipeline before/after on the same files, same process.

Arms (all over the same generated .gz dataset in .bench_cache/ingest):
  raw           C decode only, chunks discarded (the ceiling)
  numpy-bucket  decode -> io/fastq._BucketAccumulator (the old pipeline)
  c-bucket      decode -> native Bucketer (the new pipeline)
  ckpt          CheckpointableBatchSource (serial, cursor-bearing path)
paired variants use two mate file sets through batch_read_pairs_native.

CPU-only; concurrent load on the host skews everything, so run it alone.

Usage: python benchmarks/micro_ingest.py [--reads N] [--files F] [--paired]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np

log = lambda *a: print(*a, file=sys.stderr, flush=True)

CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".bench_cache", "ingest")


def dataset(n_reads: int, n_files: int, read_len: int, paired: bool,
            plain: bool = False):
    """Simulated reads written as (gzipped) FASTQ, cached across runs."""
    from seekmer_tpu.utils.simulate import (random_transcriptome,
                                            simulate_reads, write_fastq)

    ext = ".fq" if plain else ".fq.gz"
    tag = f"n{n_reads}_f{n_files}_L{read_len}{'_p' if paired else ''}"
    d = os.path.join(CACHE, tag)
    paths1 = [os.path.join(d, f"r1_{i}{ext}") for i in range(n_files)]
    paths2 = [os.path.join(d, f"r2_{i}{ext}") for i in range(n_files)]
    if all(os.path.exists(p) for p in paths1) and (
            not paired or all(os.path.exists(p) for p in paths2)):
        return paths1, paths2
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    _, seqs = random_transcriptome(rng, num_transcripts=200)
    sim = simulate_reads(rng, seqs, num_reads=n_reads, read_len=read_len,
                         error_rate=0.005, paired=paired)
    per = (n_reads + n_files - 1) // n_files
    for i in range(n_files):
        write_fastq(paths1[i], sim.reads1[i * per:(i + 1) * per])
        if paired:
            write_fastq(paths2[i], sim.reads2[i * per:(i + 1) * per])
    return paths1, paths2


def timed(name: str, total_reads: int, fn):
    t0 = time.perf_counter()
    n = fn()
    dt = time.perf_counter() - t0
    log(f"{name:44s} {n:>9d} reads  {dt:6.2f} s  "
        f"{n / dt / 1e6:6.2f}M reads/s")
    return n / dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--files", type=int, default=4)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--paired", action="store_true")
    ap.add_argument("--plain", action="store_true",
                    help="uncompressed FASTQ (isolates the consumer: "
                         "gz inflate is the 2-CPU wall otherwise)")
    ap.add_argument("--workers", type=int, nargs="*", default=[1, 4])
    args = ap.parse_args()

    from seekmer_tpu.config import MapConfig
    from seekmer_tpu.io.fastq import (_BucketAccumulator,
                                      CheckpointableBatchSource,
                                      _parallel_chunks,
                                      batch_read_pairs_native,
                                      batch_reads_native)
    from seekmer_tpu.native.packer import get_lib, stream_packed

    assert get_lib() is not None, "C packer required"
    paths1, paths2 = dataset(args.reads, args.files, args.read_len,
                             args.paired, args.plain)

    def raw(workers: int) -> int:
        all_paths = paths1 + (paths2 if args.paired else [])
        makers = [(lambda p=p: stream_packed(p, 512)) for p in all_paths]
        if workers > 1:
            it = _parallel_chunks(makers, workers)
        else:
            def ser():
                for m in makers:
                    yield from m()
            it = ser()
        return sum(c.shape[0] for c, _ in it)

    def numpy_bucket(workers: int) -> int:
        cfg = MapConfig(io_workers=workers)
        acc = _BucketAccumulator(cfg)
        makers = [(lambda p=p: stream_packed(p, cfg.max_read_len))
                  for p in paths1]
        it = (_parallel_chunks(makers, workers) if workers > 1 else
              (ch for m in makers for ch in m()))
        n = 0
        for codes, lengths in it:
            for b in acc.add(codes, lengths):
                n += b.n_real
        for b in acc.flush():
            n += b.n_real
        return n

    def c_bucket(workers: int) -> int:
        cfg = MapConfig(io_workers=workers)
        if args.paired:
            it = batch_read_pairs_native(paths1, paths2, cfg)
        else:
            it = batch_reads_native(paths1, cfg)
        return sum(b.n_real for b in it)

    def ckpt() -> int:
        src = CheckpointableBatchSource(
            paths1, paths2 if args.paired else None, MapConfig(io_workers=1))
        return sum(b.n_real for b in src)

    unit = "pairs" if args.paired else "reads"
    log(f"dataset: {args.reads} {unit} x {args.read_len}bp over "
        f"{args.files} {'plain' if args.plain else '.gz'} files"
        f"{' (paired)' if args.paired else ''}")
    for w in args.workers:
        timed(f"raw C decode (all files) io_workers={w}", args.reads,
              lambda: raw(w))
    if not args.paired:
        for w in args.workers:
            timed(f"numpy bucket pipeline   io_workers={w}", args.reads,
                  lambda: numpy_bucket(w))
    for w in args.workers:
        timed(f"C bucket pipeline       io_workers={w}", args.reads,
              lambda: c_bucket(w))
    timed("checkpointable source   io_workers=1", args.reads, ckpt)


if __name__ == "__main__":
    main()
