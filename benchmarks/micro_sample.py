"""A/B: dense exact probing vs two-phase early-exit fast mode
(MapConfig.probe_sample; round-4 verdict item 1a), one process,
alternating same-program windows.

Reports per-arm reads/s (best window), the mapped-fraction delta, and
the per-signature count agreement between the two modes on the same
batches (the fast mode's documented approximation, quantified).

Run on the GPU: python benchmarks/micro_sample.py [--sample 4]
    [--error-rate 0.005]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--transcripts", type=int, default=1000)
    ap.add_argument("--reads-per-batch", type=int, default=65536)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--error-rate", type=float, default=0.005)
    ap.add_argument("--samples", type=int, nargs="*", default=[4, 8])
    ap.add_argument("--windows", type=int, default=4)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from seekmer_tpu.config import MapConfig
    from seekmer_tpu.index.build import build_index_from_seqs
    from seekmer_tpu.io.fastq import ReadBatch
    from seekmer_tpu.map.driver import Mapper
    from seekmer_tpu.map.signature import SIG_PAD
    from seekmer_tpu.utils.simulate import (
        random_transcriptome, simulate_reads,
    )

    log = lambda *a: print(*a, file=sys.stderr, flush=True)
    log(f"[sample-ab] devices: {jax.devices()}")
    rng = np.random.default_rng(12345)
    names, seqs = random_transcriptome(
        rng, num_transcripts=args.transcripts, min_len=300, max_len=3000,
        shared_prefix_frac=0.5)
    index = build_index_from_seqs(names, seqs)
    B, L = args.reads_per_batch, args.read_len

    # simulate WITH sequencing errors (the realistic case that killed the
    # strided mode) and pack on host
    code_of = np.full(256, 4, np.uint8)
    for i, b in enumerate("ACGT"):
        code_of[ord(b)] = i
    batches = []
    for i in range(args.batches):
        sim = simulate_reads(rng, seqs, num_reads=B, read_len=L,
                             error_rate=args.error_rate)
        codes = np.full((B, L), 4, np.uint8)
        for j, r in enumerate(sim.reads1):
            codes[j, :len(r)] = code_of[np.frombuffer(r.encode(), np.uint8)]
        batches.append(codes)
    lengths = np.full(B, L, np.int32)
    weights = np.ones(B, np.int32)

    pre = [jnp.asarray(c) for c in batches]
    jax.block_until_ready(pre)
    lengths_d = jnp.asarray(lengths)
    weights_d = jnp.asarray(weights)

    def arm(sample):
        cfg = MapConfig(batch_size=B, sig_table_bits=20,
                        probe_sample=sample, h2d_pack_2bit=False)
        return Mapper(index, cfg)

    def feed_all(m):
        for c in pre:
            m.feed(ReadBatch(c, lengths_d, weights_d))
        jax.block_until_ready(m.table)

    def run_windows(sample):
        # ONE mapper per mode (a fresh Mapper would re-trace its jitted
        # steps — per-instance closures); the warm pass compiles and
        # claims every signature, then each timed window re-feeds the
        # SAME batches, so final counts are exactly (windows+1) x the
        # single-pass counts — scaled back below for the accuracy
        # comparison.
        m = arm(sample)
        feed_all(m)  # warm/compile + claims
        rates = []
        for w in range(args.windows):
            t0 = time.perf_counter()
            feed_all(m)
            dt = time.perf_counter() - t0
            rates.append(args.batches * B / dt)
        res = m.finalize()
        passes = args.windows + 1
        res.sig_counts = res.sig_counts // passes
        res.mapped //= passes
        res.total_reads //= passes
        return rates, res

    results = {}
    for sample in [0] + [s for s in args.samples if s >= 2]:
        rates, res = run_windows(sample)
        results[sample] = res
        log(f"[sample-ab] probe_sample={sample}: best "
            f"{max(rates):,.0f} reads/s  windows "
            f"{[f'{r:,.0f}' for r in rates]}  mapped "
            f"{res.mapped}/{res.total_reads}")

    def sig_dict(res):
        return {tuple(r[r != int(SIG_PAD)].tolist()): int(n)
                for r, n in zip(res.sigs, res.sig_counts)}

    d0 = sig_dict(results[0])
    total = sum(d0.values())
    for sample in args.samples:
        if sample < 2 or sample not in results:
            continue
        ds = sig_dict(results[sample])
        common = sum(min(d0.get(k, 0), n) for k, n in ds.items())
        log(f"[sample-ab] probe_sample={sample}: mapped delta "
            f"{results[sample].mapped - results[0].mapped:+d} "
            f"({(results[sample].mapped - results[0].mapped) / max(results[0].mapped, 1):+.3%}), "
            f"per-signature count agreement {common}/{total} "
            f"({common / max(total, 1):.4%})")


if __name__ == "__main__":
    main()
