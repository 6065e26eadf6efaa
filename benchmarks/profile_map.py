"""Stage-level timing of the device map step on real hardware: where does
the time go? (pack -> probe -> signature-extract -> accumulate)

Run: python benchmarks/profile_map.py [--reads-per-batch N] [--batches N]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--transcripts", type=int, default=1000)
    ap.add_argument("--reads-per-batch", type=int, default=65536)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--isoform", action="store_true",
                    help="GENCODE-scale isoform world (config-2 scale; "
                         "reuses the configs.py index cache)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from seekmer_tpu.config import MapConfig
    from seekmer_tpu.map.driver import DeviceIndex
    from seekmer_tpu.map.signature import (
        accumulate, make_sig_table, read_signatures, fingerprint,
    )
    from seekmer_tpu.index.build import build_index_from_seqs
    from seekmer_tpu.ops.kmer_pack import pack_canonical
    from seekmer_tpu.ops.probe import lookup_ecs
    from seekmer_tpu.utils.simulate import (
        random_transcriptome, simulate_packed_batches,
    )

    log = lambda *a: print(*a, file=sys.stderr, flush=True)
    if args.isoform:
        from benchmarks.configs import _world

        rng, index, seqs, _ = _world(args.transcripts, isoform=True)
    else:
        rng = np.random.default_rng(1)
        names, seqs = random_transcriptome(
            rng, num_transcripts=args.transcripts, min_len=300, max_len=3000,
            shared_prefix_frac=0.5)
        index = build_index_from_seqs(names, seqs)
    di = DeviceIndex.from_host(index)
    cfg = MapConfig(batch_size=args.reads_per_batch)
    B, L = args.reads_per_batch, args.read_len
    codes, _ = simulate_packed_batches(rng, seqs, args.batches, B, read_len=L)
    codes_d = [jnp.asarray(c) for c in codes]
    lengths = jnp.full(B, L, jnp.int32)
    weights = jnp.ones(B, jnp.int32)

    k = index.k

    # tables passed as arguments (closed-over arrays would be baked into
    # the program as constants)
    @jax.jit
    def stage_pack(tb, st, c):
        return pack_canonical(c, lengths, k)

    @jax.jit
    def stage_probe(tb, st, c):
        hi, lo, valid = pack_canonical(c, lengths, k)
        return lookup_ecs(hi, lo, valid, tb, di.main_slots,
                          st, di.stash_slots, di.bucket)

    @jax.jit
    def stage_sig(tb, st, c):
        hi, lo, valid = pack_canonical(c, lengths, k)
        ecs = lookup_ecs(hi, lo, valid, tb, di.main_slots,
                         st, di.stash_slots, di.bucket)
        sig, mapped = read_signatures(ecs, valid, cfg.max_ecs_per_read)
        return sig, mapped

    def stage_full():
        table = make_sig_table(cfg.sig_table_bits, cfg.max_ecs_per_read)
        acc = jax.jit(accumulate, static_argnames=("sig_probe",),
                      donate_argnums=(0,))

        def run(c, t):
            sig, mapped = stage_sig(di.table, di.stash, c)
            return acc(t, sig, mapped, weights=weights,
                       sig_probe=cfg.sig_probe)
        return run, table

    readback = jax.block_until_ready

    def bench(name, fn):
        # slope protocol: time n and 2n enqueued batches (async dispatch,
        # one block_until_ready at the end of each); the difference is n
        # batches of pure device compute, with the sync cost cancelled.
        out = fn(di.table, di.stash, codes_d[0])
        readback(out)
        n = max((args.batches - 1) // 2, 1)

        def run(m):
            t0 = time.perf_counter()
            out = None
            for i in range(m):
                out = fn(di.table, di.stash, codes_d[1 + i % (args.batches - 1)])
            readback(out)
            return time.perf_counter() - t0

        run(1)  # settle
        t_n, t_2n = run(n), run(2 * n)
        dt = (t_2n - t_n) / n
        log(f"{name:28s} {dt*1e3:8.2f} ms/batch "
            f"{B/dt/1e6:8.2f} Mreads/s  (sync+ovh {t_n - n*dt:+.3f}s)")
        return dt

    @jax.jit
    def stage_gather(tb, st, c):
        # the bare bucket gather + full-row consume, no compare/select —
        # isolates the HBM cost from the vector work layered on it
        hi, lo, valid = pack_canonical(c, lengths, k)
        nb = di.main_slots // di.bucket
        hb = hi.reshape(-1).astype(jnp.uint32) & jnp.uint32(nb - 1)
        return tb[hb.astype(jnp.int32)].sum(axis=1)

    @jax.jit
    def stage_probe_nostash(tb, st, c):
        # main-bucket lookup only (no stash pass / block compaction):
        # bounds what the two-table guarantee costs on top of one lookup
        from seekmer_tpu.ops.hash import hash_kmer as hk
        from seekmer_tpu.ops.probe import _bucket_lookup

        hi, lo, valid = pack_canonical(c, lengths, k)
        ec, aux, found, full = _bucket_lookup(
            hi.reshape(-1), lo.reshape(-1), tb, di.main_slots, di.bucket, hk)
        return jnp.where(valid.reshape(-1) & found, ec, -1)

    t_pack = bench("pack_canonical", stage_pack)
    t_gather = bench("pack+bare bucket gather", stage_gather)
    t_nostash = bench("pack+main-bucket lookup", stage_probe_nostash)
    t_probe = bench("pack+probe", stage_probe)
    t_sig = bench("pack+probe+signature", stage_sig)

    run, table = stage_full()
    table = run(codes_d[0], table)
    readback(table)
    n = max((args.batches - 1) // 2, 1)

    def run_m(m, table):
        t0 = time.perf_counter()
        for i in range(m):
            table = run(codes_d[1 + i % (args.batches - 1)], table)
        readback(table)
        return time.perf_counter() - t0, table

    _, table = run_m(1, table)
    t_n, table = run_m(n, table)
    t_2n, table = run_m(2 * n, table)
    t_full = (t_2n - t_n) / n
    log(f"{'full step':28s} {t_full*1e3:8.2f} ms/batch "
        f"{B/t_full/1e6:8.2f} Mreads/s")
    log(f"breakdown: pack {t_pack*1e3:.1f} | probe {t_probe*1e3 - t_pack*1e3:.1f} | "
        f"sig {t_sig*1e3 - t_probe*1e3:.1f} | acc {t_full*1e3 - t_sig*1e3:.1f} ms")


if __name__ == "__main__":
    main()
