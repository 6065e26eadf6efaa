"""Fast-mode (MapConfig.probe_sample) stage bisect + stride sweep —
round-5 verdict item 1: a stage breakdown of the fast path, so its
ceiling can be stated and its largest non-gather term attacked.

Stages are CUMULATIVE prefixes of the real production code
(ops/probe.two_phase_signatures's ``_stage`` hook — not re-implemented
copies):

  pack       pack_canonical of all segments
  phase1     + sampled probe (one lookup over the sampled columns)
  classify   + per-segment classification and staging
  fallback1  + the first dense fallback round (capped unit compaction)
  fallback   + the residual while_loop (usually 0 iterations)
  sig        + the uniform merge (2 sorts over (B, n_seg*C)) -> sig/mapped
  full       + fold_batch accumulate (steady state: all signatures claimed)

Protocol: slope timing over pre-uploaded distinct batches, each window
ended by a block on its result.

Run single-process on the chip:
  python benchmarks/micro_fast.py \
      [--isoform --paired] [--samples 8 16 32 64] [--bisect-sample 16]
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

log = lambda *a: print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--transcripts", type=int, default=1000)
    ap.add_argument("--reads-per-batch", type=int, default=65536)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--error-rate", type=float, default=0.005)
    ap.add_argument("--isoform", action="store_true",
                    help="GENCODE-scale isoform world (config-2)")
    ap.add_argument("--paired", action="store_true")
    ap.add_argument("--samples", type=int, nargs="*", default=[8, 16, 32, 64],
                    help="probe_sample values for the stride sweep")
    ap.add_argument("--bisect-sample", type=int, default=16,
                    help="probe_sample for the full stage bisect")
    ap.add_argument("--fallback-frac", type=float, default=None,
                    help="override MapConfig.sample_fallback_frac")
    ap.add_argument("--frac-sweep", type=float, nargs="*", default=None,
                    help="same-process full-step A/B over these "
                         "sample_fallback_frac values (cap sizing)")
    ap.add_argument("--only-full", action="store_true",
                    help="skip the stage bisect; measure only the full "
                         "steady step (+ the fallback fraction) — for "
                         "cap-sizing A/Bs")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from benchmarks.configs import _world
    from seekmer_tpu.config import MapConfig
    from seekmer_tpu.map.driver import DeviceIndex, _auto_probe_chunks
    from seekmer_tpu.map.signature import (SIG_PAD, fold_batch,
                                           make_sig_table, read_signatures)
    from seekmer_tpu.ops.kmer_pack import pack_canonical
    from seekmer_tpu.ops.probe import two_phase_signatures
    from seekmer_tpu.utils.simulate import (simulate_packed_batches,
                                            simulate_packed_pairs)

    log(f"[fast] devices: {jax.devices()}")
    rng, index, seqs, _ = _world(args.transcripts if not args.isoform
                                 else 60000, isoform=args.isoform)
    di = DeviceIndex.from_host(index)
    cfg = MapConfig(batch_size=args.reads_per_batch)
    frac = (args.fallback_frac if args.fallback_frac is not None
            else (cfg.sample_fallback_frac or 0.125))
    B, L, k = args.reads_per_batch, args.read_len, index.k
    NB = args.batches

    if args.paired:
        c1, c2, _ = simulate_packed_pairs(rng, seqs, NB, B, read_len=L,
                                          error_rate=args.error_rate)
        feeds = [(jnp.asarray(c1[i]), jnp.asarray(c2[i])) for i in range(NB)]
    else:
        c1, _ = simulate_packed_batches(rng, seqs, NB, B, read_len=L,
                                        error_rate=args.error_rate)
        feeds = [(jnp.asarray(c1[i]),) for i in range(NB)]
    jax.block_until_ready([x for f in feeds for x in f])
    lengths = jnp.full(B, L, jnp.int32)
    weights = jnp.ones(B, jnp.int32)
    P1 = L - k + 1
    n_seg = 2 if args.paired else 1
    C = cfg.max_ecs_per_read

    def wire(sample, fr):
        """Mirror map_step's two_phase wiring exactly."""
        chunks = _auto_probe_chunks(cfg, B * (n_seg * P1 // sample + 1),
                                    di.bucket)
        capu = max(int(B * fr) * n_seg, 128)
        fb_chunks = _auto_probe_chunks(cfg, capu * P1, di.bucket)
        return chunks, capu, fb_chunks

    def make_stage(stage, sample, fr=None):
        fr = frac if fr is None else fr
        chunks, _, fb_chunks = wire(sample, fr)

        def fn(tb, st, *cs):
            packed = [pack_canonical(c, lengths, k) for c in cs]
            h = jnp.concatenate([p[0] for p in packed], axis=1)
            l = jnp.concatenate([p[1] for p in packed], axis=1)
            v = jnp.concatenate([p[2] for p in packed], axis=1)
            if stage == "pack":
                return h, l, v
            segments = [(c, lengths) for c in cs]
            return two_phase_signatures(
                h, l, v, segments, lambda c, ln: pack_canonical(c, ln, k),
                tb, di.main_slots, st, di.stash_slots, di.bucket, sample,
                C, read_signatures, int(SIG_PAD), chunks=chunks,
                fallback_frac=fr, seg_widths=[P1] * n_seg,
                fallback_chunks=fb_chunks,
                _stage=("full" if stage == "sig" else stage))

        return jax.jit(fn)

    readback = jax.block_until_ready

    def bench(name, fn, per_read_unit=1.0):
        out = fn(di.table, di.stash, *feeds[0])
        readback(out)
        n = max((NB - 1) // 2, 1)

        def run(m):
            t0 = time.perf_counter()
            out = None
            for i in range(m):
                out = fn(di.table, di.stash, *feeds[1 + i % (NB - 1)])
            readback(out)
            return time.perf_counter() - t0

        run(1)
        t_n, t_2n = run(n), run(2 * n)
        dt = (t_2n - t_n) / n
        log(f"{name:36s} {dt*1e3:8.2f} ms/batch "
            f"{B/dt/1e6:8.2f}M {'pairs' if args.paired else 'reads'}/s")
        return dt

    # observed fallback-unit fraction (sizes sample_fallback_frac)
    cls = make_stage("classify", args.bisect_sample)
    _, unit_need = cls(di.table, di.stash, *feeds[0])
    fb_frac = float(np.asarray(unit_need).mean())
    log(f"[fast] sample={args.bisect_sample}: fallback-unit fraction "
        f"{fb_frac:.4f} (cap frac {frac})")

    # full steady-state step: stateful accumulate over a claimed table
    def full_step(sample, fr=None):
        sig_fn = make_stage("sig", sample, fr)
        acc = jax.jit(
            functools.partial(fold_batch, sig_probe=cfg.sig_probe,
                              audit=False),
            donate_argnums=(0,))

        def run(t, *cs):
            sig, mapped = sig_fn(di.table, di.stash, *cs)
            return acc(t, sig, mapped, weights=weights)

        table = make_sig_table(cfg.sig_table_bits, C,
                               num_ecs=index.num_ecs)
        for f in feeds:  # claim pass (compile + claim every signature)
            table = run(table, *f)
        readback(table.count)
        n = max((NB - 1) // 2, 1)

        def timed(m, table):
            t0 = time.perf_counter()
            for i in range(m):
                table = run(table, *feeds[1 + i % (NB - 1)])
            readback(table.count)
            return time.perf_counter() - t0, table

        _, table = timed(1, table)
        t_n, table = timed(n, table)
        t_2n, table = timed(2 * n, table)
        return (t_2n - t_n) / n

    if args.frac_sweep:
        log("--- fallback-cap (sample_fallback_frac) sweep, one process ---")
        for fr in args.frac_sweep:
            dt = full_step(args.bisect_sample, fr)
            log(f"frac={fr:5.3f} {dt*1e3:8.2f} ms/batch "
                f"{B/dt/1e6:8.2f}M {'pairs' if args.paired else 'reads'}/s")
        return

    if args.only_full:
        t_full = full_step(args.bisect_sample)
        log(f"full steady step frac={frac} sample={args.bisect_sample}: "
            f"{t_full*1e3:8.2f} ms/batch "
            f"{B/t_full/1e6:8.2f}M {'pairs' if args.paired else 'reads'}/s")
        for s in args.samples:
            dt = full_step(s)
            log(f"probe_sample={s:3d} {dt*1e3:8.2f} ms/batch "
                f"{B/dt/1e6:8.2f}M {'pairs' if args.paired else 'reads'}/s")
        return

    # ---- stage bisect at --bisect-sample ----
    log(f"--- stage bisect (probe_sample={args.bisect_sample}, "
        f"{'paired' if args.paired else 'single'}, "
        f"{'isoform' if args.isoform else 'config-1'}) ---")
    ts = {}
    for stage in ("pack", "phase1", "classify", "fallback1", "fallback",
                  "sig"):
        ts[stage] = bench(stage, make_stage(stage, args.bisect_sample))

    t_full = full_step(args.bisect_sample)
    log(f"{'full (steady accumulate)':36s} {t_full*1e3:8.2f} ms/batch "
        f"{B/t_full/1e6:8.2f}M {'pairs' if args.paired else 'reads'}/s")
    log("breakdown: pack {:.1f} | phase1 probe {:.1f} | classify {:.1f} | "
        "fallback1 {:.1f} | residual {:.1f} | merge {:.1f} | "
        "accumulate {:.1f} ms".format(
            ts["pack"] * 1e3,
            (ts["phase1"] - ts["pack"]) * 1e3,
            (ts["classify"] - ts["phase1"]) * 1e3,
            (ts["fallback1"] - ts["classify"]) * 1e3,
            (ts["fallback"] - ts["fallback1"]) * 1e3,
            (ts["sig"] - ts["fallback"]) * 1e3,
            (t_full - ts["sig"]) * 1e3))

    # ---- stride sweep: end-to-end rate per probe_sample ----
    log("--- stride sweep (full steady step) ---")
    for s in args.samples:
        dt = full_step(s)
        log(f"probe_sample={s:3d} {dt*1e3:8.2f} ms/batch "
            f"{B/dt/1e6:8.2f}M {'pairs' if args.paired else 'reads'}/s")


if __name__ == "__main__":
    main()
