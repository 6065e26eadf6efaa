#!/usr/bin/env python
"""Benchmark driver: reads mapped/s/chip on the primary config
(BASELINE.json:2 metrics; config-1-scale single-end workload by default).

Prints ONE JSON line:
  {"metric": "reads_mapped_per_s_per_chip", "value": N, "unit": "reads/s",
   "vs_baseline": R, "extra": {...}}

vs_baseline: the project target is >= 10x a single-CPU-core mapper
[BASELINE.json:5]; no published reference numbers exist (BASELINE.md — the
reference mount is empty, SURVEY.md section 0). We therefore measure a
single-core CPU baseline in-process — a COMPILED single-threaded C mapper
of the reference's algorithm class (native/cpu_baseline.c, semantics
oracle-verified; the slower numpy/dict oracle rate is also reported for
continuity with rounds 1-2) — and report
vs_baseline = device_rps / (10 * cpu_rps): >= 1.0 means the 10x target is
met against that measured stand-in.

Timing protocol: the device step (pack -> probe -> signature -> accumulate)
is fed pre-uploaded batches; one warmup batch triggers compilation, then the
batch set is timed as repeated windows, each ending in block_until_ready on
the donated signature table. The best window is the headline and every
window's rate is reported in extra. Host FASTQ decode is excluded (it is
pipelined in production and measured separately in benchmarks/). The
benchmark refuses to run without a GPU: a CPU rate is not a device metric.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--transcripts", type=int, default=1000)
    ap.add_argument("--reads-per-batch", type=int, default=65536)
    ap.add_argument("--batches", type=int, default=12)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--cpu-sample", type=int, default=2000)
    ap.add_argument("--sig-table-bits", type=int, default=20)
    ap.add_argument("--probe-stride", type=int, default=1,
                    help="probe every Nth window, run-length gap coverage "
                         "(1 = bit-exact dense probing)")
    ap.add_argument("--windows", type=int, default=5,
                    help="timed windows (best window is the headline)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from seekmer_tpu.config import EMConfig, MapConfig
    from seekmer_tpu.em.em import build_ec_table, run_em, tpm_from_alpha
    from seekmer_tpu.index.build import build_index_from_seqs
    from seekmer_tpu.map.driver import Mapper, resolve_signatures
    from seekmer_tpu.io.fastq import ReadBatch
    from seekmer_tpu.utils.simulate import (
        random_transcriptome,
        simulate_packed_batches,
    )
    from tests.oracle import oracle as orc

    rng = np.random.default_rng(12345)
    log = lambda *a: print(*a, file=sys.stderr, flush=True)

    if jax.default_backend() != "gpu":
        log(f"[bench] no GPU found (devices: {jax.devices()}); refusing to "
            "report a device rate")
        return 1
    log(f"[bench] devices: {jax.devices()}")
    names, seqs = random_transcriptome(
        rng, num_transcripts=args.transcripts, min_len=300, max_len=3000,
        shared_prefix_frac=0.5,
    )
    t0 = time.perf_counter()
    index = build_index_from_seqs(names, seqs)
    log(f"[bench] index: {index.num_kmers} kmers, {index.num_ecs} ECs "
        f"in {time.perf_counter() - t0:.1f}s")

    B, L = args.reads_per_batch, args.read_len
    codes, true_counts = simulate_packed_batches(
        rng, seqs, args.batches + 1, B, read_len=L)
    lengths = np.full(B, L, np.int32)
    weights = np.ones(B, np.int32)

    cfg = MapConfig(batch_size=B, sig_table_bits=args.sig_table_bits,
                    probe_stride=args.probe_stride)
    mapper = Mapper(index, cfg)

    import dataclasses as _dc

    def dataclasses_replace_cfg(c, sample):
        # force probe_stride=1: the fast arm always runs two-phase mode,
        # and inheriting --probe-stride > 1 would trip MapConfig's
        # mutual-exclusion validation mid-bench (round-4 advisor finding)
        return _dc.replace(c, probe_sample=sample, probe_stride=1)

    def batch(i):
        return ReadBatch(codes=codes[i], lengths=lengths, weights=weights)

    from seekmer_tpu.utils.prefetch import device_put_batches

    # Pre-upload all batches: the timing protocol (see module docstring)
    # measures the device mapping path; H2D overlaps compute in production
    # (the prefetch producer thread) and is measured separately.
    pre = list(device_put_batches(
        batch(i) for i in range(args.batches + 1)))
    jax.block_until_ready([b.codes for b in pre])

    # warmup/compile
    t0 = time.perf_counter()
    mapper.feed(pre[0])
    jax.block_until_ready(mapper.table)
    log(f"[bench] warmup (compile) {time.perf_counter() - t0:.1f}s")

    def timed_windows(m, n_windows):
        rates = []
        for _ in range(n_windows):
            t0 = time.perf_counter()
            for b in pre[1:]:
                m.feed(b)
            jax.block_until_ready(m.table)
            rates.append(n_reads / (time.perf_counter() - t0))
        return rates

    n_reads = args.batches * B
    window_rates = timed_windows(mapper, args.windows)
    for w, r in enumerate(window_rates):
        log(f"[bench] window {w}: {r:,.0f} reads/s")
    device_rps = max(window_rates)
    log(f"[bench] best of {len(window_rates)} windows: "
        f"{device_rps:,.0f} reads/s/chip "
        f"(median {np.median(window_rates):,.0f})")

    # FAST mode (MapConfig.probe_sample — two-phase early-exit probing,
    # the vectorized analog of the reference's own skipping heuristic,
    # SURVEY.md 3.3): measured in the same process with the same
    # pre-uploaded batches. Accuracy on this workload: zero mapped-count
    # delta, >= 99.8% per-signature count agreement vs dense
    # (benchmarks/micro_sample.py, 2026-08-21). Reported in extra; the
    # headline stays the dense/exact mode.
    fast_stride = 16
    fast_mapper = Mapper(index, dataclasses_replace_cfg(cfg, fast_stride))
    t0 = time.perf_counter()
    fast_mapper.feed(pre[0])
    jax.block_until_ready(fast_mapper.table)
    log(f"[bench] fast-mode warmup (compile) {time.perf_counter() - t0:.1f}s")
    fast_rates = timed_windows(fast_mapper, args.windows)
    fast_rps = max(fast_rates)
    log(f"[bench] fast mode (probe_sample={fast_stride}): best "
        f"{fast_rps:,.0f} reads/s "
        f"windows {[f'{r:,.0f}' for r in fast_rates]}")

    # quantification tail (resolve + EM) and TPM error vs float64 oracle EM
    result = mapper.finalize()
    members, counts, _ = resolve_signatures(result, index)
    em_cfg = EMConfig(rel_tol=1e-6, max_iters=2000)
    ec = build_ec_table(members, counts, index.num_transcripts)
    alpha, iters = run_em(ec, index.lengths, em_cfg)  # warm/compile
    jax.block_until_ready(alpha)
    t0 = time.perf_counter()
    alpha, iters = run_em(ec, index.lengths, em_cfg)
    jax.block_until_ready(alpha)
    em_dt = time.perf_counter() - t0
    em_it_s = int(iters) / em_dt
    tpm = np.asarray(tpm_from_alpha(alpha, index.lengths, em_cfg))
    o_alpha, _ = orc.run_em(members, counts, index.lengths, em_cfg)
    o_tpm = orc.tpm_from_alpha(o_alpha, index.lengths, em_cfg)
    tpm_err = float(np.abs(tpm - o_tpm).max())
    log(f"[bench] EM: {int(iters)} iters in {em_dt:.2f}s "
        f"({em_it_s:,.0f} it/s); TPM max-abs-err vs f64 oracle: {tpm_err:.3g}")

    # steady-state EM iteration rate (BASELINE metric "EM iterations/s"):
    # fixed 2000-iteration runs, several enqueued before one sync
    ss_cfg = EMConfig(rel_tol=0.0, min_iters=2000, max_iters=2000)
    alpha_ss, it_ss = run_em(ec, index.lengths, ss_cfg)  # warm/compile
    jax.block_until_ready(alpha_ss)
    reps = 10
    t0 = time.perf_counter()
    outs = [run_em(ec, index.lengths, ss_cfg) for _ in range(reps)]
    jax.block_until_ready(outs)
    em_ss_it_s = reps * int(it_ss) / (time.perf_counter() - t0)
    log(f"[bench] EM steady-state: {em_ss_it_s:,.0f} it/s "
        f"({reps}x{int(it_ss)} fixed iters)")

    # single-CPU-core baselines. Two stand-ins for the missing reference
    # binary (SURVEY.md section 0):
    #   1. COMPILED C single-thread mapper (native/cpu_baseline.c) — the
    #      honest analog of the reference's Cython kernel; vs_baseline is
    #      computed against THIS (VERDICT r2 weak item 1);
    #   2. the numpy/dict oracle loop — retained in extra for continuity
    #      with BENCH_r01/r02.
    sample = codes[0][: args.cpu_sample]
    kdict = orc.build_kmer_dict(index)

    t0 = time.perf_counter()
    for row in sample:
        orc.map_read(row, kdict, index.k)
    oracle_dt = time.perf_counter() - t0
    oracle_rps = args.cpu_sample / oracle_dt
    log(f"[bench] CPU 1-core oracle (numpy/dict): {oracle_rps:,.0f} reads/s")

    from seekmer_tpu.native.cpu_baseline import CpuBaselineMapper, get_lib

    cpu_windows = []
    if get_lib() is not None:
        cbm = CpuBaselineMapper(index, sig_bits=args.sig_table_bits)
        cbm.map(codes[0][:256])  # touch table/branch predictors
        # best-of-k for the DENOMINATOR too: host noise would otherwise
        # move vs_baseline. Same discipline as the device windows:
        # several timed passes, best is the rate, all windows reported in
        # extra for audit.
        for _ in range(5):
            t0 = time.perf_counter()
            n_mapped_c = cbm.map(codes[0])
            cpu_windows.append(codes[0].shape[0]
                               / (time.perf_counter() - t0))
        cpu_rps = max(cpu_windows)
        cpu_kind = "compiled C single-thread mapper (native/cpu_baseline.c)"
        log(f"[bench] CPU 1-core compiled: best {cpu_rps:,.0f} reads/s of "
            f"{[f'{r:,.0f}' for r in cpu_windows]} "
            f"({n_mapped_c}/{codes[0].shape[0]} mapped)")
        # the same compiled loop WITH the reference's skipping heuristic
        # (jump by EC run length, SURVEY.md 3.3) — the strongest
        # single-core stand-in, signature-exact up to the ~1e-7/window
        # error-collision caveat; pairs against the fast mode above
        cpu_skip_windows = []
        for _ in range(5):
            t0 = time.perf_counter()
            cbm.map(codes[0], use_skip=True)
            cpu_skip_windows.append(codes[0].shape[0]
                                    / (time.perf_counter() - t0))
        cpu_skip_rps = max(cpu_skip_windows)
        log(f"[bench] CPU 1-core compiled+skip: best {cpu_skip_rps:,.0f} "
            f"reads/s of {[f'{r:,.0f}' for r in cpu_skip_windows]}")
        cbm.close()
    else:  # no C toolchain: fall back to the oracle stand-in
        cpu_rps = oracle_rps
        cpu_skip_rps = oracle_rps
        cpu_skip_windows = []
        cpu_kind = "in-process numpy/dict oracle mapper (no C toolchain)"

    vs_baseline = device_rps / (10.0 * cpu_rps)
    print(json.dumps({
        "metric": "reads_mapped_per_s_per_chip",
        "value": round(device_rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(vs_baseline, 3),
        "extra": {
            "window_reads_per_s": [round(r, 1) for r in window_rates],
            "median_reads_per_s": round(float(np.median(window_rates)), 1),
            # FAST mode (probe_sample=16, the vectorized analog of the
            # reference's skipping heuristic): zero mapped delta, >=99.8%
            # per-signature agreement on this workload
            # (benchmarks/micro_sample.py). Its fair CPU pairing is the
            # compiled core WITH the reference's skip heuristic below.
            "fast_mode_reads_per_s": round(fast_rps, 1),
            "fast_mode_sample_stride": fast_stride,
            "fast_mode_window_reads_per_s": [round(r, 1)
                                             for r in fast_rates],
            "fast_vs_cpu_skip_baseline": round(
                fast_rps / (10.0 * cpu_skip_rps), 3),
            "cpu_1core_skip_reads_per_s": round(cpu_skip_rps, 1),
            "cpu_1core_skip_window_reads_per_s": [
                round(r, 1) for r in cpu_skip_windows],
            "em_iterations_per_s": round(em_ss_it_s, 1),
            "em_convergence_iterations_per_s": round(em_it_s, 1),
            "tpm_max_abs_err_vs_f64_oracle": tpm_err,
            "cpu_1core_reads_per_s": round(cpu_rps, 1),
            "cpu_1core_window_reads_per_s": [round(r, 1)
                                             for r in cpu_windows],
            "cpu_1core_oracle_reads_per_s": round(oracle_rps, 1),
            # the same compiled baseline at GENCODE scale (27.4M k-mers,
            # 805 MB DRAM-bound table): dense ~170k reads/s, with the
            # skip heuristic ~645k — too slow to re-run inside this
            # bench; reproduce with benchmarks/cpu_baseline_scale.py
            # (measured 2026-08-21 on the earlier build host's CPU).
            "cpu_1core_gencode_reads_per_s_documented": 170000,
            "cpu_1core_gencode_skip_reads_per_s_documented": 645000,
            # no reference binary exists on this machine (SURVEY.md 0):
            # the 10x-per-chip target [BASELINE.json:5] is measured against
            # a compiled single-threaded C mapper of the reference's
            # algorithm class (semantics oracle-verified in
            # tests/test_native_packer.py); the r01/r02 numpy/dict oracle
            # rate is retained above for cross-round continuity
            "cpu_baseline_kind": cpu_kind,
            "mapped_fraction": result.mapped / max(result.total_reads, 1),
            "n_reads": n_reads,
            "n_transcripts": args.transcripts,
            "read_len": L,
            "platform": jax.devices()[0].platform,
            "device_kind": jax.devices()[0].device_kind,
            "device_count": len(jax.devices()),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
