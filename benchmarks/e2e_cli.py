#!/usr/bin/env python
"""End-to-end CLI wall-clock benchmark (the production surface, not the
device-path protocol of bench.py): simulate a paired isoform workload,
write gzipped FASTQ, and time `python -m seekmer_tpu infer` as a real
subprocess. --ab compares packed H2D against --no-h2d-pack.

Usage:
  python benchmarks/e2e_cli.py [--pairs 1000000] [--ab]
      [--workdir .bench_cache/e2e]

Dataset + index are cached in --workdir across runs. The parent process
never touches a JAX backend while an infer child runs: one process per
card (a second JAX process would find most of the card's memory taken).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sh_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return env


def _prepare(workdir: str, pairs: int, seed: int) -> dict:
    """Simulate + write dataset and index once; cache by parameter stamp."""
    os.makedirs(workdir, exist_ok=True)
    stamp_path = os.path.join(workdir, "stamp.json")
    stamp = {"pairs": pairs, "seed": seed, "v": 1}
    paths = {
        "fa": os.path.join(workdir, "ref.fa"),
        "idx": os.path.join(workdir, "idx.npz"),
        "r1": os.path.join(workdir, "r1.fq.gz"),
        "r2": os.path.join(workdir, "r2.fq.gz"),
    }
    if os.path.exists(stamp_path):
        with open(stamp_path) as fh:
            if json.load(fh) == stamp and all(
                    os.path.exists(p) for p in paths.values()):
                print(f"[e2e] reusing cached dataset in {workdir}",
                      file=sys.stderr)
                return paths

    sys.path.insert(0, REPO)
    from seekmer_tpu.utils.simulate import (isoform_transcriptome,
                                            simulate_reads, write_fasta,
                                            write_fastq)

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    names, seqs, _genes = isoform_transcriptome(rng, num_genes=2000)
    write_fasta(paths["fa"], names, seqs)
    print(f"[e2e] transcriptome: {len(seqs)} isoforms "
          f"({time.perf_counter() - t0:.0f}s)", file=sys.stderr)
    t0 = time.perf_counter()
    sim = simulate_reads(rng, seqs, num_reads=pairs, read_len=100,
                         paired=True, mean_frag=260.0, sd_frag=30.0,
                         error_rate=0.005)
    write_fastq(paths["r1"], sim.reads1)
    write_fastq(paths["r2"], sim.reads2)
    print(f"[e2e] {pairs} pairs simulated+gzipped "
          f"({time.perf_counter() - t0:.0f}s)", file=sys.stderr)
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, "-m", "seekmer_tpu", "index", paths["fa"],
         paths["idx"]],
        check=True, env=_sh_env(), cwd=REPO)
    print(f"[e2e] index built ({time.perf_counter() - t0:.0f}s)",
          file=sys.stderr)
    with open(stamp_path, "w") as fh:
        json.dump(stamp, fh)
    return paths


def _run_infer(paths: dict, outdir: str, extra_flags: list[str]) -> dict:
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, "-m", "seekmer_tpu", "infer", paths["idx"], outdir,
         paths["r1"], "--mates", paths["r2"], "--em-accel", "squarem",
         *extra_flags],
        check=True, env=_sh_env(), cwd=REPO)
    wall = time.perf_counter() - t0
    with open(os.path.join(outdir, "run_info.json")) as fh:
        info = json.load(fh)
    t = info["timings"]
    return {
        "wall_s": round(wall, 1),
        "map_s": round(t["map_s"], 1),
        "em_s": round(t["em_s"], 1),
        "resolve_s": round(t["resolve_s"], 2),
        "p_mapped": round(info["p_mapped"], 4),
        "pairs_per_s_wall": round(info["total_reads"] / wall, 1),
        "pairs_per_s_map": round(info["total_reads"] / t["map_s"], 1),
    }


def _run_warm(paths: dict, sample: int = 0, pack_cache: bool = False
              ) -> dict:
    """Steady-state end-to-end: TWO full library-level runs in THIS
    process (round-4 verdict item 2). The first run pays the per-process
    compile (inside its map timer); the second reuses every jitted
    program, so its map wall isolates what
    production actually sees per dataset — ingest + H2D + device compute
    with prefetch overlap, compile amortized.

    ``pack_cache`` (round-5 verdict item 3): the cold arm BUILDS the
    pack cache while mapping; the warm arm mmaps it — its map wall is
    the cached path (no decode/parse/pack), the number DISTRIBUTED.md's
    multi-chip-host ingest consequence rests on."""
    sys.path.insert(0, REPO)
    from seekmer_tpu.config import EMConfig, MapConfig, PipelineConfig
    from seekmer_tpu.index.store import KMerIndex
    from seekmer_tpu.models.quantifier import Quantifier

    index = KMerIndex.load(paths["idx"])
    cfg = PipelineConfig(
        map=MapConfig(paired_end=True, probe_sample=sample),
        em=EMConfig(accel="squarem"))
    cache_dir = os.path.join(os.path.dirname(paths["r1"]),
                             "warm.smpack") if pack_cache else None
    if cache_dir and os.path.exists(cache_dir):
        import shutil

        shutil.rmtree(cache_dir)  # cold arm must measure the BUILD
    arms = [("cold", cache_dir), ("warm", cache_dir)]
    if pack_cache:
        # same-process plain-ingest arm: cached vs fresh compared in
        # one process
        arms.append(("warm_no_cache", None))
        arms.append(("warm_cached_again", cache_dir))
    out = {}
    for arm, cd in arms:
        t0 = time.perf_counter()
        r = Quantifier(index, cfg).quantify_files(
            [paths["r1"]], [paths["r2"]], pack_cache=cd)
        wall = time.perf_counter() - t0
        out[arm] = {
            "wall_s": round(wall, 1),
            "map_s": round(r.timings["map_s"], 1),
            "em_s": round(r.timings["em_s"], 1),
            "p_mapped": round(r.mapped / max(r.total_reads, 1), 4),
            "pairs_per_s_map": round(r.total_reads / r.timings["map_s"], 1),
        }
        print(f"[e2e] {arm}: {out[arm]}", file=sys.stderr)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=1_000_000)
    ap.add_argument("--workdir",
                    default=os.path.join(REPO, ".bench_cache", "e2e"))
    ap.add_argument("--seed", type=int, default=20260820)
    ap.add_argument("--ab", action="store_true",
                    help="run twice: packed H2D (default) vs --no-h2d-pack")
    ap.add_argument("--no-pack-only", action="store_true",
                    help="run only the --no-h2d-pack arm")
    ap.add_argument("--warm", action="store_true",
                    help="steady-state arm: two library runs in ONE "
                         "process; the second isolates compile-amortized "
                         "end-to-end throughput")
    ap.add_argument("--probe-sample", type=int, default=0,
                    help="fast-mode sampling stride for the --warm arm")
    ap.add_argument("--pack-cache", action="store_true",
                    help="--warm arm: cold run builds the pack cache, "
                         "warm run maps from it (ingest skipped)")
    ap.add_argument("--prep-only", action="store_true",
                    help="simulate/write/index the dataset and exit "
                         "(host-only; safe while the chip is busy)")
    args = ap.parse_args()

    paths = _prepare(args.workdir, args.pairs, args.seed)
    if args.prep_only:
        print(json.dumps({"prepared": True, "pairs": args.pairs}))
        return 0
    out = {"pairs": args.pairs}
    if args.warm:
        out["warm_process"] = _run_warm(paths, sample=args.probe_sample,
                                        pack_cache=args.pack_cache)
        print(json.dumps(out))
        return 0
    if not args.no_pack_only:
        print("[e2e] infer (2-bit packed H2D)...", file=sys.stderr)
        out["packed"] = _run_infer(paths, os.path.join(args.workdir, "out_p"),
                                   [])
    if args.ab or args.no_pack_only:
        print("[e2e] infer (--no-h2d-pack)...", file=sys.stderr)
        out["unpacked"] = _run_infer(
            paths, os.path.join(args.workdir, "out_u"), ["--no-h2d-pack"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
