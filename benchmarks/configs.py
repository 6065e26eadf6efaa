"""Benchmark drivers for the five BASELINE measurement configs
[BASELINE.json:6-12]. Each prints one JSON line; see also bench.py (the
driver-facing config-1 benchmark).

  python benchmarks/configs.py 1   # single-end, ~1k transcripts, 1 chip
  python benchmarks/configs.py 2   # paired-end, GENCODE-scale isoform
                                   #   transcriptome, replicated index
  python benchmarks/configs.py 3   # data-parallel mapping over the mesh
  python benchmarks/configs.py 4   # prefix-sharded index, all_to_all
  python benchmarks/configs.py 5   # 100 bootstrap replicates via vmap

Configs 3/4 run on whatever devices are visible (several GPUs for real
numbers; set JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_
device_count=8 for a fake mesh smoke run — scaling numbers then measure
plumbing, not the interconnect).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _emit(metric, value, unit, extra):
    print(json.dumps({"metric": metric, "value": round(value, 2),
                      "unit": unit, "extra": extra}))


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE_DIR = os.environ.get("SEEKMER_BENCH_CACHE",
                            os.path.join(REPO, ".bench_cache"))


def _world(transcripts, isoform=False, seed=0):
    import pickle

    from seekmer_tpu.index.build import build_index_from_seqs
    from seekmer_tpu.index.store import KMerIndex
    from seekmer_tpu.utils.simulate import (
        isoform_transcriptome, random_transcriptome,
    )

    rng = np.random.default_rng(seed)
    os.makedirs(_CACHE_DIR, exist_ok=True)
    tag = f"{'iso' if isoform else 'rand'}_{transcripts}_{seed}"
    idx_path = os.path.join(_CACHE_DIR, f"index_{tag}.npz")
    seq_path = os.path.join(_CACHE_DIR, f"seqs_{tag}.pkl")

    t0 = time.perf_counter()
    if os.path.exists(idx_path) and os.path.exists(seq_path):
        index = KMerIndex.load(idx_path)
        with open(seq_path, "rb") as fh:
            seqs = pickle.load(fh)
        # advance the rng identically to the build path
        if isoform:
            isoform_transcriptome(rng, num_genes=transcripts // 3)
        else:
            random_transcriptome(rng, num_transcripts=transcripts,
                                 min_len=300, max_len=3000,
                                 shared_prefix_frac=0.5)
        build_s = 0.0
    else:
        if isoform:
            names, seqs, genes = isoform_transcriptome(
                rng, num_genes=transcripts // 3)
            index = build_index_from_seqs(names, seqs, genes=genes)
        else:
            names, seqs = random_transcriptome(
                rng, num_transcripts=transcripts, min_len=300, max_len=3000,
                shared_prefix_frac=0.5)
            index = build_index_from_seqs(names, seqs)
        build_s = time.perf_counter() - t0
        index.save(idx_path)
        with open(seq_path, "wb") as fh:
            pickle.dump(seqs, fh)
    print(f"[config] index: {index.num_kmers} kmers, {index.num_ecs} ECs, "
          f"{index.num_transcripts} txps in {build_s:.1f}s",
          file=sys.stderr, flush=True)
    return rng, index, seqs, build_s


def _upload(batches):
    """Pre-upload batch arrays to device (bench.py's protocol: the device
    step is timed over pre-uploaded batches; host FASTQ decode + H2D are
    pipelined in production via utils/prefetch and measured separately)."""
    import jax
    import jax.numpy as jnp

    from seekmer_tpu.io.fastq import ReadBatch

    out = []
    for b in batches:
        out.append(ReadBatch(
            jnp.asarray(b.codes), jnp.asarray(b.lengths),
            jnp.asarray(b.weights),
            codes2=None if b.codes2 is None else jnp.asarray(b.codes2),
            lengths2=None if b.lengths2 is None else jnp.asarray(b.lengths2),
            n_real_cached=b.n_real))
    jax.block_until_ready([x.codes for x in out])
    return out


def _time_mapper(mapper, batches, n_reads, windows: int = 3):
    """Best-of-k timed windows, each ended with block_until_ready on the
    signature table, as in bench.py."""
    import jax

    batches = _upload(batches)
    mapper.feed(batches[0])
    jax.block_until_ready(mapper.table)
    best = 0.0
    for _ in range(windows):
        t0 = time.perf_counter()
        for b in batches[1:]:
            mapper.feed(b)
        jax.block_until_ready(mapper.table)
        dt = time.perf_counter() - t0
        best = max(best, (len(batches) - 1) * n_reads / dt)
    return best


def config1(args):
    from seekmer_tpu.config import MapConfig
    from seekmer_tpu.io.fastq import ReadBatch
    from seekmer_tpu.map.driver import Mapper
    from seekmer_tpu.utils.simulate import simulate_packed_batches

    rng, index, seqs, _ = _world(args.transcripts)
    B, L = args.batch, args.read_len
    codes, _ = simulate_packed_batches(rng, seqs, args.batches + 1, B, L)
    cfg = MapConfig(batch_size=B, probe_stride=args.stride,
                    probe_sample=args.sample)
    mapper = Mapper(index, cfg)
    batches = [ReadBatch(codes[i], np.full(B, L, np.int32),
                         np.ones(B, np.int32)) for i in range(len(codes))]
    rps = _time_mapper(mapper, batches, B)
    _emit("config1_reads_per_s_per_chip", rps, "reads/s",
          {"stride": args.stride, "sample": args.sample})


def config2(args):
    from seekmer_tpu.config import MapConfig
    from seekmer_tpu.io.fastq import ReadBatch
    from seekmer_tpu.map.driver import Mapper
    from seekmer_tpu.utils.simulate import simulate_packed_pairs

    rng, index, seqs, build_s = _world(args.transcripts, isoform=True)
    B, L = args.batch, args.read_len
    # real mates (same fragment): two independent read streams gave every
    # pair a unique union-signature — the degenerate accumulate-heavy case
    c1, c2, _ = simulate_packed_pairs(rng, seqs, args.batches + 1, B, L)
    cfg = MapConfig(batch_size=B, paired_end=True, probe_stride=args.stride,
                    probe_sample=args.sample,
                    sample_fallback_frac=args.sample_fallback,
                    sig_table_bits=22)
    mapper = Mapper(index, cfg)
    lengths = np.full(B, L, np.int32)
    w = np.ones(B, np.int32)
    batches = [ReadBatch(c1[i], lengths, w, codes2=c2[i], lengths2=lengths)
               for i in range(len(c1))]
    rps = _time_mapper(mapper, batches, B)
    _emit("config2_pairs_per_s_per_chip", rps, "pairs/s",
          {"transcripts": index.num_transcripts,
           "kmers": index.num_kmers, "index_build_s": round(build_s, 1),
           "stride": args.stride, "sample": args.sample})


def config3(args):
    import jax

    from seekmer_tpu.config import MapConfig, ShardConfig
    from seekmer_tpu.io.fastq import ReadBatch
    from seekmer_tpu.map.driver import Mapper
    from seekmer_tpu.parallel.data_parallel import DataParallelMapper
    from seekmer_tpu.utils.simulate import simulate_packed_batches

    D = len(jax.devices())
    rng, index, seqs, _ = _world(args.transcripts)
    B, L = args.batch * D, args.read_len
    codes, _ = simulate_packed_batches(rng, seqs, args.batches + 1, B, L)
    lengths = np.full(B, L, np.int32)
    w = np.ones(B, np.int32)
    batches = [ReadBatch(codes[i], lengths, w) for i in range(len(codes))]

    cfg1 = MapConfig(batch_size=args.batch, probe_stride=args.stride)
    single = Mapper(index, cfg1)
    b1 = [ReadBatch(codes[i][: args.batch], lengths[: args.batch],
                    w[: args.batch]) for i in range(len(codes))]
    rps1 = _time_mapper(single, b1, args.batch)

    cfgD = MapConfig(batch_size=B, probe_stride=args.stride)
    dp = DataParallelMapper(index, cfgD, ShardConfig(data_axis=D))
    rpsD = _time_mapper(dp, batches, B)
    eff = rpsD / (rps1 * D)
    _emit("config3_scaling_efficiency", eff, "fraction",
          {"devices": D, "reads_per_s_1": round(rps1), "reads_per_s_D": round(rpsD),
           "platform": jax.devices()[0].platform})


def config4(args):
    import jax

    from seekmer_tpu.config import MapConfig, ShardConfig
    from seekmer_tpu.io.fastq import ReadBatch
    from seekmer_tpu.parallel.mesh import make_mesh
    from seekmer_tpu.parallel.prefix_shard import PrefixShardedMapper
    from seekmer_tpu.utils.simulate import simulate_packed_batches

    from seekmer_tpu.utils.simulate import simulate_packed_pairs

    D = len(jax.devices())
    rng, index, seqs, _ = _world(args.transcripts)
    B, L = args.batch * D, args.read_len
    shard_cfg = ShardConfig(data_axis=1, index_axis=D, index_mode="prefix")
    ps = PrefixShardedMapper(index, MapConfig(batch_size=B,
                                              probe_stride=1),
                             shard_cfg, mesh=make_mesh(shard_cfg))
    lengths = np.full(B, L, np.int32)
    w = np.ones(B, np.int32)
    if args.paired:
        c1, c2, _ = simulate_packed_pairs(rng, seqs, args.batches + 1, B, L)
        batches = [ReadBatch(c1[i], lengths, w, codes2=c2[i],
                             lengths2=lengths) for i in range(len(c1))]
    else:
        codes, _ = simulate_packed_batches(rng, seqs, args.batches + 1, B, L)
        batches = [ReadBatch(codes[i], lengths, w)
                   for i in range(len(codes))]
    rps = _time_mapper(ps, batches, B)
    _emit("config4_sharded_reads_per_s", rps, "reads/s",
          {"index_shards": D, "paired": bool(args.paired),
           "extra_routing_rounds": ps.extra_routing_rounds,
           "platform": jax.devices()[0].platform})


def config5(args):
    import jax

    from seekmer_tpu.config import EMConfig, MapConfig
    from seekmer_tpu.em import bootstrap as bs
    from seekmer_tpu.em.em import build_ec_table
    from seekmer_tpu.io.fastq import ReadBatch
    from seekmer_tpu.map.driver import Mapper, resolve_signatures
    from seekmer_tpu.utils.simulate import simulate_packed_batches

    rng, index, seqs, _ = _world(args.transcripts)
    B, L = args.batch, args.read_len
    codes, _ = simulate_packed_batches(rng, seqs, 2, B, L)
    mapper = Mapper(index, MapConfig(batch_size=B))
    for i in range(2):
        mapper.feed(ReadBatch(codes[i], np.full(B, L, np.int32),
                              np.ones(B, np.int32)))
    members, counts, _ = resolve_signatures(mapper.finalize(), index)
    ec = build_ec_table(members, counts, index.num_transcripts)

    cfg = EMConfig(bootstrap_samples=100, bootstrap_seed=1)
    boot = bs.run_bootstrap(ec, index.lengths, cfg)  # warm/compile
    jax.block_until_ready(boot)
    t0 = time.perf_counter()
    boot = bs.run_bootstrap(ec, index.lengths,
                            EMConfig(bootstrap_samples=100, bootstrap_seed=2))
    jax.block_until_ready(boot)
    dt = time.perf_counter() - t0
    _emit("config5_bootstrap_replicates_per_s", 100 / dt, "replicates/s",
          {"transcripts": index.num_transcripts, "ecs": len(members),
           "platform": jax.devices()[0].platform})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("config", type=int, choices=[1, 2, 3, 4, 5])
    ap.add_argument("--transcripts", type=int, default=None)
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--sample", type=int, default=0,
                    help="two-phase fast mode sampling stride "
                         "(MapConfig.probe_sample; configs 1/2)")
    ap.add_argument("--sample-fallback", type=float, default=0.125,
                    help="fast-mode phase-2 cap fraction "
                         "(MapConfig.sample_fallback_frac)")
    ap.add_argument("--paired", action="store_true",
                    help="config 4: route read PAIRS (mates' windows "
                         "through one all_to_all dispatch)")
    args = ap.parse_args()
    if args.transcripts is None:
        args.transcripts = {1: 1000, 2: 60000, 3: 1000, 4: 1000, 5: 1000}[
            args.config]
    [None, config1, config2, config3, config4, config5][args.config](args)


if __name__ == "__main__":
    main()
