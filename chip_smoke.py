#!/usr/bin/env python
"""On-card smoke run of the main path: index -> map -> EM -> bootstrap,
driven through the CLI (``seekmer_tpu.cli.main``) in this one process.

  python chip_smoke.py               one GPU: phases 1-3
  python chip_smoke.py --four-cards  four GPUs: phase 4 only

1. Device: requires JAX's GPU backend; prints the card's name and power
   limit, device_kind, jax/jaxlib versions, and whether the native C
   ingest library loaded.
2. Config-1 exactness: 1,000 random transcripts (300-3,000 bp, half
   sharing prefixes), 200k single-end 100 bp reads. ``index``, then
   ``infer --x64`` against the float64 oracle (tests/oracle): signature
   counts identical, est_counts within rtol 1e-6; then ``infer`` in
   float32 at the pipeline tests' tolerance.
3. GENCODE-scale paired run: an isoform transcriptome of 20,000 genes
   (~60k transcripts, ~27M k-mers), its index built by ``index`` once and
   cached in .smoke_cache/, 1M read pairs (2x100 bp, mates from one
   fragment). ``infer --mates --bootstrap 100`` dense, then with
   ``--probe-sample 16``. Per-pair signatures of a 20k-pair sample agree
   with the oracle; est_counts and every bootstrap replicate sum to the
   mapped pair count.
4. ``--four-cards``: the phase-3 world and reads through
   ``--data-shards 4`` (with the sharded 100-replicate bootstrap) and
   ``--index-shards 4``, each compared with the one-card run in this
   process: signature counts of a 20k-pair sample, mapped pairs and
   est_counts.

Times printed are first readings on the card, not a benchmark. Any failed
check raises, and the process exits non-zero without the final JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import zlib

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(REPO, ".smoke_cache")


def say(*a):
    print(*a, flush=True)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU comparison (phase 4)")
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--config1-reads", type=int, default=200_000)
    ap.add_argument("--genes", type=int, default=20_000)
    ap.add_argument("--pairs", type=int, default=1_000_000)
    ap.add_argument("--sample-pairs", type=int, default=20_000)
    ap.add_argument("--bootstrap", type=int, default=100)
    ap.add_argument("--workdir", default=os.path.join(CACHE, "run"))
    return ap.parse_args(argv)


# ---------------------------------------------------------------- helpers

def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)
    say(f"  ok: {what}")


def write_fastq_gz(path: str, codes: np.ndarray, prefix: str) -> None:
    """uint8 code rows (0-3 = ACGT, 4 = N) -> gzipped FASTQ."""
    lut = np.frombuffer(b"ACGTN", np.uint8)
    comp = zlib.compressobj(1, zlib.DEFLATED, 31)  # gzip container
    qual = "I" * codes.shape[1]
    with open(path, "wb") as fh:
        for lo in range(0, codes.shape[0], 65536):
            rows = lut[codes[lo:lo + 65536]]
            text = "".join(
                f"@{prefix}{lo + i}\n{r.tobytes().decode()}\n+\n{qual}\n"
                for i, r in enumerate(rows))
            fh.write(comp.compress(text.encode()))
        fh.write(comp.flush())


def cli(*argv) -> float:
    from seekmer_tpu.cli import main

    t0 = time.perf_counter()
    rc = main([str(a) for a in argv])
    check(rc == 0, f"seekmer_tpu {argv[0]} exited {rc}")
    return time.perf_counter() - t0


def load_run(outdir: str) -> dict:
    from seekmer_tpu.io.writer import read_abundance

    with open(os.path.join(outdir, "run_info.json")) as fh:
        info = json.load(fh)
    ab = read_abundance(os.path.join(outdir, "abundance.tsv"))
    boot = None
    if os.path.exists(os.path.join(outdir, "bootstrap.npz")):
        boot = np.load(os.path.join(outdir, "bootstrap.npz"))["est_counts"]
    return {"info": info, "est_counts": ab["est_counts"],
            "tpm": ab["tpm"], "boot": boot}


def sig_dict(result) -> dict:
    from seekmer_tpu.map.signature import SIG_PAD

    return {tuple(r[r != int(SIG_PAD)].tolist()): int(n)
            for r, n in zip(result.sigs, result.sig_counts)}


def map_with(mapper, codes1, codes2, batch: int):
    from seekmer_tpu.io.fastq import ReadBatch

    n, L = codes1.shape
    for lo in range(0, n, batch):
        c1 = codes1[lo:lo + batch]
        m = c1.shape[0]
        pad = batch - m
        pad_rows = lambda c: np.pad(c, ((0, pad), (0, 0)), constant_values=4)
        lengths = np.full(batch, L, np.int32)
        weights = (np.arange(batch) < m).astype(np.int32)
        mapper.feed(ReadBatch(
            pad_rows(c1), lengths, weights,
            codes2=None if codes2 is None else pad_rows(codes2[lo:lo + m]),
            lengths2=None if codes2 is None else lengths))
    return mapper.finalize()


def oracle_kdict(index, key_lists):
    """tests/oracle's k-mer dict, restricted to the keys that occur in
    ``key_lists``: identical answers for those keys, without a Python
    dict of every k-mer of a GENCODE-scale index."""
    from seekmer_tpu import encoding as enc
    from tests.oracle import oracle

    want = np.unique(np.concatenate(key_lists))

    def rows(table):
        occ = table[:, 0] >= 0
        keys = enc.join_key(table[occ, 0], table[occ, 1], index.k)
        return table[occ][np.isin(keys, want)]

    sub = argparse.Namespace(table=rows(index.table), stash=rows(index.stash),
                             k=index.k)
    return oracle.build_kmer_dict(sub)


def device_info() -> dict:
    import jax
    import jaxlib

    from seekmer_tpu.native.packer import get_lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    say(card)
    d = jax.devices()[0]
    say(f"device_kind: {d.device_kind} ({len(jax.devices())} device(s))")
    say(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    native = get_lib() is not None
    say(f"native C ingest library loaded: {native}")
    return {"card": card, "kind": d.device_kind, "native": native}


def peak_bytes() -> int:
    import jax

    return max(int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
               for d in jax.local_devices())


# ------------------------------------------------------- phase 2: config 1

def phase_config1(args) -> None:
    from seekmer_tpu.config import EMConfig, MapConfig
    from seekmer_tpu.index.store import KMerIndex
    from seekmer_tpu.io.fastq import batch_reads_native
    from seekmer_tpu.map.driver import Mapper
    from seekmer_tpu.utils.simulate import (random_transcriptome,
                                            simulate_packed_batches,
                                            write_fasta)
    from tests.oracle import oracle

    say("== phase 2: config-1 exactness (single-end, 1,000 transcripts)")
    wd = os.path.join(args.workdir, "config1")
    os.makedirs(wd, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    names, seqs = random_transcriptome(rng, num_transcripts=1000,
                                       min_len=300, max_len=3000,
                                       shared_prefix_frac=0.5)
    fa, idx, fq = (os.path.join(wd, f) for f in
                   ("ref.fa", "index.npz", "reads.fq.gz"))
    write_fasta(fa, names, seqs)
    n = args.config1_reads
    codes, _ = simulate_packed_batches(rng, seqs, 1, n, read_len=100,
                                       error_rate=0.005)
    codes = codes[0]
    write_fastq_gz(fq, codes, "r")
    say(f"  index: {cli('index', fa, idx):.1f} s")
    index = KMerIndex.load(idx)

    # the float64 oracle on the same reads, with the CLI's EM settings
    em_cfg = EMConfig(rel_tol=1e-4, max_iters=10000)
    map_cfg = MapConfig()
    lut = np.frombuffer(b"ACGTN", np.uint8)
    reads = [r.tobytes().decode() for r in lut[codes]]
    t0 = time.perf_counter()
    o = oracle.quantify(reads, index, map_cfg, em_cfg)
    say(f"  oracle (float64, host): {time.perf_counter() - t0:.1f} s, "
        f"{o['em_iterations']} EM iterations")

    # signature counts of the mapper the CLI uses, on the CLI's ingest
    res = Mapper(index, map_cfg).run(batch_reads_native([fq], map_cfg))
    check(sig_dict(res) == dict(o["sig_counts"]),
          f"device signature counts == oracle "
          f"({len(o['sig_counts'])} signatures, {res.mapped} reads mapped)")

    out64, out32 = os.path.join(wd, "out_x64"), os.path.join(wd, "out_f32")
    import jax

    say(f"  infer --x64: {cli('infer', idx, out64, fq, '--x64'):.1f} s")
    jax.config.update("jax_enable_x64", False)  # --x64 set it process-wide
    r64 = load_run(out64)
    check(r64["info"]["unmapped"] == o["unmapped"],
          f"unmapped reads == oracle ({o['unmapped']})")
    check(r64["info"]["em_iterations"] == o["em_iterations"],
          f"EM iterations == oracle ({o['em_iterations']})")
    # abundance.tsv holds 6 significant digits: a written value passes if
    # it is how some number within rtol 1e-6 of the oracle's is written
    ok = [f"{d:.6g}" in {f"{x * (1 + e):.6g}" for e in (-1e-6, 0, 1e-6)}
          for d, x in zip(r64["est_counts"], o["est_counts"])]
    check(all(ok), f"x64 est_counts within rtol 1e-6 of the oracle, as "
                   f"written ({len(ok) - sum(ok)} of {len(ok)} differ)")

    say(f"  infer (float32): {cli('infer', idx, out32, fq):.1f} s")
    r32 = load_run(out32)
    np.testing.assert_allclose(r32["est_counts"], o["est_counts"],
                               rtol=5e-3, atol=5e-2)
    say("  ok: float32 est_counts within rtol 5e-3, atol 5e-2 of the oracle")
    tpm_err = float(np.abs(r32["tpm"] - o["tpm"]).max())
    say(f"  float32 TPM max-abs error vs oracle: {tpm_err:.4g}")


# ---------------------------------------------- phase 3: GENCODE, paired

@dataclasses.dataclass
class World:
    index_path: str
    r1: str
    r2: str
    codes1: np.ndarray  # the first sample_pairs pairs, for the oracle
    codes2: np.ndarray


def gencode_world(args) -> World:
    from seekmer_tpu.utils.simulate import (isoform_transcriptome,
                                            simulate_packed_pairs,
                                            write_fasta)

    rng = np.random.default_rng(args.seed + 1)
    t0 = time.perf_counter()
    names, seqs, genes = isoform_transcriptome(rng, num_genes=args.genes)
    say(f"  transcriptome: {len(seqs)} transcripts, "
        f"{sum(map(len, seqs)) / 1e6:.1f} Mbp "
        f"({time.perf_counter() - t0:.1f} s)")
    key = f"iso{args.genes}_seed{args.seed + 1}_k25_lf0.5"
    idx_dir = os.path.join(CACHE, "index", key)
    idx = os.path.join(idx_dir, "index.npz")
    if os.path.exists(idx):
        say(f"  index: cached ({idx})")
    else:
        os.makedirs(idx_dir, exist_ok=True)
        fa = os.path.join(idx_dir, "ref.fa")
        write_fasta(fa, names, seqs)
        tmp = os.path.join(idx_dir, "index.tmp.npz")
        say(f"  index: built in {cli('index', fa, tmp):.1f} s")
        os.replace(tmp, idx)
        os.remove(fa)

    wd = os.path.join(args.workdir, "gencode")
    os.makedirs(wd, exist_ok=True)
    t0 = time.perf_counter()
    c1, c2, _ = simulate_packed_pairs(rng, seqs, 1, args.pairs, read_len=100,
                                      mean_frag=250.0, sd_frag=30.0,
                                      error_rate=0.005)
    r1, r2 = os.path.join(wd, "r1.fq.gz"), os.path.join(wd, "r2.fq.gz")
    write_fastq_gz(r1, c1[0], "p")
    write_fastq_gz(r2, c2[0], "p")
    say(f"  {args.pairs} pairs simulated and written "
        f"({time.perf_counter() - t0:.1f} s)")
    s = args.sample_pairs
    return World(idx, r1, r2, c1[0][:s].copy(), c2[0][:s].copy())


def check_sample_against_oracle(world: World, index) -> None:
    """Per-pair signatures of the device lookup path vs the oracle on the
    sample pairs."""
    import jax
    import jax.numpy as jnp

    from seekmer_tpu import encoding as enc
    from seekmer_tpu.config import MapConfig
    from seekmer_tpu.map.driver import DeviceIndex
    from seekmer_tpu.map.signature import SIG_PAD, read_signatures
    from seekmer_tpu.ops.kmer_pack import pack_canonical
    from seekmer_tpu.ops.probe import lookup_ecs
    from tests.oracle import oracle

    C = MapConfig().max_ecs_per_read
    di = DeviceIndex.from_host(index)

    @jax.jit
    def pair_sigs(di, c1, c2):
        ln = jnp.full(c1.shape[0], c1.shape[1], jnp.int32)
        h1, l1, v1 = pack_canonical(c1, ln, di.k)
        h2, l2, v2 = pack_canonical(c2, ln, di.k)
        h, l, v = (jnp.concatenate(x, axis=1)
                   for x in ((h1, h2), (l1, l2), (v1, v2)))
        ecs = lookup_ecs(h, l, v, di.table, di.main_slots, di.stash,
                         di.stash_slots, di.bucket)
        return read_signatures(ecs, v, C)

    sig, mapped = (np.asarray(x) for x in
                   pair_sigs(di, jnp.asarray(world.codes1),
                             jnp.asarray(world.codes2)))
    keys = [enc.canonical_kmers(c, index.k)[0]
            for c in (*world.codes1, *world.codes2)]
    kdict = oracle_kdict(index, keys)
    o_sigs = set()
    n_mapped = bad = 0
    for i, (a, b) in enumerate(zip(world.codes1, world.codes2)):
        ecs = (oracle.map_read(a, kdict, index.k)
               | oracle.map_read(b, kdict, index.k))
        o_mapped = bool(ecs) and len(ecs) <= C
        if o_mapped:
            n_mapped += 1
            o_sigs.add(tuple(sorted(ecs)))
        d = tuple(x for x in sig[i].tolist() if x != int(SIG_PAD))
        bad += (o_mapped != bool(mapped[i])
                or (o_mapped and d != tuple(sorted(ecs))))
    check(bad == 0, f"per-pair signatures == oracle on "
                    f"{len(world.codes1)} pairs ({n_mapped} mapped, "
                    f"{len(o_sigs)} distinct)")


def check_run(r: dict, B: int, label: str) -> None:
    mapped = r["info"]["mapped"]
    est = r["est_counts"]
    check(bool(np.isfinite(est).all()), f"{label}: est_counts finite")
    check(abs(est.sum() - mapped) <= 1e-4 * mapped,
          f"{label}: est_counts sum {est.sum():.1f} == mapped pairs "
          f"{mapped} (rtol 1e-4)")
    if not B:
        return
    boot = r["boot"]
    check(boot is not None and boot.shape == (B, est.shape[0])
          and bool(np.isfinite(boot).all()),
          f"{label}: bootstrap.npz is ({B}, {est.shape[0]}) and finite")
    sums = boot.sum(axis=1)
    check(bool(np.all(np.abs(sums - mapped) <= 1e-4 * mapped)),
          f"{label}: every replicate sums to the mapped pairs (rtol 1e-4; "
          f"range {sums.min():.1f}..{sums.max():.1f})")


def stage_line(label: str, r: dict, wall: float) -> None:
    t = r["info"]["timings"]
    pairs = r["info"]["total_reads"]
    say(f"  {label}: wall {wall:.1f} s | index load {t['index_load_s']:.2f}"
        f" s | map {t['map_s']:.2f} s ({pairs / t['map_s']:,.0f} pairs/s)"
        f" | resolve {t['resolve_s']:.2f} s | EM {t['em_s']:.2f} s "
        f"({r['info']['em_iterations']} it) | bootstrap "
        f"{t.get('bootstrap_s', 0.0):.2f} s")


def phase_gencode(args) -> None:
    from seekmer_tpu.index.store import KMerIndex

    say("== phase 3: GENCODE-scale paired run (first H100 readings, "
        "not a benchmark)")
    world = gencode_world(args)
    index = KMerIndex.load(world.index_path)
    say(f"  index: {index.num_transcripts} transcripts, {index.num_kmers} "
        f"k-mers, {index.num_ecs} ECs, table {index.table.nbytes / 2**30:.2f}"
        f" GiB")
    check_sample_against_oracle(world, index)

    wd = os.path.join(args.workdir, "gencode")
    B = args.bootstrap
    runs = {}
    for label, extra in (("dense", []), ("fast", ["--probe-sample", "16"])):
        out = os.path.join(wd, f"out_{label}")
        wall = cli("infer", world.index_path, out, world.r1, "--mates",
                   world.r2, "--bootstrap", B, *extra)
        runs[label] = load_run(out)
        stage_line(label, runs[label], wall)
        check_run(runs[label], B, label)
    d, f = runs["dense"], runs["fast"]
    say(f"  fast vs dense: mapped pairs {f['info']['mapped']} vs "
        f"{d['info']['mapped']} (delta "
        f"{f['info']['mapped'] - d['info']['mapped']:+d}); est_counts L1 "
        f"{np.abs(f['est_counts'] - d['est_counts']).sum():.1f} of "
        f"{d['est_counts'].sum():.1f}")
    say(f"  peak device memory: {peak_bytes() / 2**30:.2f} GiB")


# --------------------------------------------- phase 4: four cards

def phase_four_cards(args) -> None:
    import jax

    from seekmer_tpu.config import MapConfig, ShardConfig
    from seekmer_tpu.index.store import KMerIndex
    from seekmer_tpu.map.driver import Mapper
    from seekmer_tpu.parallel.data_parallel import DataParallelMapper
    from seekmer_tpu.parallel.prefix_shard import PrefixShardedMapper

    n = len(jax.devices())
    check(n == 4, f"four GPUs visible (found {n})")
    say("== phase 4: four cards vs one, GENCODE-scale paired")
    world = gencode_world(args)
    index = KMerIndex.load(world.index_path)

    # signature counts of the three mappers the CLI picks between, on the
    # sample pairs (phase 3 checks the one-card mapper against the oracle)
    cfg = MapConfig(paired_end=True, batch_size=4096)
    mappers = {
        "one card": Mapper(index, cfg),
        "--data-shards 4": DataParallelMapper(
            index, cfg, ShardConfig(data_axis=4)),
        "--index-shards 4": PrefixShardedMapper(
            index, cfg, ShardConfig(index_axis=4, index_mode="prefix")),
    }
    sigs = {label: sig_dict(map_with(m, world.codes1, world.codes2, 4096))
            for label, m in mappers.items()}
    for label in ("--data-shards 4", "--index-shards 4"):
        check(sigs[label] == sigs["one card"],
              f"{label}: sample signature counts == one card "
              f"({len(sigs[label])} signatures)")

    wd = os.path.join(args.workdir, "four")
    runs = {}
    # a fixed fragment-length model: the prefix-sharded mapper estimates
    # it from one index shard's k-mers, a different (by design) sample,
    # which would make EM's input differ from the other two runs
    fld = ["--fragment-length", 250, "--fragment-sd", 30]
    # only --data-shards shards the bootstrap; the other two runs take
    # the one-card bootstrap path that phase 3 checks
    for label, extra, B in (
            ("one card", [], 0),
            ("--data-shards 4", ["--data-shards", 4], args.bootstrap),
            ("--index-shards 4", ["--index-shards", 4], 0)):
        out = os.path.join(wd, label.strip("-").replace(" ", "_"))
        wall = cli("infer", world.index_path, out, world.r1, "--mates",
                   world.r2, "--bootstrap", B, *fld, *extra)
        runs[label] = load_run(out)
        stage_line(label, runs[label], wall)
        check_run(runs[label], B, label)
    one = runs["one card"]
    for label in ("--data-shards 4", "--index-shards 4"):
        r = runs[label]
        check(r["info"]["mapped"] == one["info"]["mapped"],
              f"{label}: mapped pairs == one card ({r['info']['mapped']})")
        np.testing.assert_allclose(r["est_counts"], one["est_counts"],
                                   rtol=5e-3, atol=5e-2)
        say(f"  ok: {label}: est_counts within rtol 5e-3, atol 5e-2 of one "
            f"card (max abs diff "
            f"{np.abs(r['est_counts'] - one['est_counts']).max():.3g})")
    say(f"  peak device memory (max over cards): "
        f"{peak_bytes() / 2**30:.2f} GiB")


def run(args) -> None:
    info = device_info()
    if args.four_cards:
        phase_four_cards(args)
    else:
        phase_config1(args)
        phase_gencode(args)
    import jax

    d = jax.devices()
    say(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": info["kind"], "count": len(d)}}))


def main(argv=None) -> int:
    args = parse(argv)
    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU backend (devices: {jax.devices()})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import seekmer_tpu  # noqa: F401  (fails outside a checkout)

    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
