"""Command-line interface (reference: seekmer __main__.py's argparse
subcommands `index` / `infer`, SURVEY.md 2.1 C1 and section 1 L5)."""

from __future__ import annotations

import argparse
import logging
import sys
import time

import numpy as np


def _common(p):
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _add_index(sub):
    p = _common(sub.add_parser(
        "index", help="build a k-mer index from a transcriptome"))
    p.add_argument("fasta", help="transcriptome FASTA (.fa/.fa.gz)")
    p.add_argument("output", help="output index file (.npz)")
    p.add_argument("--gtf", default=None, help="GTF for transcript->gene map")
    p.add_argument("--kmer-length", type=int, default=25)
    p.add_argument("--load-factor", type=float, default=0.5)
    return p


def _add_infer(sub):
    p = _common(sub.add_parser("infer", help="quantify reads against an index"))
    p.add_argument("index", help="index file from `index`")
    p.add_argument("output_dir", help="output directory")
    p.add_argument("fastq", nargs="+", help="FASTQ(.gz) files")
    p.add_argument("--mates", nargs="*", default=None,
                   help="mate-2 FASTQ files (paired-end)")
    p.add_argument("--batch-size", type=int, default=65536)
    p.add_argument("--max-ecs-per-read", type=int, default=16)
    p.add_argument("--sig-table-bits", type=int, default=20)
    p.add_argument("--fragment-length", type=float, default=None,
                   help="fragment-length mean (default: estimated from "
                        "mapped pairs for paired-end runs, else 200)")
    p.add_argument("--fragment-sd", type=float, default=None,
                   help="fragment-length sd; > 0 switches the effective-"
                        "length model to the truncated-normal FLD "
                        "expectation (default: estimated from mapped "
                        "pairs for paired-end runs, else 0)")
    p.add_argument("--em-tolerance", type=float, default=1e-4)
    p.add_argument("--em-max-iters", type=int, default=10000)
    p.add_argument("--em-accel", choices=("none", "squarem"), default="none",
                   help="fixed-point acceleration (SQUAREM: same fixed "
                        "points, typically 3-10x fewer EM steps)")
    p.add_argument("--bootstrap", type=int, default=0,
                   help="number of bootstrap replicates")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--x64", action="store_true",
                   help="float64 EM (bit-parity with the float64 oracle)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file for batch-granular resume")
    p.add_argument("--checkpoint-every", type=int, default=50,
                   help="batches between checkpoints")
    p.add_argument("--trace-dir", default=None,
                   help="write a jax.profiler trace of the run here")
    p.add_argument("--data-shards", type=int, default=1,
                   help="data-parallel mesh axis size (config 3)")
    p.add_argument("--index-shards", type=int, default=1,
                   help="prefix-shard the index over this many devices "
                        "(config 4)")
    p.add_argument("--probe-stride", type=int, default=1,
                   help="probe every Nth window with run-length coverage "
                        "(1 = bit-exact dense)")
    p.add_argument("--probe-sample", type=int, default=0,
                   help="FAST mode: sample every Nth window; one-EC reads "
                        "resolve early, ambiguous reads re-probe densely "
                        "(opt-in approximation — see MapConfig."
                        "probe_sample; 0 = exact dense)")
    p.add_argument("--sample-fallback", type=float, default=0.0,
                   help="fast-mode phase-2 cap fraction (MapConfig."
                        "sample_fallback_frac; 0 = auto-size from the "
                        "first batch's observed fallback fraction)")
    p.add_argument("--io-workers", type=int, default=0,
                   help="concurrent FASTQ decode threads (0 = auto, "
                        "1 = serial; forced serial with --checkpoint)")
    p.add_argument("--probe-chunks", type=int, default=0,
                   help="probe lanes in N sequential chunks (bounds device "
                        "memory transients for very large batches; "
                        "0 = auto)")
    p.add_argument("--no-h2d-pack", action="store_true",
                   help="disable 2-bit host->device code packing "
                        "(MapConfig.h2d_pack_2bit; on by default for the "
                        "single-chip mapper)")
    p.add_argument("--distributed", action="store_true",
                   help="initialize the multi-host process group "
                        "(jax.distributed; set JAX_COORDINATOR_ADDRESS etc.)")
    p.add_argument("--pack-cache", nargs="?", const="auto", default=None,
                   metavar="DIR",
                   help="pre-packed 2-bit shard cache: first run writes "
                        "packed bucketed batches next to the FASTQ "
                        "(default DIR: <first fastq>.smpack), re-runs "
                        "mmap them and skip decode/parse/pack entirely "
                        "(single-chip mapper only)")
    return p


def _add_fuse(sub):
    p = _common(sub.add_parser(
        "fuse", help="call fusion-transcript candidates from discordant "
                     "read pairs (reference fusion.py, SURVEY.md C12)"))
    p.add_argument("index", help="index file from `index`")
    p.add_argument("output_dir", help="output directory")
    p.add_argument("fastq", nargs="+", help="mate-1 FASTQ(.gz) files")
    p.add_argument("--mates", nargs="+", required=True,
                   help="mate-2 FASTQ(.gz) files")
    p.add_argument("--batch-size", type=int, default=65536)
    p.add_argument("--max-ecs-per-read", type=int, default=16)
    p.add_argument("--sig-table-bits", type=int, default=20)
    p.add_argument("--min-count", type=int, default=2,
                   help="minimum supporting pairs per candidate")
    return p


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="seekmer_tpu",
        description="RNA-seq quantification on an accelerator "
        "(k-mer pseudoalignment + EM)",
    )
    from . import __version__

    ap.add_argument("--version", action="version",
                    version=f"seekmer_tpu {__version__}")
    _common(ap)
    sub = ap.add_subparsers(dest="command", required=True)
    _add_index(sub)
    _add_infer(sub)
    _add_fuse(sub)
    return ap


def cmd_index(args) -> int:
    from .config import IndexConfig
    from .index.build import build_index

    cfg = IndexConfig(k=args.kmer_length, load_factor=args.load_factor)
    t0 = time.perf_counter()
    index = build_index(args.fasta, gtf_path=args.gtf, cfg=cfg)
    index.save(args.output)
    logging.info(
        "indexed %d transcripts / %d k-mers / %d ECs in %.1fs -> %s",
        index.num_transcripts, index.num_kmers, index.num_ecs,
        time.perf_counter() - t0, args.output,
    )
    return 0


def cmd_infer(args) -> int:
    import os

    from .config import EMConfig, MapConfig, PipelineConfig, ShardConfig
    from .index.store import KMerIndex
    from .io.writer import write_abundance, write_bootstrap, write_run_info
    from .models.quantifier import Quantifier

    if args.distributed:
        from .parallel.mesh import init_distributed

        init_distributed()
    start_time = time.strftime("%Y-%m-%dT%H:%M:%S")
    t0 = time.perf_counter()
    index = KMerIndex.load(args.index)
    index_load_s = time.perf_counter() - t0
    cfg = PipelineConfig().replace(
        map=MapConfig(
            batch_size=args.batch_size,
            max_ecs_per_read=args.max_ecs_per_read,
            sig_table_bits=args.sig_table_bits,
            paired_end=bool(args.mates),
            probe_stride=args.probe_stride,
            probe_sample=args.probe_sample,
            sample_fallback_frac=args.sample_fallback,
            probe_chunks=args.probe_chunks,
            io_workers=args.io_workers,
            h2d_pack_2bit=not args.no_h2d_pack,
        ),
        em=EMConfig(
            # explicit FLD flags override data-driven estimation
            mean_fragment_length=(200.0 if args.fragment_length is None
                                  else args.fragment_length),
            fragment_length_sd=(0.0 if args.fragment_sd is None
                                else args.fragment_sd),
            estimate_fld=(args.fragment_length is None
                          and args.fragment_sd is None),
            rel_tol=args.em_tolerance,
            max_iters=args.em_max_iters,
            accel=args.em_accel,
            bootstrap_samples=args.bootstrap,
            bootstrap_seed=args.seed,
            use_x64=args.x64,
        ),
        shard=ShardConfig(
            data_axis=args.data_shards,
            index_axis=args.index_shards,
            index_mode="prefix" if args.index_shards > 1 else "replicated",
        ),
    )
    from .utils.profiling import maybe_trace

    q = Quantifier(index, cfg)
    with maybe_trace(args.trace_dir, "infer"):
        result = q.quantify_files(args.fastq, mate_paths=args.mates or None,
                                  checkpoint_path=args.checkpoint,
                                  checkpoint_every=args.checkpoint_every,
                                  pack_cache=args.pack_cache)

    os.makedirs(args.output_dir, exist_ok=True)
    out = os.path.join(args.output_dir, "abundance.tsv")
    write_abundance(out, result.names, result.lengths, result.eff_length,
                    result.est_counts, result.tpm)
    from .io.writer import write_h5

    if not write_h5(os.path.join(args.output_dir, "abundance.h5"),
                    result.names, result.lengths, result.eff_length,
                    result.est_counts, boot_counts=result.bootstrap_counts,
                    run_info={"total_reads": result.total_reads,
                              "call": " ".join(sys.argv),
                              "start_time": start_time}):
        logging.warning("h5py not installed; abundance.h5 not written "
                        "(sleuth consumers need the HDF5 output)")
    if result.bootstrap_counts is not None:
        write_bootstrap(os.path.join(args.output_dir, "bootstrap.npz"),
                        result.names, result.bootstrap_counts)
    if index.genes is not None:
        from .io.writer import write_gene_abundance

        write_gene_abundance(
            os.path.join(args.output_dir, "abundance.genes.tsv"),
            index.genes, result.est_counts, result.tpm)
    write_run_info(
        os.path.join(args.output_dir, "run_info.json"),
        {
            "total_reads": result.total_reads,
            "mapped": result.mapped,
            "unmapped": result.unmapped,
            "p_mapped": result.mapped / max(result.total_reads, 1),
            "em_iterations": result.em_iterations,
            "log_likelihood": result.log_likelihood,
            "fld": (None if result.fld_mean is None else
                    {"mean": result.fld_mean, "sd": result.fld_sd,
                     "samples": result.fld_samples}),
            "bootstrap_samples": args.bootstrap,
            # auditability: record whether this run used the fast mode's
            # documented approximation (0 = dense/exact)
            "probe_sample": args.probe_sample,
            "start_time": start_time,
            "timings": {"index_load_s": index_load_s, **result.timings},
            "index": args.index,
            "n_targets": int(index.num_transcripts),
        },
    )
    logging.info("wrote %s (%d/%d reads mapped, %d EM iters)",
                 out, result.mapped, result.total_reads,
                 result.em_iterations)
    return 0


def cmd_fuse(args) -> int:
    import os

    from .config import MapConfig
    from .fusion import detect_fusions_files
    from .index.store import KMerIndex
    from .io.writer import write_fusions, write_run_info

    index = KMerIndex.load(args.index)
    cfg = MapConfig(batch_size=args.batch_size,
                    max_ecs_per_read=args.max_ecs_per_read,
                    sig_table_bits=args.sig_table_bits)
    report = detect_fusions_files(index, args.fastq, args.mates, cfg=cfg,
                                  min_count=args.min_count)
    os.makedirs(args.output_dir, exist_ok=True)
    out = os.path.join(args.output_dir, "fusions.tsv")
    write_fusions(out, report)
    write_run_info(
        os.path.join(args.output_dir, "run_info.json"),
        {
            "pairs_total": report.pairs_total,
            "candidates": len(report.candidates),
            "split_reads": report.split_reads,
            "concordant": report.concordant,
            "same_gene_discordant": report.same_gene_discordant,
            "ambiguous": report.ambiguous,
            "unresolved": report.unresolved,
            "min_count": args.min_count,
            "index": args.index,
        },
    )
    logging.info("wrote %s (%d candidates)", out, len(report.candidates))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s",
    )
    np.set_printoptions(precision=4, suppress=True)
    if args.command == "index":
        return cmd_index(args)
    if args.command == "infer":
        return cmd_infer(args)
    if args.command == "fuse":
        return cmd_fuse(args)
    raise AssertionError(args.command)


if __name__ == "__main__":
    sys.exit(main())
