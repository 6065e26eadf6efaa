"""Quantifier: the end-to-end pipeline object (the framework's flagship
"model": index -> pseudoalignment -> EM -> abundance table). Mirrors the
reference's `seekmer infer` call stack (SURVEY.md 3.2) with the device
boundary described there: host ingest -> device map kernel -> device EM.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..config import PipelineConfig
from ..em import bootstrap as em_bootstrap
from ..em.em import build_ec_table, run_em, tpm_from_alpha, effective_lengths
from ..index.store import KMerIndex
from ..io.fastq import ReadBatch, batch_read_pairs, batch_reads
from ..map.driver import Mapper, MapResult, resolve_signatures

log = logging.getLogger(__name__)


@dataclasses.dataclass
class QuantResult:
    est_counts: np.ndarray
    tpm: np.ndarray
    eff_length: np.ndarray
    names: np.ndarray
    lengths: np.ndarray
    total_reads: int
    mapped: int
    unmapped: int
    em_iterations: int
    bootstrap_counts: Optional[np.ndarray] = None  # [B, T]
    timings: Optional[Dict[str, float]] = None
    # fragment-length distribution estimated from mapped pairs (map/fld.py);
    # None when not estimated (single-end, no FLD payload, or too few
    # concordant unique-k-mer pairs)
    fld_mean: Optional[float] = None
    fld_sd: Optional[float] = None
    fld_samples: Optional[int] = None
    # final data log-likelihood (reference progress metric, SURVEY.md 5.5)
    log_likelihood: Optional[float] = None


class Quantifier:
    def __init__(self, index: KMerIndex, cfg: PipelineConfig = PipelineConfig()):
        self.index = index
        self.cfg = cfg
        if cfg.em.use_x64:
            import jax

            jax.config.update("jax_enable_x64", True)

    def quantify_files(
        self,
        fastq_paths: List[str],
        mate_paths: Optional[List[str]] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 50,
        pack_cache: Optional[str] = None,
    ) -> QuantResult:
        mapper = self._make_mapper()
        map_cfg = self.cfg.map
        if pack_cache is not None:
            return self._quantify_pack_cache(
                fastq_paths, mate_paths, checkpoint_path, checkpoint_every,
                pack_cache, mapper)
        if checkpoint_path and getattr(mapper, "supports_checkpoint",
                                       lambda: False)():
            # offset-cursor batching: resume seeks the input files instead
            # of re-decoding them (io/fastq.CheckpointableBatchSource)
            from ..io.fastq import CheckpointableBatchSource

            source = CheckpointableBatchSource(fastq_paths, mate_paths,
                                               map_cfg)
            import jax

            # restore must not raise BEFORE the cross-host agreement below:
            # a step-mismatched/missing sidecar on ONE host (partial copy,
            # divergent filesystems) would raise there while the other
            # hosts proceed into process_allgather and hang (round-3
            # advisor finding). Hold the error, agree, then fail together.
            state, restore_err = None, None
            try:
                state = mapper.restore_checkpoint(checkpoint_path)
            except Exception as e:  # noqa: BLE001 — re-raised below
                if jax.process_count() == 1:
                    raise
                restore_err = e
            if jax.process_count() > 1:
                # resume is all-or-nothing across hosts: the restored
                # TABLE is global, so one host resuming while another
                # starts fresh double-counts that host's reads (and the
                # mappers' state diverges). Requires the checkpoint files
                # on storage visible to every host.
                from jax.experimental import multihost_utils as mhu

                cats = np.asarray(mhu.process_allgather(np.asarray(
                    [state is None and restore_err is None, bool(state),
                     restore_err is not None])))
                if cats[:, 2].any():
                    # every host raises at the same point — no survivor
                    # proceeds into a later collective to deadlock
                    if restore_err is not None:
                        raise restore_err
                    bad = np.nonzero(cats[:, 2])[0].tolist()
                    raise ValueError(
                        f"checkpoint {checkpoint_path} failed to restore "
                        f"on host(s) {bad} (see their logs); delete the "
                        "checkpoint files on every host to start fresh")
                if not cats[:, 1].all():
                    if not cats[:, 0].all():
                        log.warning(
                            "checkpoint %s is not resumable on every "
                            "host; ALL hosts start fresh", checkpoint_path)
                    state = None if cats[:, 0].all() else {}
            if state:
                source.restore(state)
                log.info("resuming from checkpoint: %d reads already "
                         "mapped", mapper.total_reads)
            elif state is not None:
                # file exists but carries no cursor ({}): the restore
                # already loaded its table, which would double-count —
                # rebuild a fresh mapper and start over
                log.warning("checkpoint %s has no stream cursor; starting "
                            "fresh", checkpoint_path)
                mapper = self._make_mapper()
            batches = iter(source)
        else:
            if checkpoint_path:
                log.warning("checkpointing is not supported in this shard "
                            "mode; ignoring --checkpoint")
                checkpoint_path = None
            if mate_paths:
                from ..io.fastq import batch_read_pairs_native

                batches = batch_read_pairs_native(
                    fastq_paths, mate_paths, map_cfg)
            else:
                from ..io.fastq import batch_reads_native

                batches = batch_reads_native(fastq_paths, map_cfg)
        return self.quantify_batches(batches, mapper=mapper,
                                     checkpoint_path=checkpoint_path,
                                     checkpoint_every=checkpoint_every)

    def _quantify_pack_cache(self, fastq_paths, mate_paths, checkpoint_path,
                             checkpoint_every, pack_cache, mapper
                             ) -> QuantResult:
        """--pack-cache run (SURVEY.md 7.5 item 4's pre-packed shard
        cache): a complete cache is mmap'd and fed directly (no decode/
        parse/pack); otherwise this run builds it by teeing the normal
        ingest stream. Cached batches carry resume cursors, so
        --checkpoint works on cached runs; during a build it is disabled
        (build batches have no cursor to resume from)."""
        from ..io.pack_cache import (PackCacheSource, cache_valid,
                                     default_cache_dir, write_through)

        map_cfg = self.cfg.map
        if type(mapper) is not Mapper:
            raise ValueError(
                "--pack-cache requires the single-chip mapper (no "
                "--data-shards/--index-shards): cached batches are "
                "pre-packed for the single-table H2D path")
        if not map_cfg.h2d_pack_2bit:
            raise ValueError("--pack-cache stores 2-bit-packed batches; "
                             "it cannot be combined with --no-h2d-pack")
        cache_dir = (default_cache_dir(fastq_paths) if pack_cache == "auto"
                     else pack_cache)
        if cache_valid(cache_dir, map_cfg, fastq_paths, mate_paths):
            log.info("pack cache hit: %s (skipping decode/parse/pack)",
                     cache_dir)
            source = PackCacheSource(cache_dir, map_cfg)
            if checkpoint_path:
                state = mapper.restore_checkpoint(checkpoint_path)
                if state:
                    source.restore(state)
                    log.info("resuming from checkpoint: %d reads already "
                             "mapped", mapper.total_reads)
                elif state is not None:
                    log.warning("checkpoint %s has no stream cursor; "
                                "starting fresh", checkpoint_path)
                    mapper = self._make_mapper()
            batches = iter(source)
        else:
            if checkpoint_path:
                log.warning(
                    "pack cache at %s is absent or stale: building it this "
                    "run; --checkpoint is disabled during the build "
                    "(re-runs over the completed cache support it)",
                    cache_dir)
                checkpoint_path = None
            if mate_paths:
                from ..io.fastq import batch_read_pairs_native

                raw = batch_read_pairs_native(fastq_paths, mate_paths,
                                              map_cfg)
            else:
                from ..io.fastq import batch_reads_native

                raw = batch_reads_native(fastq_paths, map_cfg)
            batches = write_through(raw, cache_dir, map_cfg, fastq_paths,
                                    mate_paths)
        return self.quantify_batches(batches, mapper=mapper,
                                     checkpoint_path=checkpoint_path,
                                     checkpoint_every=checkpoint_every)

    def quantify_reads(
        self, reads: List[str], mates: Optional[List[str]] = None
    ) -> QuantResult:
        reads_b = [r.encode() if isinstance(r, str) else r for r in reads]
        if mates is not None:
            mates_b = [m.encode() if isinstance(m, str) else m for m in mates]
            batches = batch_read_pairs(zip(reads_b, mates_b), self.cfg.map)
        else:
            batches = batch_reads(reads_b, self.cfg.map)
        return self.quantify_batches(batches)

    def _make_mapper(self):
        """Mapper for the configured parallelism mode (SURVEY.md 2.2):
        single-chip, data-parallel (config 3), or prefix-sharded (config 4)."""
        shard = self.cfg.shard
        if shard.index_mode == "prefix" and shard.index_axis != 1:
            from ..parallel.mesh import make_mesh
            from ..parallel.prefix_shard import PrefixShardedMapper

            self._mesh = make_mesh(shard)
            return PrefixShardedMapper(self.index, self.cfg.map, shard,
                                       mesh=self._mesh)
        if shard.data_axis != 1:
            from ..parallel.data_parallel import DataParallelMapper
            from ..parallel.mesh import make_mesh

            self._mesh = make_mesh(shard)
            return DataParallelMapper(self.index, self.cfg.map, shard,
                                      mesh=self._mesh)
        self._mesh = None
        return Mapper(self.index, self.cfg.map)

    def quantify_batches(self, batches: Iterable[ReadBatch],
                         mapper=None,
                         checkpoint_path: Optional[str] = None,
                         checkpoint_every: int = 50) -> QuantResult:
        from ..utils.metrics import Metrics
        from ..utils.prefetch import device_put_batches, prefetch

        # per-run metrics registry (SURVEY.md 5.5): stage timers + counters
        # emitting the BASELINE metric names (reads_per_s,
        # em_iterations_per_s) into QuantResult.timings -> run_info.json
        self._metrics = Metrics()
        if mapper is None:
            mapper = self._make_mapper()
        # 2-bit H2D packing: single-chip mapper only (the sharded mappers
        # feed per-host slices of unpacked rows)
        pack_2bit = self.cfg.map.h2d_pack_2bit and type(mapper) is Mapper
        batches = prefetch(device_put_batches(batches, pack_2bit=pack_2bit),
                           depth=4)
        t0 = time.perf_counter()
        self._fld_est = None
        if (self.cfg.em.estimate_fld and self.index.fld_tid is not None
                and hasattr(mapper, "make_fld_estimator")):
            batches = self._tee_fld(batches, mapper)
        if checkpoint_path and not getattr(mapper, "supports_checkpoint",
                                           lambda: False)():
            log.warning("checkpointing is not supported for this mapper/"
                        "process configuration; ignoring --checkpoint")
            checkpoint_path = None
        with self._metrics.timer("map"):
            if checkpoint_path:
                result = mapper.run(batches, checkpoint_path=checkpoint_path,
                                    checkpoint_every=checkpoint_every)
            else:
                result = mapper.run(batches)
        self._metrics.count("reads", result.total_reads)
        if result.collisions:
            self._metrics.count("fingerprint_collisions", result.collisions)
        t_map = time.perf_counter() - t0
        log.info(
            "mapped %d/%d reads (%d distinct signatures, %d overflow, "
            "%d fingerprint collisions)",
            result.mapped, result.total_reads, result.sigs.shape[0],
            result.overflow, result.collisions,
        )
        return self._infer(result, t_map, checkpoint_path=checkpoint_path)

    def _tee_fld(self, batches, mapper):
        """Pass batches through while sampling the first paired ones into a
        fragment-length estimator (map/fld.py). The estimator shares the
        mapper's device-resident table; it goes inert (and its payload
        arrays are dropped) after its sampling batches."""
        made = False
        for b in batches:
            if b.codes2 is not None and not made:
                self._fld_est = mapper.make_fld_estimator()
                made = True
            if self._fld_est is not None and self._fld_est.active:
                self._fld_est.feed(b)
            yield b

    def _fld_cfg(self, em_cfg) -> Tuple["EMConfig", Optional[Tuple]]:
        """Apply the estimated FLD (if any) to the effective-length model."""
        fld = getattr(self, "_fld_est", None)
        est = fld.estimate() if fld is not None else None
        if est is None:
            return em_cfg, None
        mean, sd, n = est
        log.info("estimated fragment-length distribution from %d mapped "
                 "pairs: mean %.1f, sd %.1f", n, mean, sd)
        return dataclasses.replace(
            em_cfg, mean_fragment_length=mean, fragment_length_sd=sd), est

    # Minimum seconds between periodic EM/bootstrap snapshot writes: the
    # chunked driver syncs every ~2 s, and writing a GENCODE-scale alpha
    # at every sync would dominate the host loop (round-3 review finding).
    # Convergence pins bypass the throttle.
    SNAPSHOT_MIN_INTERVAL_S = 30.0

    def _throttled_sync(self, path):
        from ..utils.checkpoint import save_em_snapshot

        last = [float("-inf")]

        def on_sync(a, it, converged=False):
            now = time.monotonic()
            if not converged and now - last[0] < self.SNAPSHOT_MIN_INTERVAL_S:
                return
            last[0] = now
            save_em_snapshot(path, a, it, converged=converged)

        return on_sync

    def _broadcast_snapshot(self, arr, it, conv, shape):
        """Agree on process 0's stage snapshot across hosts. Only process
        0 writes snapshots, so without this each host would decide
        resume/skip (and even EM backend) from its own filesystem — a
        guaranteed collective deadlock or cross-process divergence
        (round-3 review finding). Requires the checkpoint path itself
        only on process 0."""
        import jax

        if jax.process_count() == 1:
            return arr, it, conv
        from jax.experimental import multihost_utils as mhu

        meta = np.asarray(mhu.broadcast_one_to_all(np.asarray(
            [arr is not None, it, 1 if conv else 0], np.int64)))
        if not meta[0]:
            return None, 0, False
        payload = (np.asarray(arr, np.float64) if arr is not None
                   else np.zeros(shape, np.float64))
        payload = np.asarray(mhu.broadcast_one_to_all(payload))
        return payload, int(meta[1]), bool(meta[2])

    def _em_snapshots(self, checkpoint_path, T: int):
        """EM/bootstrap-stage snapshot wiring (SURVEY.md 5.3: "EM restarts
        from last alpha snapshot"). Returns (em_snap_path, boot_snap_path,
        alpha_init, it_init, em_converged, on_sync) — snapshots live NEXT
        to the mapping checkpoint so one --checkpoint flag protects every
        stage. Only process 0 writes on multi-process runs. em_converged
        marks a post-convergence pin: resume skips the EM stage entirely
        (exact restart — re-running even one block from the converged
        alpha would drift the output)."""
        if not checkpoint_path:
            return None, None, None, 0, False, None
        import jax

        from ..utils.checkpoint import load_em_snapshot

        em_snap = checkpoint_path + ".em.npz"
        boot_snap = checkpoint_path + ".boot.npz"
        alpha_init, it_init, em_converged = None, 0, False
        loaded = load_em_snapshot(em_snap)
        if loaded is not None:
            a, it, conv = loaded
            if a.ndim == 1 and a.shape[0] == T:
                alpha_init, it_init, em_converged = a, it, conv
                log.info("resuming EM from snapshot at iteration %d%s", it,
                         " (converged: skipping EM)" if conv else "")
            else:
                log.warning("EM snapshot %s has shape %s != (%d,); "
                            "ignoring", em_snap, a.shape, T)
        alpha_init, it_init, em_converged = self._broadcast_snapshot(
            alpha_init, it_init, em_converged, (T,))
        on_sync = None
        if jax.process_index() == 0:
            on_sync = self._throttled_sync(em_snap)
        return em_snap, boot_snap, alpha_init, it_init, em_converged, on_sync

    def _infer(self, result: MapResult, t_map: float,
               checkpoint_path: Optional[str] = None) -> QuantResult:
        import jax.numpy as jnp

        t0 = time.perf_counter()
        member_lists, counts, dropped = resolve_signatures(result, self.index)
        t_resolve = time.perf_counter() - t0

        em_cfg, fld_est = self._fld_cfg(self.cfg.em)
        dtype = jnp.float64 if em_cfg.use_x64 else jnp.float32
        T = self.index.num_transcripts
        ec = build_ec_table(member_lists, counts, T, dtype=dtype)
        lengths = self.index.lengths

        em_snap, boot_snap, alpha_init, it_init, em_converged, on_sync = \
            self._em_snapshots(checkpoint_path, T)

        mesh = getattr(self, "_mesh", None)
        # checkpointed runs execute EM chunked so its host syncs can write
        # snapshots; decided from --checkpoint, which every host has, not
        # from on_sync, which only process 0 gets (em.use_chunked)
        snapshots = em_snap is not None
        t0 = time.perf_counter()
        metrics = getattr(self, "_metrics", None)
        with (metrics.timer("em") if metrics is not None
              else contextlib.nullcontext()):
            if alpha_init is not None and em_converged:
                # post-convergence pin: the EM stage already finished in
                # the crashed run; resume EXACTLY (re-running even one
                # block from the converged alpha would drift est_counts)
                alpha = jnp.asarray(alpha_init, dtype)
                iters = jnp.int32(it_init)
            elif mesh is not None and self.cfg.shard.data_axis > 1:
                from ..parallel.collective_em import run_em_collective

                alpha, iters = run_em_collective(ec, lengths, em_cfg, mesh,
                                                 self.cfg.shard,
                                                 alpha_init=alpha_init,
                                                 it_init=it_init,
                                                 on_sync=on_sync,
                                                 chunked=snapshots)
            else:
                alpha, iters = run_em(ec, lengths, em_cfg,
                                      alpha_init=alpha_init,
                                      it_init=it_init, on_sync=on_sync,
                                      chunked=snapshots)
            tpm = tpm_from_alpha(alpha, lengths, em_cfg)
            from ..em.em import log_likelihood

            eff_d = effective_lengths(jnp.asarray(lengths), em_cfg, dtype)
            ll = float(log_likelihood(ec, alpha, eff_d))
            alpha.block_until_ready()
        em_skipped = alpha_init is not None and em_converged
        if metrics is not None and not em_skipped:
            metrics.count("em_iterations", int(iters))
        t_em = time.perf_counter() - t0

        em_capped = int(iters) >= em_cfg.max_iters
        if not em_skipped and em_capped:
            log.warning(
                "EM stopped at max_iters=%d without meeting rel_tol=%g; "
                "results are usable but not fully converged (raise "
                "--em-max-iters or use --em-accel squarem)",
                em_cfg.max_iters, em_cfg.rel_tol)

        if em_snap is not None and on_sync is not None and not em_skipped:
            # EM stage complete (on_sync non-None == this is process 0):
            # pin the final state so a crash during bootstrap resumes
            # with the EM stage skipped EXACTLY rather than re-run. A
            # max_iters-capped stage pins converged=False — resume must
            # CONTINUE iterating (the user was just told to raise the
            # budget) — written directly, not via the throttled on_sync,
            # which would swallow a non-converged pin inside the
            # 30 s window (round-3 review findings).
            from ..utils.checkpoint import save_em_snapshot

            save_em_snapshot(em_snap, np.asarray(alpha), int(iters),
                             converged=not em_capped)

        boot = None
        if em_cfg.bootstrap_samples > 0:
            t0 = time.perf_counter()
            # bootstrap-stage snapshot state, shared by both branches:
            # loaded from disk on process 0, broadcast so every host takes
            # the same resume/fresh decision (and the same EM backend)
            b_init, b_it, b_sync = None, 0, None
            if boot_snap is not None:
                from ..utils.checkpoint import load_em_snapshot

                loaded = load_em_snapshot(boot_snap)
                if (loaded is not None and loaded[0].ndim == 2
                        and loaded[0].shape ==
                        (T, em_cfg.bootstrap_samples)):
                    b_init, b_it, _ = loaded
                    log.info("resuming bootstrap EM from snapshot at "
                             "iteration %d", b_it)
                b_init, b_it, _ = self._broadcast_snapshot(
                    b_init, b_it, False,
                    (T, em_cfg.bootstrap_samples))
                if on_sync is not None:  # process 0 only
                    b_sync = self._throttled_sync(boot_snap)
            if (mesh is not None and self.cfg.shard.data_axis > 1
                    and em_cfg.bootstrap_samples % self.cfg.shard.data_axis == 0):
                from ..parallel.bootstrap_shard import run_bootstrap_sharded
                from ..parallel.ckpt_mp import allgather_host

                # snapshots=... must agree across hosts (the snapshot
                # hook's alpha allgather is collective): boot_snap is
                # derived from --checkpoint, which multi-process runs
                # already require on every host (the mapping checkpoint
                # save is collective too)
                boot = allgather_host(run_bootstrap_sharded(
                    ec, lengths, em_cfg, mesh, self.cfg.shard,
                    alpha_init=b_init, it_init=b_it, on_sync=b_sync,
                    snapshots=boot_snap is not None))
            else:
                boot = np.asarray(
                    em_bootstrap.run_bootstrap(ec, lengths, em_cfg,
                                               alpha_init=b_init,
                                               it_init=b_it,
                                               on_sync=b_sync,
                                               chunked=snapshots)
                )
            t_boot = time.perf_counter() - t0
            log.info("bootstrap: %d replicates in %.2fs",
                     em_cfg.bootstrap_samples, t_boot)
        if on_sync is not None:
            # run complete: drop stage snapshots so the next fresh run
            # does not warm-start from stale state
            import os

            for p in (em_snap, boot_snap):
                if p and os.path.exists(p):
                    os.remove(p)

        timings = {"map_s": t_map, "resolve_s": t_resolve, "em_s": t_em}
        if boot is not None:
            timings["bootstrap_s"] = t_boot
        if metrics is not None:
            # BASELINE metric names (reads_per_s, em_iterations_per_s,
            # wall_s) from the per-run registry; surfaces in run_info.json
            timings.update(metrics.snapshot())
            metrics.log_summary()
        eff = np.asarray(effective_lengths(jnp.asarray(lengths), em_cfg, dtype))
        return QuantResult(
            est_counts=np.asarray(alpha),
            tpm=np.asarray(tpm),
            eff_length=eff,
            names=self.index.names,
            lengths=lengths,
            total_reads=result.total_reads,
            mapped=result.mapped - dropped,
            unmapped=result.unmapped + dropped,
            em_iterations=int(iters),
            bootstrap_counts=boot,
            timings=timings,
            fld_mean=None if fld_est is None else fld_est[0],
            fld_sd=None if fld_est is None else fld_est[1],
            fld_samples=None if fld_est is None else fld_est[2],
            log_likelihood=ll,
        )
