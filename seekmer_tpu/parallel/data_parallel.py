"""P1 — data-parallel mapping over the `reads` mesh axis (SURVEY.md 2.2).

The reference's only parallelism is a single-host worker pool merging
per-worker EC count dicts (mapper.py, SURVEY.md 2.1 C6). The device design
shards each global read batch over the mesh: every chip runs the full map
step (pack -> probe -> signature) on its shard against a REPLICATED k-mer
index and accumulates into its own device-resident signature table
[BASELINE.json:9]. Tables are merged once at finalize time (the analog of
the reference's join-time dict merge — merging counts per distinct
signature, not per read).

Multi-host: each process feeds its local shard of the global batch
(jax.make_array_from_process_local_data) and the same jitted step runs
SPMD; mesh.py/init_distributed brings up the process group (P6).
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import MapConfig, ShardConfig
from ..index.store import KMerIndex
from ..io.fastq import ReadBatch
from ..map.driver import DeviceIndex, MapResult, map_step, merge_sig_rows
from ..map.signature import SigTable, make_sig_table
from .mesh import make_mesh

log = logging.getLogger(__name__)


def _shard_spec(mesh: Mesh, cfg: ShardConfig, *axis):
    return NamedSharding(mesh, P(*axis))


class DataParallelMapper:
    """Shards read batches over the `reads` mesh axis; per-chip signature
    tables merged at finalize."""

    def __init__(
        self,
        index: KMerIndex,
        cfg: MapConfig = MapConfig(),
        shard_cfg: ShardConfig = ShardConfig(),
        mesh: Mesh = None,
    ):
        self.index = index
        self.cfg = cfg
        self.shard_cfg = shard_cfg
        self.mesh = mesh if mesh is not None else make_mesh(shard_cfg)
        self.n_shards = self.mesh.shape[shard_cfg.data_axis_name]
        if cfg.batch_size % self.n_shards:
            raise ValueError(
                f"global batch {cfg.batch_size} not divisible by "
                f"{self.n_shards} data shards")
        if cfg.probe_sample >= 2 and cfg.sample_fallback_frac == 0:
            # auto cap-sizing needs a host readback the shard_map step
            # does not do; map_step resolves auto to the fixed default
            log.info("fast-mode fallback cap: auto (sample_fallback_frac"
                     "=0) resolves to 0.125 under data-parallel sharding "
                     "— pass an explicit value to tune (see config.py)")

        from ..ops.probe import device_table_layout

        rep = _shard_spec(self.mesh, shard_cfg)
        self.device_index = DeviceIndex(
            table=jax.device_put(
                device_table_layout(index.table, index.bucket), rep),
            stash=jax.device_put(
                device_table_layout(index.stash, index.bucket), rep),
            main_slots=index.main_slots,
            stash_slots=index.stash_slots,
            bucket=index.bucket,
            k=index.k,
        )
        # Per-chip tables, materialized as one global array sharded on dim 0:
        # chip d owns rows [d*(S+1), (d+1)*(S+1)).
        data = _shard_spec(self.mesh, shard_cfg, shard_cfg.data_axis_name)
        local = make_sig_table(cfg.sig_table_bits, cfg.max_ecs_per_read,
                               num_ecs=0 if cfg.fusion_pairs
                               else index.num_ecs)
        def tile0(x):
            return jnp.tile(x, (self.n_shards,) + (1,) * (x.ndim - 1))

        self.table = SigTable(
            key=jax.device_put(tile0(local.key), data),
            count=jax.device_put(tile0(local.count), data),
            sig=jax.device_put(tile0(local.sig), data),
            overflow=jax.device_put(
                jnp.zeros(self.n_shards, jnp.int32), data),
            collisions=jax.device_put(
                jnp.zeros(self.n_shards, jnp.int32), data),
            ec_count=jax.device_put(tile0(local.ec_count), data),
        )
        self.total_reads = 0
        self._ckpt_step = 0
        self._fed_batches = 0
        self._steps: Dict[Tuple[int, bool, bool], callable] = {}

    def _get_step(self, bucket: int, paired: bool, audit: bool = True):
        key = (bucket, paired, audit)
        if key in self._steps:
            return self._steps[key]
        cfg, shard_cfg, mesh = self.cfg, self.shard_cfg, self.mesh
        axis = shard_cfg.data_axis_name
        dspec = P(axis)
        rspec = P()
        di_spec = DeviceIndex(
            table=rspec, stash=rspec,
            main_slots=self.index.main_slots,
            stash_slots=self.index.stash_slots,
            bucket=self.index.bucket, k=self.index.k,
        )
        tab_spec = SigTable(key=dspec, count=dspec, sig=dspec, overflow=dspec,
                            collisions=dspec, ec_count=dspec)

        def local_step(di, table, codes, lengths, weights,
                       codes2=None, lengths2=None):
            # overflow/collisions are per-shard: scalar inside, [1] outside
            t = SigTable(table.key, table.count, table.sig,
                         table.overflow[0], table.collisions[0],
                         table.ec_count)
            t = map_step(di, cfg, t, codes, lengths, weights,
                         codes2=codes2, lengths2=lengths2, audit=audit)
            return SigTable(t.key, t.count, t.sig, t.overflow[None],
                            t.collisions[None], t.ec_count)

        n_data = 5 + (2 if paired else 0)
        sm = jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(di_spec, tab_spec) + (dspec,) * (n_data - 2),
            out_specs=tab_spec,
            check_vma=False,
        )
        step = jax.jit(sm, donate_argnums=(1,))
        self._steps[key] = step
        return step

    def _put_batch(self, arr):
        """Place a batch array sharded over the reads axis. Multi-process:
        each host passes its LOCAL shard of the global batch (the per-host
        FASTQ shard of BASELINE config 3) and the global array is assembled
        across processes."""
        dshard = _shard_spec(self.mesh, self.shard_cfg,
                             self.shard_cfg.data_axis_name)
        if jax.process_count() > 1:
            return jax.make_array_from_process_local_data(dshard, arr)
        return jax.device_put(arr, dshard)

    def feed(self, batch: ReadBatch) -> None:
        if batch.pad_len is not None:
            raise ValueError(
                "2-bit-packed batches are single-chip-mapper only; feed "
                "unpacked rows (device_put_batches(pack_2bit=False))")
        from ..map.driver import audit_this_batch

        paired = batch.codes2 is not None
        step = self._get_step(batch.bucket, paired,
                              audit_this_batch(self.cfg, self._fed_batches))
        self._fed_batches += 1
        put = self._put_batch
        args = [put(batch.codes), put(batch.lengths), put(batch.weights)]
        if paired:
            args += [put(batch.codes2), put(batch.lengths2)]
        self.table = step(self.device_index, self.table, *args)
        self.total_reads += batch.n_real

    def run(self, batches: Iterable[ReadBatch],
            checkpoint_path: str = None,
            checkpoint_every: int = 50) -> MapResult:
        from ..map.driver import _run_with_checkpoints

        return _run_with_checkpoints(self, batches, checkpoint_path,
                                     checkpoint_every)

    def save_checkpoint(self, path: str, stream_state=None) -> None:
        """Checkpoint the SHARDED signature table + resume cursor.
        Multi-process: collective global-table + per-host cursor sidecar
        protocol (parallel/ckpt_mp.py; every process calls this at the
        same round, which _run_with_checkpoints_multiprocess
        guarantees)."""
        from .ckpt_mp import save_mapper_checkpoint

        save_mapper_checkpoint(self, path, stream_state)

    def supports_checkpoint(self) -> bool:
        return True

    def restore_checkpoint(self, path: str):
        """Restore the sharded table (re-placed with this mapper's data
        sharding); returns the stream cursor — this HOST's cursor on
        multi-process runs — ({} when the checkpoint has none), or None
        if no checkpoint exists."""
        from .ckpt_mp import restore_mapper_checkpoint

        return restore_mapper_checkpoint(
            self, path, _shard_spec(self.mesh, self.shard_cfg,
                                    self.shard_cfg.data_axis_name))

    def make_fld_estimator(self):
        """FLD estimator over the mesh-replicated device index."""
        if self.index.fld_tid is None:
            return None
        from ..map.fld import FLDEstimator

        return FLDEstimator(self.index, self.device_index)

    def _host(self, x) -> np.ndarray:
        from .ckpt_mp import allgather_host

        return allgather_host(x)

    def finalize(self) -> MapResult:
        """Merge the per-chip signature tables host-side (the reference's
        worker-join dict merge, over distinct signatures). Multi-process:
        tables are allgathered so every host sees the global result, and
        per-host read counters are summed."""
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            self.total_reads = int(multihost_utils.process_allgather(
                np.int64(self.total_reads)).sum())
        count = self._host(self.table.count).astype(np.int64)
        sig = self._host(self.table.sig)
        overflow = int(self._host(self.table.overflow).sum())
        collisions = int(self._host(self.table.collisions).sum())
        ec = self._host(self.table.ec_count)
        if ec.size > self.n_shards:  # real per-chip direct vectors
            from ..map.signature import direct_rows

            ec_sum = ec.reshape(self.n_shards, -1).sum(axis=0)
            drows, dcounts = direct_rows(ec_sum, sig.shape[1])
            if drows.shape[0]:
                sig = np.concatenate([sig, drows])
                count = np.concatenate([count, dcounts])
        return merge_sig_rows(sig, count, self.total_reads, overflow,
                              collisions=collisions)
