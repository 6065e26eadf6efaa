"""Device-mesh construction and sharding helpers (SURVEY.md 2.2/2.3 — the
reference has no distributed layer at all; its only parallelism is a
single-host worker pool, so this subsystem is device-native by design:
jax.sharding Mesh + NamedSharding + shard_map with XLA collectives (NCCL
on GPUs), never hand-written transports). Every device reaches every
other at the same rate, so the mesh is a plain reshape of jax.devices().
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import ShardConfig


def make_mesh(cfg: ShardConfig = ShardConfig(),
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (reads, index) mesh. data_axis/index_axis of 0 or -1 mean
    "use all remaining devices" (data takes precedence)."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    d_ax, i_ax = cfg.data_axis, cfg.index_axis
    if i_ax <= 0:
        i_ax = 1
    if d_ax <= 0:
        d_ax = n // i_ax
    if d_ax * i_ax != n:
        raise ValueError(
            f"mesh {d_ax}x{i_ax} != {n} devices; set data_axis/index_axis "
            "to factor the device count")
    arr = np.asarray(devices).reshape(d_ax, i_ax)
    return Mesh(arr, (cfg.data_axis_name, cfg.index_axis_name))


def data_sharding(mesh: Mesh, cfg: ShardConfig = ShardConfig()) -> NamedSharding:
    """Batch-dim sharding over the reads axis."""
    return NamedSharding(mesh, P(cfg.data_axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def init_distributed() -> None:
    """Multi-host process-group bring-up (P6, SURVEY.md 2.3). No-op when
    single-process; on a pod slice call before device use."""
    import os

    if os.environ.get("JAX_COORDINATOR_ADDRESS"):
        jax.distributed.initialize()
