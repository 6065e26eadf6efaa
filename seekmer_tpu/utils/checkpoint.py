"""Batch-granular checkpoint/resume (SURVEY.md 5.3/5.4).

The reference's only checkpoint is the index file itself (build once, reuse;
a crashed run is simply re-run). For long device mapping runs we add:

  * mapping checkpoints: the (possibly mesh-sharded) signature table + the
    read-stream resume cursor — per-file uncompressed byte offsets plus the
    pending partial-bucket buffers (io/fastq.CheckpointableBatchSource) —
    written every N batches; resume seeks instead of re-decoding;
  * EM snapshots: the alpha vector + iteration counter (EM is cheap, but
    the snapshot makes the pipeline restartable at every stage boundary).

Plain npz — same serialization family as the index store.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

# 2: SigTable.key became bucketized (S/KB+1, KB, 2).
# 3: stream cursor became offset-based (file idx + byte offset + pending
#    partial-bucket buffers) — the format-2 reads_consumed cursor has no
#    offset to seek to, so old checkpoints are rejected.
FORMAT = 3


def _cursor_to_arrays(stream_state: Optional[dict]):
    """CheckpointableBatchSource cursor -> (json-able meta, npz arrays)."""
    if stream_state is None:
        return None, {}
    cursor_meta = {k: stream_state[k] for k in ("v", "paired", "s1", "s2")}
    cursor_meta["buckets"] = sorted(stream_state["pending"])
    arrays = {}
    for bucket, d in stream_state["pending"].items():
        for name, arr in d.items():
            arrays[f"pend_{bucket}_{name}"] = arr
    return cursor_meta, arrays


def _cursor_from_npz(z, cm: Optional[dict]) -> Optional[dict]:
    if cm is None:
        return None
    pending = {}
    for bucket in cm["buckets"]:
        pending[int(bucket)] = {
            name: z[f"pend_{bucket}_{name}"]
            for name in ("c1", "l1", "c2", "l2")
            if f"pend_{bucket}_{name}" in z.files
        }
    return {"v": cm["v"], "paired": cm["paired"], "s1": cm["s1"],
            "s2": cm["s2"], "pending": pending}


def save_map_checkpoint(
    path: str,
    table,
    total_reads: int,
    stream_state: Optional[dict],
    step: int = 0,
) -> None:
    """Write the signature-table state + resume cursor atomically.

    ``stream_state`` is a CheckpointableBatchSource cursor (or None);
    its pending buffers are stored as first-class npz arrays
    (allow_pickle stays False). ``step`` is a monotonically increasing
    save counter used by multi-process checkpoints to prove the table
    file and the per-host cursor sidecars came from the SAME save."""
    cursor_meta, arrays = _cursor_to_arrays(stream_state)
    meta = dict(format=FORMAT, total_reads=int(total_reads),
                cursor=cursor_meta, step=int(step))
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as fh:
        np.savez_compressed(
            fh,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            key=np.asarray(table.key),
            count=np.asarray(table.count),
            sig=np.asarray(table.sig),
            overflow=np.asarray(table.overflow),
            collisions=np.asarray(table.collisions),
            ec_count=np.asarray(table.ec_count),
            **arrays,
        )
    os.replace(tmp, path)


def load_map_checkpoint(
    path: str,
    with_step: bool = False,
):
    """Returns (SigTable, total_reads, cursor[, step]) or None if absent."""
    from ..map.signature import SigTable

    if not os.path.exists(path):
        return None
    import jax.numpy as jnp

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta["format"] != FORMAT:
            raise ValueError(f"checkpoint format {meta['format']} != {FORMAT}")
        table = SigTable(
            key=jnp.asarray(z["key"]),
            count=jnp.asarray(z["count"]),
            sig=jnp.asarray(z["sig"]),
            overflow=jnp.asarray(z["overflow"]),
            # absent in pre-collision-audit format-3 checkpoints; default
            # to zeros of overflow's shape (scalar single-chip, per-shard
            # vector for the DP/prefix mappers)
            collisions=jnp.asarray(
                z["collisions"] if "collisions" in z.files
                else np.zeros_like(z["overflow"])),
            # absent in pre-direct-count checkpoints: the (1,) zero
            # placeholder; restore paths adapt it to the mapper's shape
            # (adapt_ec_count)
            ec_count=jnp.asarray(
                z["ec_count"] if "ec_count" in z.files
                else np.zeros(1, np.int32)),
        )
        cursor = _cursor_from_npz(z, meta["cursor"])
        if with_step:
            return table, meta["total_reads"], cursor, meta.get("step", 0)
        return table, meta["total_reads"], cursor


def adapt_ec_count(table, target_shape):
    """Fit a loaded table's direct per-EC vector to the mapper's shape:
    pre-direct checkpoints carry the (1,) zero placeholder (every count
    lives in the CAS rows — substituting zeros is exact); any NONZERO
    shape mismatch means a different index and is refused."""
    ec = np.asarray(table.ec_count)
    if ec.shape == tuple(target_shape):
        return table
    if ec.any():
        raise ValueError(
            "checkpoint's per-EC direct counts have shape "
            f"{ec.shape} != {tuple(target_shape)} (different index?); "
            "refusing to restore")
    return table._replace(
        ec_count=np.zeros(target_shape, np.int32))


def host_cursor_path(path: str, process_index: int) -> str:
    return f"{path}.host{process_index}.npz"


def save_host_cursor(path: str, process_index: int,
                     stream_state: Optional[dict], total_reads: int,
                     step: int) -> None:
    """Per-host cursor sidecar for MULTI-PROCESS checkpoints (SURVEY.md
    5.3): each host's read-stream position + per-host read counter, stamped
    with the save's ``step`` so restore can prove the global table file and
    every sidecar came from the same save."""
    cursor_meta, arrays = _cursor_to_arrays(stream_state)
    meta = dict(format=FORMAT, total_reads=int(total_reads),
                cursor=cursor_meta, step=int(step),
                process_index=int(process_index))
    out = host_cursor_path(path, process_index)
    tmp = out + ".tmp.npz"
    with open(tmp, "wb") as fh:
        np.savez_compressed(
            fh,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            **arrays,
        )
    os.replace(tmp, out)


def load_host_cursor(
    path: str, process_index: int
) -> Optional[Tuple[Optional[dict], int, int]]:
    """Returns (cursor, total_reads, step) or None if absent."""
    out = host_cursor_path(path, process_index)
    if not os.path.exists(out):
        return None
    with np.load(out, allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta["format"] != FORMAT:
            raise ValueError(f"cursor format {meta['format']} != {FORMAT}")
        cursor = _cursor_from_npz(z, meta["cursor"])
        return cursor, meta["total_reads"], meta.get("step", 0)


def save_em_snapshot(path: str, alpha: np.ndarray, iteration: int,
                     converged: bool = False) -> None:
    """EM/bootstrap stage snapshot. UNCOMPRESSED npz: these fire from the
    chunked driver's ~2 s host syncs, and np.savez_compressed of a
    GENCODE-scale (T, B) alpha costs seconds per write (round-3 review
    finding) — a transient restart artifact does not need compression.
    ``converged=True`` marks the post-convergence pin, letting resume
    skip the EM stage entirely (exact restart)."""
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as fh:
        np.savez(fh, alpha=np.asarray(alpha),
                 iteration=np.int64(iteration),
                 converged=np.bool_(converged))
    os.replace(tmp, path)


def load_em_snapshot(path: str) -> Optional[Tuple[np.ndarray, int, bool]]:
    """Returns (alpha, iteration, converged) or None if absent."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        converged = bool(z["converged"]) if "converged" in z.files else False
        return z["alpha"], int(z["iteration"]), converged
