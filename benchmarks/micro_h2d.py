#!/usr/bin/env python
"""Same-process H2D A/B: uploading a read batch as uint8 code rows vs the
2-bit-packed form (MapConfig.h2d_pack_2bit). Back-to-back alternating
reps, each upload ended by block_until_ready. This isolates the transfer
claim from the end-to-end wall clock (benchmarks/e2e_cli.py).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def main() -> int:
    import jax

    from seekmer_tpu.encoding import pack_codes_2bit

    B, L = 65536, 100
    rng = np.random.default_rng(0)
    log = lambda *a: print(*a, file=sys.stderr, flush=True)
    log(f"[h2d] devices: {jax.devices()}")

    reps = 4
    # distinct buffers per rep: re-uploading one array can be cached
    raws = [rng.integers(0, 4, size=(B, L)).astype(np.uint8)
            for _ in range(reps)]
    packs = [pack_codes_2bit(r) for r in raws]

    def time_uploads(arrs):
        t0 = time.perf_counter()
        for a in arrs:
            jax.block_until_ready(jax.device_put(a))
        return (time.perf_counter() - t0) / len(arrs)

    def time_uploads_pipelined(arrs):
        """All puts enqueued, one readback at the end — the production
        shape (prefetch thread uploads with no per-batch sync)."""
        t0 = time.perf_counter()
        jax.block_until_ready([jax.device_put(a) for a in arrs])
        return (time.perf_counter() - t0) / len(arrs)

    # warmup both paths
    time_uploads([raws[0]])
    time_uploads([packs[0][0], packs[0][1]])
    log("[h2d] warmup done")

    # alternate A/B so drift hits both arms equally
    raw_ms, packed_ms = [], []
    raw_pl, packed_pl = [], []
    for i in range(3):
        raw_ms.append(time_uploads(raws) * 1e3)
        packed_ms.append((time_uploads([p for pr in packs for p in pr]))
                         * 2e3)  # 2 arrays per batch -> per-batch ms
        raw_pl.append(time_uploads_pipelined(raws) * 1e3)
        packed_pl.append(time_uploads_pipelined(
            [p for pr in packs for p in pr]) * 2e3)
        log(f"[h2d] round {i}: sync raw {raw_ms[-1]:.1f} / packed "
            f"{packed_ms[-1]:.1f} ms/batch; pipelined raw "
            f"{raw_pl[-1]:.1f} / packed {packed_pl[-1]:.1f}")
    raw = float(np.median(raw_ms))
    packed = float(np.median(packed_ms))
    raw_mb = B * L / 1e6
    packed_mb = (B * ((L + 3) // 4) + B * ((L + 7) // 8)) / 1e6
    print(json.dumps({
        "raw_ms_per_batch": round(raw, 2),
        "packed_ms_per_batch": round(packed, 2),
        "speedup": round(raw / packed, 2),
        "raw_pipelined_ms": round(float(np.median(raw_pl)), 2),
        "packed_pipelined_ms": round(float(np.median(packed_pl)), 2),
        "pipelined_speedup": round(float(np.median(raw_pl))
                                   / float(np.median(packed_pl)), 2),
        "raw_mb": round(raw_mb, 2),
        "packed_mb": round(packed_mb, 2),
        "raw_reps_ms": [round(x, 2) for x in raw_ms],
        "packed_reps_ms": [round(x, 2) for x in packed_ms],
        "batch": [B, L],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
