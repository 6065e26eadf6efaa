"""Gather-rate micro for the probe's bucket gather: what rate does the
full-row gather reach, and could locality (sorted / radix-binned lane
order) buy anything?

Measures, at config-1-scale (~40MB) and GENCODE-scale (~1GB) tables:
  * full-row-consumed bucket gather, 5M lanes: random / sorted / binned
    lane order (binning = stable sort by the top 8 or 12 bucket bits —
    the coalescing an O(N) radix binning pass could at best achieve);
  * the device-side cost of PRODUCING a binned order (argsort of the top
    bits + scatter of hi/lo/idx lanes) — what binning would have to pay;
  * derived effective GB/s and Mlane/s. No peak is assumed: set a
    roofline share against the card's published bandwidth, with its name
    and power limit, when reporting.

Protocol: jit once, warm up, then time n steps over distinct pre-uploaded
index arrays, ending in block_until_ready.

Run on the GPU: python benchmarks/micro_roofline.py [MB ...]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N = 5_000_000


def main():
    import jax
    import jax.numpy as jnp

    log = lambda *a: print(*a, file=sys.stderr, flush=True)
    log(f"[roofline] devices: {jax.devices()}")
    rng = np.random.default_rng(0)

    if jax.default_backend() != "gpu":
        log("[roofline] no GPU found; not timing")
        return 1

    def slope(name, fn, feeds, per_step_lanes=N, row_bytes=512, n=8):
        f = jax.jit(fn)
        jax.block_until_ready(f(*feeds[0]))
        t0 = time.perf_counter()
        o = None
        for i in range(n):
            o = f(*feeds[i % len(feeds)])
        jax.block_until_ready(o)
        dt = (time.perf_counter() - t0) / n
        gbs = per_step_lanes * row_bytes / dt / 1e9
        log(f"{name:44s} {dt*1e3:8.2f} ms  "
            f"{per_step_lanes/dt/1e6:7.1f} Mlane/s  {gbs:6.1f} GB/s")
        return dt

    sizes = ([int(a) for a in sys.argv[1:]] if len(sys.argv) > 1
             else (40, 1024))
    for mb in sizes:
        NB = (mb << 20) // 512  # 32-slot buckets, 512B (128-int32) rows
        # generate the table ON DEVICE: contents are irrelevant to gather
        # timing
        tb = jax.jit(lambda: jax.random.randint(
            jax.random.PRNGKey(0), (NB, 128), 0, 1 << 20, jnp.int32))()
        jax.block_until_ready(tb)
        log(f"\n[roofline] table {mb}MB ({NB} buckets, device-generated)")

        def feeds_for(transform=None, k=4):
            out = []
            for j in range(k):
                ix = rng.integers(0, NB, size=N, dtype=np.int32)
                arr = jnp.asarray(transform(ix) if transform else ix)
                out.append((jax.block_until_ready(arr),))
            return out

        # the table is an ARGUMENT, never a closure: closed-over arrays
        # are baked into the program as constants
        fullrow = lambda t, ix: t[ix].sum(axis=1)

        def with_tb(feeds):
            return [(tb, f[0]) for f in feeds]

        shift8 = max(int(NB - 1).bit_length() - 8, 0)
        shift12 = max(int(NB - 1).bit_length() - 12, 0)
        slope("full-row gather, random order", fullrow,
              with_tb(feeds_for()))
        slope("full-row gather, sorted order", fullrow,
              with_tb(feeds_for(np.sort)))
        slope("full-row gather, binned 256", fullrow,
              with_tb(feeds_for(lambda ix: ix[np.argsort(ix >> shift8,
                                                         kind="stable")])))
        slope("full-row gather, binned 4096", fullrow,
              with_tb(feeds_for(lambda ix: ix[np.argsort(ix >> shift12,
                                                         kind="stable")])))

        # what producing a binned order costs ON DEVICE: one 8-bit-key sort
        # of the lane ids (the radix-binning candidate XLA actually offers
        # is lax.sort over the top bits), payload = the 3 lane arrays that
        # would ride along (hi, lo, original position)
        def bin_cost(ix):
            key = (ix >> shift8).astype(jnp.int32)
            _, h, l, p = jax.lax.sort(
                (key, ix, ix, jnp.arange(N, dtype=jnp.int32)),
                num_keys=1)
            return h + l + p

        slope("device binning (sort top-8 bits + 3 payloads)",
              bin_cost, feeds_for(), row_bytes=16)

        # and the cheapest conceivable alternative: one N-lane int32
        # scatter (any binning scheme pays at least one reorder pass)
        def scatter_cost(ix):
            return jnp.zeros(N, jnp.int32).at[ix % N].set(ix)

        slope("one N-lane int32 scatter (reorder floor)",
              scatter_cost, feeds_for(), row_bytes=8)
        del tb


if __name__ == "__main__":
    sys.exit(main())
