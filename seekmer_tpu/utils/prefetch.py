"""P3 — software-pipelined ingest (SURVEY.md 2.2): a background thread
drains the (host-bound) FASTQ decode/pack generator into a bounded queue
while the main thread dispatches device steps. Combined with JAX's async
dispatch and donated signature tables, steady state overlaps host parse,
H2D copy, and device compute. The reference's analog is its reader
process feeding the worker pool (SURVEY.md 2.1 C6)."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def device_put_batches(batches, pack_2bit: bool = False):
    """Upload every ReadBatch array eagerly (ideally from prefetch()'s
    producer thread) so the dispatch loop never touches numpy: each
    numpy->device conversion at jit-dispatch time is a blocking transfer,
    while a loop over device-resident args pipelines fully
    asynchronously. n_real is computed host-side first so the feed loop's
    read accounting never syncs with the device.

    ``pack_2bit`` 2-bit-packs code rows host-side before upload
    (io/fastq.pack_batch_2bit: 2.67x fewer H2D bytes; the device step
    unpacks exactly). The pack runs on this producer thread, overlapped
    with device compute like the rest of ingest."""
    import dataclasses

    import jax

    for b in batches:
        n_real = b.n_real
        if pack_2bit:
            from ..io.fastq import pack_batch_2bit

            b = pack_batch_2bit(b)
        yield dataclasses.replace(
            b,
            codes=jax.device_put(b.codes),
            lengths=jax.device_put(b.lengths),
            weights=jax.device_put(b.weights),
            codes2=None if b.codes2 is None else jax.device_put(b.codes2),
            lengths2=(None if b.lengths2 is None
                      else jax.device_put(b.lengths2)),
            bad=None if b.bad is None else jax.device_put(b.bad),
            bad2=None if b.bad2 is None else jax.device_put(b.bad2),
            n_real_cached=n_real,
        )


def prefetch(items: Iterable[T], depth: int = 4) -> Iterator[T]:
    """Iterate ``items`` on a daemon thread, buffering up to ``depth``."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    error = []

    def worker():
        try:
            for item in items:
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            error.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            if error:
                raise error[0]
            return
        yield item
