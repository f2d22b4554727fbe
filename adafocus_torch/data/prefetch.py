"""Batch prefetching: prepare the next batches while the current step runs
(counterpart of adafocus_tpu/data/prefetch.py).

A background thread runs ``prep`` (the loader's next batch, then its batch
prep on the device) ``depth`` batches ahead. Its device work goes to the
worker thread's current stream, which is the device's default stream, as
the consumer's is: the two threads' kernels are ordered on one stream, so
no ``wait_stream`` or ``record_stream`` is needed and a batch's memory is
never reused while a kernel still reads it. What the overlap buys is the
host's work (sampling, indexing, launches), not a second stream.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, Tuple

import torch

from adafocus_torch import default_device

_SENTINEL = object()


def prefetch_to_device(
    batches: Iterable,
    prep: Callable,
    depth: int = 2,
    device: Optional[torch.device] = None,
) -> Iterator[Tuple]:
    """Yield ``prep(raw, index)`` results, computed ``depth`` ahead.

    ``prep`` takes (raw_batch, batch_index) so callers can seed each batch's
    draws from its index. On a CUDA ``device`` the worker thread makes it
    its current device first. An exception in the worker reaches the
    consumer, raised from the loop.
    """
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()
    # resolved here: a CUDA device without an index means this thread's
    # current device, and set_device wants the index
    cuda = (default_device(device)
            if device is not None and torch.device(device).type == "cuda" else None)

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            if cuda is not None:
                torch.cuda.set_device(cuda)
            for i, raw in enumerate(batches):
                if not put(prep(raw, i)):
                    return
        except BaseException as e:  # handed to the consuming thread, which raises it
            put((_SENTINEL, e))
            return
        put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _SENTINEL:
                raise item[1]
            yield item
    finally:
        # a consumer that stops early (a break, an exception) releases the
        # worker, which would otherwise block on a full queue
        stop.set()
        t.join(timeout=60)
