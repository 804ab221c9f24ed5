"""Threaded host->device input prefetch for the train loops.

Counterpart of acfm_video_3d_reconstruction_tpu/train/prefetch.py: one
producer thread, a bounded queue, batch order kept, exceptions re-raised at
the consumer and a prompt stop when the consumer abandons the iterator. The
loader's numpy work and the batch's upload run on the producer thread while
the previous step runs on the card; `to_device` is the upload. On that
thread the loader's next() is the span `data.load` and the upload the span
`data.upload` (utils/tracing.py).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import torch

from ..utils import tracing

_SENTINEL = object()


def to_device(batch: dict, keys, device: torch.device, int_keys=()) -> dict:
    """The batch's `keys` as float32 tensors (`int_keys` int64) on `device`.
    On a CUDA device each goes through pinned memory with a non-blocking
    copy, enqueued on the calling thread's current stream (the default
    stream), so the step's kernels, launched later on that stream, are
    ordered after it."""
    out = {}
    with tracing.span("data.upload"):
        for k in keys:
            t = torch.as_tensor(batch[k], dtype=torch.long if k in int_keys else torch.float32)
            out[k] = t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t
    return out


def prefetch(loader: Iterable, prep: Callable, depth: int = 2) -> Iterator:
    """Yield ``prep(batch)`` for each batch in ``loader``, preparing up to
    ``depth`` batches ahead in a background thread.

    ``prep`` runs entirely on the producer thread; the consumer receives
    prepared batches in order. Exceptions from the loader or ``prep``
    re-raise at the consumer's next pull; abandoning the iterator early
    (``break``) stops the producer promptly instead of leaking a blocked
    thread (an exception that coincides with that stop is dropped).
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    failure = []

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
            items = iter(loader)
            while True:
                with tracing.span("data.load"):
                    item = next(items, _SENTINEL)
                if item is _SENTINEL or not put(prep(item)):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised on consumer side
            failure.append(e)
        finally:
            put(_SENTINEL)

    t = threading.Thread(target=worker, name="acfm-prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
        t.join()
        if failure:
            raise failure[0]
    finally:
        stop.set()
