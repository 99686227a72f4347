"""Asynchronous host->device input prefetch — counterpart of
``vit_tpu.runtime.prefetch``: ``prefetch_to_device`` and ``batched``.

A producer thread draws items from the host iterator and copies them to
the card ``size`` items ahead of the consumer, so host reads, the
host->device copy of batch i+1 and the device compute of batch i overlap
(the JAX module does this with ``jax.device_put``).  On a CUDA device each
array goes through a pinned host buffer and is copied on a side stream;
one CUDA event per item marks the end of its copies, and the consumer's
current stream waits on that event before the item is handed out — the
kernels launch on PyTorch's current stream (``ops/kernels/_build.py``), so
they follow the wait.  Three rules keep that safe:

- a pinned buffer is refilled only after the copy that last read it has
  finished (its event);
- each device tensor is marked as used by the consumer's stream
  (``record_stream``): the caching allocator hands its memory to the side
  stream's next copy only after the consumer's work on it is done;
- the producer thread sets the consumer's device first: threads do not
  inherit it, and a rank on card 1 would otherwise copy on card 0.

On the CPU the "copy" is a hand-off (``torch.from_numpy``).

Usage::

    for images, labels in prefetch_to_device(ds.batches(64), size=2, device="cuda"):
        loss = step(params, images, labels)
"""

from __future__ import annotations

import queue
import sys
import threading
from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch


def _map(item, fn):
    """``fn`` over every array leaf of a tuple/list/dict item."""
    if isinstance(item, dict):
        return {k: _map(v, fn) for k, v in item.items()}
    if isinstance(item, (tuple, list)):
        return type(item)(_map(v, fn) for v in item)
    if item is None:
        return None
    return fn(item)


class _PinnedSlots:
    """A ring of pinned host buffers, each with the event of the copy that
    last read it; a buffer is refilled only after that copy is done."""

    def __init__(self, n: int):
        self._bufs: list = [None] * n
        self._events: list = [None] * n
        self._next = 0

    def stage(self, host: torch.Tensor, device: torch.device, stream, copies: list):
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        if self._events[i] is not None:
            self._events[i].synchronize()  # the copy still reading this buffer
        buf = self._bufs[i]
        if buf is None or buf.shape != host.shape or buf.dtype != host.dtype:
            buf = self._bufs[i] = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        buf.copy_(host)
        with torch.cuda.stream(stream):
            out = buf.to(device, non_blocking=True)
        copies.append(i)
        return out

    def done(self, copies: list, event) -> None:
        for i in copies:
            self._events[i] = event


def prefetch_to_device(
    iterator: Iterable[Any],
    size: int = 2,
    device=None,
) -> Iterator[Any]:
    """Yield device-resident items, staying ``size`` items ahead.

    Each item is an array (numpy or torch) or a tuple, list or dict of
    them; every array becomes a tensor on ``device`` (default: the current
    CUDA device where there is a card, else the CPU).  An exception in the
    producer is raised in the consumer; closing the generator (``close()``,
    ``break``) stops and joins the producer.
    """
    if size < 1:
        raise ValueError("prefetch size must be >= 1")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    on_card = device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=size)
    _SENTINEL = object()
    err: list = []
    stop = threading.Event()

    def _put(item) -> bool:
        """Bounded put that gives up once the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _host(a) -> torch.Tensor:
        return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))

    def producer():
        try:
            if on_card:
                torch.cuda.set_device(device)
                stream = torch.cuda.Stream(device)
                # a buffer is busy only until its copy ends; a few more
                # buffers than queued items let the producer rarely wait
                slots = _PinnedSlots(2 * (size + 2))
            for item in iterator:
                if on_card:
                    copies: list = []
                    placed = _map(item, lambda a: slots.stage(_host(a), device, stream, copies))
                    event = torch.cuda.Event()
                    event.record(stream)
                    slots.done(copies, event)
                    placed = (placed, event)
                else:
                    placed = _map(item, lambda a: _host(a).to(device))
                if not _put(placed):
                    return  # the consumer closed the generator
        except BaseException as e:  # raised again in the consumer
            err.append(e)
        finally:
            _put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True, name="prefetch_to_device")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            if on_card:
                item, event = item
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(event)
                _map(item, lambda x: x.record_stream(consumer))
            yield item
    finally:
        # early exit: stop the producer, drop the staged batches so their
        # device memory is released, and join the thread
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=60.0)
        if t.is_alive():
            print("warning: prefetch producer still blocked after 60 s (a wedged host read or "
                  "copy?)", file=sys.stderr)


def batched(array_like, batch_size: int, drop_remainder: bool = False):
    """Slice a large array (e.g. the full input-100.bin batch) into
    fixed-size minibatches for the prefetcher."""
    n = len(array_like)
    end = n - (n % batch_size) if drop_remainder else n
    for i in range(0, end, batch_size):
        yield array_like[i : i + batch_size]
