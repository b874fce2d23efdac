"""Host -> device batch prefetching for the training loop.

Port of ``patch2pix_tpu.data.prefetch``: a background thread stages the
next batches on the device while the current step runs. On a CUDA
device each array is copied into pinned host memory and sent with a
``non_blocking`` copy on a side stream; the batch carries an event
recorded after its copies, the consumer's current stream waits on that
event, and ``record_stream`` marks each tensor as used by the consumer's
stream, so the caching allocator keeps its memory until the consumer's
work is done. On the CPU the arrays pass through as tensors sharing
their memory.

As in the JAX package: the producer watches a stop event and puts with a
timeout, so a consumer that leaves early (the train CLI breaking at
``--steps_per_epoch``) releases the thread and its staged batches; an
error in the producer is raised in the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from patch2pix_tpu_torch.config import resolve_device


class _PrefetchError:
    """Wraps a producer-side exception (a class of its own, so no batch
    can be taken for one)."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch_to_device(iterator: Iterator, size: int = 2, device=None) -> Iterator:
    """Yield the batches of ``iterator`` (flat dicts of numpy arrays, as
    ``batch_iterator`` gives them) with every array a tensor on
    ``device`` (CUDA unless given), ``size`` batches staged ahead."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    side = torch.cuda.Stream(device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=max(size, 1))
    done = object()
    stop = threading.Event()

    def _put(item) -> bool:
        """Put with a stop check; False once stopping."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def stage(item):
        item = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in item.items()}
        if not cuda:
            return item, None
        with torch.cuda.stream(side):
            out = {k: t.pin_memory().to(device, non_blocking=True) for k, t in item.items()}
            event = torch.cuda.Event()
            event.record(side)
        return out, event

    def producer():
        try:
            if cuda:
                torch.cuda.set_device(device)
            for item in iterator:
                if not _put(stage(item)) or stop.is_set():
                    return
            _put(done)
        except BaseException as e:  # raised again in the consumer
            _put(_PrefetchError(e))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            got = q.get()
            if got is done:
                return
            if isinstance(got, _PrefetchError):
                raise got.exc
            item, event = got
            if event is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(event)
                for x in item.values():
                    x.record_stream(consumer)
            yield item
    finally:
        # on close()/GC as on a normal end: unblock the producer and drop
        # the staged batches
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=2.0)
