"""Profiling: a profiler trace around a block, and the program's own
spans and counters.

Port of ``patch2pix_tpu.utils.profiling``'s ``trace``. The tracer is
off unless a :func:`tracing` block is open. Off, :func:`span` and
:func:`count` are one check of a module-level flag: no
``record_function``, no CUDA event, no tensor operation, no sync, no
allocation. On, each span records its name, its id, its parent's id
and its call id (the id of its root, the span with no open parent), its
host start and end (``time.perf_counter_ns``), a CUDA event pair on the
current stream once CUDA is in use, and enters
``torch.profiler.record_function(name)``, so a profiler trace taken
over the block shows every span on the device operations' clock. Spans
and counters stay in memory until :func:`drain`.

    with profiling.tracing(), profiling.trace(log_dir):
        model.predict_fine(im1, im2)
    numbers = profiling.drain()
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, List

import torch

_on = False
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()  # each thread's stack of open spans
_next_id = 0
_spans: List["_Span"] = []
_counters: Dict[str, object] = {}


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Run ``torch.profiler`` (the CPU, and CUDA where present) over the
    block and write its Chrome trace to ``{log_dir}/trace.json``
    (viewable in Perfetto or chrome://tracing)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """Turn the tracer on inside the block (blocks nest)."""
    global _on
    prev = _on
    _on = True
    try:
        yield
    finally:
        _on = prev


def span(name: str):
    """A context manager that records the block as span ``name`` while
    tracing is on, and does nothing otherwise."""
    if not _on:
        return _NULL
    return _Span(name)


def count(name: str, value) -> None:
    """Add ``value`` to counter ``name`` while tracing is on: an int, or
    a tensor, summed on its device (no sync until :func:`drain`)."""
    if not _on:
        return
    if isinstance(value, torch.Tensor):
        value = value.detach().sum()
    with _lock:
        prev = _counters.get(name)
        _counters[name] = value if prev is None else prev + value


def drain() -> Dict:
    """Synchronise once and return ``{"spans": [...], "counters":
    {...}}``, then clear both. Each span (closed ones, by id) is a dict:
    ``name``, ``id``, ``parent`` (None for a root), ``call``,
    ``start_ns``, ``end_ns``, ``host_ms`` and ``device_ms`` (None without
    CUDA events). Counters are ints."""
    global _spans, _counters
    with _lock:
        spans, counters = _spans, _counters
        _spans, _counters = [], {}
    if any(s.events is not None for s in spans):
        torch.cuda.synchronize()
    return {"spans": [s.record() for s in sorted(spans, key=lambda s: s.id)],
            "counters": {k: int(v) for k, v in counters.items()}}


def _cuda_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _stack() -> List["_Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "id", "parent", "call", "t0", "t1", "events", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.events = None

    def __enter__(self):
        global _next_id
        stack = _stack()
        with _lock:
            self.id = _next_id
            _next_id += 1
        top = stack[-1] if stack else None
        self.parent = None if top is None else top.id
        self.call = self.id if top is None else top.call
        stack.append(self)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if _cuda_in_use():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self._rf.__exit__(*exc)
        _stack().pop()
        with _lock:
            _spans.append(self)
        return False

    def record(self) -> Dict:
        dev = None if self.events is None else self.events[0].elapsed_time(self.events[1])
        return {"name": self.name, "id": self.id, "parent": self.parent, "call": self.call,
                "start_ns": self.t0, "end_ns": self.t1, "host_ms": (self.t1 - self.t0) / 1e6,
                "device_ms": dev}
