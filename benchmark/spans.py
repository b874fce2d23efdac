"""The program's own spans and counters in a traced run of a matching
cell.

The program's tracer (``patch2pix_tpu_torch.utils.profiling``:
``tracing``, ``span``, ``count``, ``drain``) records spans around the
stages of a call (``backbone``, ``coarse``, ``fine``, and finer spans
inside them, such as ``coarse.ncn``), the rows its regressions work on,
and the set-up's constructors and kernel loads. Here:

* :func:`traced_setup` runs ``drv.setup()`` with tracing on and keeps
  the ``setup.*`` spans;
* :func:`phases` runs calls with tracing on: two that absorb a
  profiler's start, ``harness.GAP_CALLS`` under a host-and-device
  profiler (the idle gaps), then ``n`` with no profiler (the spans'
  device ms, the roots' host ms, the counters);
* :func:`gaps_by_stage` puts every device idle gap down to the stage
  the host was in when it began;
* :func:`read` gives the per-layer numbers, per call (reading the
  profile once, after the window).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from benchmark import harness, trace, window
from patch2pix_tpu_torch.utils import profiling

STAGES = ("backbone", "coarse", "fine")
# where a gap goes when the host is inside a root span (``predict_fine``,
# ``immatch``) but in no stage, and when it is outside every span
ENTRY, CALLER = "entry", "caller"


def traced_setup(drv, record: Dict) -> None:
    """``drv.setup()`` with tracing on; its ``setup.*`` spans go to
    ``record["setup_spans"]``."""
    profiling.drain()
    with profiling.tracing():
        drv.setup()
    record["setup_spans"] = [s for s in profiling.drain()["spans"]
                             if s["name"].startswith("setup.")]


def phases(drv, call: Callable[[int], object], start: int, n: int, device,
           record: Dict) -> int:
    """The traced calls ``start, start + 1, ...`` (``call(i)`` runs call
    i), with tracing on: 2 that absorb the profiler's start, then
    ``harness.GAP_CALLS`` under the host-and-device profiler, inside the
    host range ``trace.MARK``; then ``n`` with no profiler. Puts the
    profile (read by :func:`read`), the drained spans and counters of
    the last ``n`` calls and their count in ``record``. Returns the next
    call's index."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    gap_end = start + 2 + harness.GAP_CALLS
    profiling.drain()
    with profiling.tracing():
        with torch.profiler.profile(activities=acts) as host_prof:
            for i in range(start, start + 2):
                call(i)
            drv.finish()
            with torch.profiler.record_function(trace.MARK):
                for i in range(start + 2, gap_end):
                    call(i)
                drv.finish()
        names = {s["name"] for s in profiling.drain()["spans"]}
        for i in range(gap_end, gap_end + n):
            call(i)
        drv.finish()
    record["span_profile"] = (host_prof, names)
    record["span_trace"] = profiling.drain()
    record["span_calls"] = n
    return gap_end + n


def stage_of(name: str) -> Optional[str]:
    """``backbone``, ``coarse`` or ``fine`` for a span of that stage
    (``coarse.ncn`` is coarse), else None."""
    stage = name.split(".", 1)[0]
    return stage if stage in STAGES else None


def gaps_by_stage(events: Iterable, names,
                  mark: str = trace.MARK) -> Optional[Dict[str, float]]:
    """Seconds of device idle, every gap of any length between the
    device operations that start inside the host range ``mark``, by
    where the host was when the gap began: the stage of the innermost
    open span of ``names`` that has one, ``entry`` inside a span with
    none, ``caller`` outside every span. None without device
    operations."""
    events = list(events)
    lo = hi = None
    for ev in events:
        if ev.name == mark and ev.device_type == torch.autograd.DeviceType.CPU:
            lo, hi = ev.time_range.start, ev.time_range.end
    dev, spans = [], []
    for ev in events:
        tr = ev.time_range
        if ev.name == mark or ev.name in names:
            if ev.device_type == torch.autograd.DeviceType.CPU and ev.name in names:
                spans.append((tr.start, tr.end, stage_of(ev.name)))
            continue
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)
                and (lo is None or lo <= tr.start < hi)):
            dev.append((tr.start, tr.end))
    if not dev:
        return None
    totals = {key: 0.0 for key in (*STAGES, ENTRY, CALLER)}
    gaps = np.asarray(window.gaps(dev), dtype=np.float64).reshape(-1, 2)
    if spans:
        s0 = np.asarray([s[0] for s in spans])
        s1 = np.asarray([s[1] for s in spans])
        staged = np.asarray([s[2] is not None for s in spans])
    for g0, g1 in gaps:
        key = CALLER
        if spans:
            open_ = np.flatnonzero((s0 <= g0) & (s1 > g0))
            if len(open_):
                key = ENTRY
                with_stage = open_[staged[open_]]
                if len(with_stage):
                    key = spans[with_stage[np.argmax(s0[with_stage])]][2]
        totals[key] += (g1 - g0) / 1e6
    return totals


def outermost_ms(spans, stage_or_name: str) -> float:
    """Summed device ms of the spans of a stage (or of one name) that lie
    inside no other span of it."""
    by_id = {s["id"]: s for s in spans}

    def match(s):
        return s["name"] == stage_or_name or stage_of(s["name"]) == stage_or_name

    total = 0.0
    for s in spans:
        if not match(s):
            continue
        p = s["parent"]
        while p is not None and not match(by_id[p]):
            p = by_id[p]["parent"]
        if p is None:
            total += s["device_ms"]
    return total


def read(record: Dict) -> Dict[str, float]:
    """The per-layer numbers the record holds, each per call: stage and
    NCN spans' device ms (``*_span_ms.match``), the root spans' host ms
    (``enqueue_ms.match``), idle ms by stage and outside the program
    (``*_idle_ms.match``), the valid share of the regressions' rows
    (``fine_rows_useful_pct.match``), and the set-up's constructors' and
    kernel loads' host s (``construct_s.setup``, ``build_s.setup``)."""
    out: Dict[str, float] = {}
    setup = record.get("setup_spans")
    if setup is not None:
        out["construct_s.setup"] = sum(s["host_ms"] for s in setup
                                       if s["name"] == "setup.construct") / 1e3
        out["build_s.setup"] = sum(s["host_ms"] for s in setup
                                   if s["name"].startswith("setup.kernel_load.")) / 1e3
    drained = record.get("span_trace")
    if drained is None:
        return out
    n = record["span_calls"]
    spans, counters = drained["spans"], drained["counters"]
    present = {stage_of(s["name"]) for s in spans} - {None}
    if spans and all(s["device_ms"] is not None for s in spans):
        for stage in STAGES:
            if stage in present:
                out[f"{stage}_span_ms.match"] = outermost_ms(spans, stage) / n
        if any(s["name"] == "coarse.ncn" for s in spans):
            out["ncn_span_ms.match"] = outermost_ms(spans, "coarse.ncn") / n
    out["enqueue_ms.match"] = sum(s["host_ms"] for s in spans if s["parent"] is None) / n
    if counters.get("fine.rows"):
        out["fine_rows_useful_pct.match"] = (100.0 * counters["fine.valid_rows"]
                                             / counters["fine.rows"])
    if "span_profile" in record:
        host_prof, names = record.pop("span_profile")
        record["span_gaps"] = gaps_by_stage(host_prof.events(), names)
    gaps = record["span_gaps"]
    if gaps is not None:
        for key in (*STAGES, CALLER):
            if key in present or key == CALLER:
                out[f"{key}_idle_ms.match"] = 1e3 * gaps[key] / harness.GAP_CALLS
    return out
