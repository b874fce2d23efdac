"""Reading a ``torch.profiler`` trace of the device: time by kernel
name, the busy time (the union of every device operation's interval),
and the idle gaps between device operations, named by the host
operation that was running when each gap began."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark import window

GAP_MIN_US = 20.0  # gaps shorter than this are summed under one name
TOP = 10


MARK = "benchmark traced window"


def read_events(events, mark: str = MARK) -> Dict:
    """``kernels``, ``busy_s``, ``device_ops`` and ``idle_gaps`` (top-10
    [name, seconds] lists) of the device operations that start inside
    the host range named ``mark`` (each clipped to it)."""
    events = list(events)
    lo = hi = None
    for ev in events:
        if ev.name == mark and ev.device_type == torch.autograd.DeviceType.CPU:
            lo, hi = ev.time_range.start, ev.time_range.end
    dev, host = [], []
    kernels: Dict[str, List[float]] = {}
    for ev in events:
        tr = ev.time_range
        if ev.name == mark or getattr(ev, "is_user_annotation", False):
            continue
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if lo is not None and not lo <= tr.start < hi:
                continue
            end = tr.end if hi is None else min(tr.end, hi)
            dev.append((tr.start, end))
            k = kernels.setdefault(ev.name, [0.0, 0])
            k[0] += (end - tr.start) / 1e6
            k[1] += 1
        elif tr.end > tr.start:
            host.append((tr.start, tr.end, ev.name))
    out = {"kernels": kernels, "busy_s": window.busy(dev) / 1e6}
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    out["device_ops"] = [[name[:160], s] for name, (s, _) in ranked]
    out["idle_gaps"] = name_gaps(window.gaps(dev), host)
    return out


def read_device(events) -> Dict:
    """``kernels`` {name: [seconds, launches]}, ``busy_s`` (the union of
    the device operations' intervals), ``window_s`` (from the first
    operation's start to the last one's end) and ``device_ops`` (the
    top 10 [name, seconds])."""
    dev = []
    kernels: Dict[str, List[float]] = {}
    for ev in events:
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        tr = ev.time_range
        dev.append((tr.start, tr.end))
        k = kernels.setdefault(ev.name, [0.0, 0])
        k[0] += (tr.end - tr.start) / 1e6
        k[1] += 1
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    span = (max(e for _, e in dev) - min(s for s, _ in dev)) / 1e6 if dev else 0.0
    return {"kernels": kernels, "busy_s": window.busy(dev) / 1e6, "window_s": span,
            "device_ops": [[name[:160], s] for name, (s, _) in ranked]}


def name_gaps(gaps, host) -> List[List]:
    """Sum the gaps by the innermost host operation (preferring one that
    is not a CUDA runtime call) open at each gap's start."""
    totals: Dict[str, float] = {}
    if not gaps:
        return []
    g = np.asarray(gaps, dtype=np.float64)
    short = (g[:, 1] - g[:, 0]) < GAP_MIN_US
    if short.any():
        totals[f"gaps under {GAP_MIN_US:g} us"] = float((g[short, 1] - g[short, 0]).sum()) / 1e6
    g = g[~short]
    if host and len(g):
        hs = np.asarray([h[0] for h in host])
        he = np.asarray([h[1] for h in host])
        names = [h[2] for h in host]
        runtime = np.asarray([n.startswith("cuda") for n in names])
        dur = he - hs
        for i in range(0, len(g), 256):
            chunk = g[i:i + 256]
            open_ = (hs[None, :] <= chunk[:, :1]) & (he[None, :] > chunk[:, :1])
            for row, (s, e) in zip(open_, chunk):
                idx = np.flatnonzero(row)
                pick = idx[~runtime[idx]] if (~runtime[idx]).any() else idx
                name = names[pick[np.argmin(dur[pick])]] if len(pick) else "no host operation"
                totals[name] = totals.get(name, 0.0) + (e - s) / 1e6
    elif len(g):
        totals["no host operation"] = float((g[:, 1] - g[:, 0]).sum()) / 1e6
    return [[n, s] for n, s in sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]
