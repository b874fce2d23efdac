"""The benchmark's run: find a cell's files by name, set up its driver,
measure the window, trace it, judge the outputs and read the metrics.

Everything that belongs to one configuration, traffic mix, cell, entry
driver or metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives:

* ``benchmark/configs/<config>.json``: the configuration as it is run;
* ``benchmark/traffic/<traffic>.json``: the traffic's parameters (batch,
  image size, the pool of seeded inputs);
* ``benchmark/workloads/<cell>.json``: the cell: its configuration,
  traffic, entry driver, the call's options, warm-up, traced calls,
  judged calls and the limits of its comparison;
* ``benchmark/drivers/<driver>.py``: a ``Driver`` class (set-up, one
  timed call, the stages a traced run times, the judge);
* ``benchmark/e2e_metrics/<metric>.py`` and
  ``benchmark/layer_metrics/<metric>.py``: ``read(record)``, which
  returns the metric's value, or None where the record holds nothing to
  read.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import trace as tracing

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell's entry in ``BENCHMARK.json`` with its files."""

    def __init__(self, name: str, root: Path = ROOT, overrides: Optional[Dict] = None):
        self.root = Path(root)
        self.spec = load_json(self.root / "BENCHMARK.json")
        entries = {w["name"]: w for w in self.spec["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(entries)}")
        self.name = name
        self.entry = entries[name]
        bench = self.root / "benchmark"
        self.cell = load_json(bench / "workloads" / f"{name}.json")
        for key in ("config", "traffic"):
            if self.cell[key] != self.entry[key]:
                raise ValueError(f"{name}: the cell file's {key} {self.cell[key]!r} is not "
                                 f"BENCHMARK.json's {self.entry[key]!r}")
        self.config = load_json(bench / "configs" / f"{self.entry['config']}.json")
        self.traffic = load_json(bench / "traffic" / f"{self.entry['traffic']}.json")
        for key, value in (overrides or {}).items():
            getattr(self, key).update(value)

    def metrics(self, kind: str) -> List[Dict]:
        """The ``end_to_end`` or ``per_layer`` entries this cell reports:
        those that list it, and those without a list whose ``moves``
        metric (end to end: themselves) it reports."""
        e2e = [m for m in self.spec["end_to_end"]
               if self.name in m.get("workloads", [self.name])]
        if kind == "end_to_end":
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in names)]

    def driver(self, seed: int, device):
        return load(self.root, "drivers", self.cell["driver"]).Driver(self, seed, device)


def load(root: Path, kind: str, name: str):
    """The module ``benchmark/<kind>/<name>.py`` under ``root``, loaded by
    path (metric names hold dots)."""
    path = Path(root) / "benchmark" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, kind: str, name: str) -> Callable[[Dict], Optional[float]]:
    """``read`` of the metric file ``benchmark/<kind>/<name>.py``."""
    return load(root, kind, name).read


class StageTimer:
    """CUDA events around the calls of named stages (bound methods
    wrapped on their instance) during the traced calls."""

    def __init__(self, stages: Dict[str, List], device):
        self.stages = stages
        self.cuda = torch.device(device).type == "cuda"
        self.events: Dict[str, List] = {name: [] for name in stages}
        self._saved = []

    def __enter__(self):
        for name, sites in self.stages.items():
            for obj, attr in sites:
                orig = getattr(obj, attr)
                self._saved.append((obj, attr, vars(obj).get(attr)))
                setattr(obj, attr, self._wrap(name, orig))
        return self

    def _wrap(self, name, fn):
        def timed(*a, **k):
            if not self.cuda:
                return fn(*a, **k)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            self.events[name].append((start, end))
            return out
        return timed

    def __exit__(self, *exc):
        for obj, attr, own in reversed(self._saved):
            if own is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, own)

    def ms_per_call(self, calls: int) -> Dict[str, float]:
        if self.cuda:
            torch.cuda.synchronize()
        return {name: sum(s.elapsed_time(e) for s, e in ev) / calls
                for name, ev in self.events.items() if ev}


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_process: float, driver_hook: Optional[Callable] = None) -> Dict:
    """One run: set-up, the window, the judge. Returns the result line's
    dict, and the compared numbers under ``checks``."""
    drv = cell.driver(seed, device)
    if driver_hook is not None:
        driver_hook(drv)
    drv.setup()
    record: Dict = {"cell": cell.name, "config": cell.config, "traffic": cell.traffic,
                    "options": cell.cell.get("options", {}), "seed": seed}
    calls, outs, failed = [], [], 0
    n_traced = cell.cell["trace_calls"] if traced else 0
    t_start = time.perf_counter()
    record["setup_s"] = t_start - t_process
    deadline = t_start + seconds

    def one(i):
        nonlocal failed
        t0 = time.perf_counter()
        try:
            units, out = drv.call(i)
        except Exception as exc:  # a failed call counts and the window goes on
            print(f"call {i} failed: {exc!r}", file=sys.stderr, flush=True)
            failed += 1
            units, out = 0, None
        calls.append((t0, time.perf_counter(), units))
        outs.append(out)

    i = 0
    if traced:
        i = traced_phase(drv, device, n_traced, one, record, outs)
    t_plain = time.perf_counter()
    n_plain = len(calls)
    # a traced run makes as many plain calls as it traced, past the
    # deadline if its profiles took the window: the whole-call metrics
    # read them
    min_plain = n_traced if traced else 1
    while time.perf_counter() < deadline or len(calls) - n_plain < min_plain:
        one(i)
        i += 1
    drv.finish()
    t_end = time.perf_counter()
    record["calls"] = calls
    record["window"] = (t_start, t_end)
    # the calls after the traced phases: no profiler, no stage events
    record["plain"] = {"calls": len(calls) - n_plain, "seconds": record["window"][1] - t_plain}
    if traced:
        read_traces(record)
    record.update(drv.counters())
    peak = drv.memory_peak()
    drv.free_program()
    checks, correct = judge(cell, drv, outs, seed, failed)
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell.metrics(kind):
        value = reader(cell.root, "layer_metrics" if traced else "e2e_metrics", m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = drv.device_info(peak)
    if traced:
        device_info["busy_s"] = record["trace"]["busy_s"]
        device_info["window_s"] = record["trace"]["window_s"]
    result = {"correct": correct, "attempted": len(calls), "failed": failed,
              "metrics": metrics, "device": device_info}
    if traced:
        result["breakdown"] = {k: record["trace"][k] for k in ("device_ops", "idle_gaps")}
    result["checks"] = checks
    return result


GAP_CALLS = 5


def traced_phase(drv, device, n: int, one, record: Dict, outs) -> int:
    """The traced run's first phases, each inside the window: ``n`` calls
    under the profiler recording device operations alone (their span on
    the device is the traced window, the union of their intervals the
    busy time); ``GAP_CALLS`` calls, after two that absorb its start, under
    the profiler recording host operations too, whose idle gaps are
    named by what the host was doing; ``n`` calls with CUDA events
    around the driver's stages. The profiles are read once the window
    has closed (:func:`read_traces`). Returns the next call's index."""
    cuda = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CUDA if cuda else torch.profiler.ProfilerActivity.CPU]
    i = 0
    with torch.profiler.profile(activities=acts) as device_prof:
        t0 = time.perf_counter()
        for i in range(n):
            one(i)
        drv.finish()
        host_s = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA]
                                                    if cuda else [])
    with torch.profiler.profile(activities=acts) as host_prof:
        for i in range(n, n + 2):
            one(i)
        drv.finish()
        with torch.profiler.record_function(tracing.MARK):
            for i in range(n + 2, n + 2 + GAP_CALLS):
                one(i)
            drv.finish()
    record["profiles"] = (device_prof, host_prof, host_s, n)
    record["traced_outputs"] = outs[:n]
    start = n + 2 + GAP_CALLS
    timer = StageTimer(drv.stages(), device)
    with timer:
        for i in range(start, start + n):
            one(i)
        drv.finish()
    record["stages_ms"] = timer.ms_per_call(n)
    return start + n


def read_traces(record: Dict) -> None:
    device_prof, host_prof, host_s, n = record.pop("profiles")
    trace = tracing.read_device(device_prof.events())
    if trace["window_s"] <= 0:
        trace["window_s"] = host_s
    trace["calls"] = n
    trace["idle_gaps"] = tracing.read_events(host_prof.events())["idle_gaps"]
    record["trace"] = trace


def judge(cell: Cell, drv, outs, seed: int, failed: int):
    """Judge a sample of the window's calls, drawn from the seed, against
    the plain reference. Returns ({number: {value, limit}}, correct)."""
    limits = cell.cell["limits"]
    done = [i for i, o in enumerate(outs) if o is not None]
    rng = np.random.default_rng(int(seed))
    n = min(cell.cell["check_calls"], len(done))
    picked = sorted(rng.choice(done, size=n, replace=False).tolist()) if n else []
    judged = [drv.judge(i, outs[i]) for i in picked]
    worst = {name: 0.0 for name in limits}
    for numbers in judged:
        for name, value in numbers.items():
            value = float(value) if np.isfinite(value) else float("inf")
            worst[name] = max(worst.get(name, 0.0), value)
    checks = {name: {"value": worst[name], "limit": limits[name]} for name in limits}
    correct = (failed == 0 and bool(judged)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    return checks, correct
