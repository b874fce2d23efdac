"""The program's spans and counters as the benchmark reads them
(``benchmark/spans.py``): idle gaps put down to the innermost program
span open at their start and rolled up to its stage, a gap outside every
span to the caller, short gaps kept; the per-layer numbers of a drained
record; a traced run of each cell with the span phases, whose harness
phases run with tracing off."""

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, spans, trace
from patch2pix_tpu_torch.utils import profiling

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
NAMES = {"predict_fine", "backbone", "coarse", "coarse.ncn", "fine", "fine.mid"}


def ev(name, device, start, end, annotation=False):
    return SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def test_gaps_go_to_the_innermost_span_rolled_up_to_its_stage():
    host = [ev(trace.MARK, CPU, 0, 1000, True), ev("predict_fine", CPU, 10, 900, True),
            ev("backbone", CPU, 20, 100, True), ev("coarse", CPU, 100, 400, True),
            ev("coarse.ncn", CPU, 150, 300, True), ev("fine", CPU, 420, 800, True),
            ev("fine.mid", CPU, 430, 700, True), ev("aten::copy_", CPU, 955, 985)]
    ops = [(-50, -40), (30, 50), (60, 65), (110, 120), (200, 260), (310, 330), (340, 405),
           (415, 430), (720, 750), (950, 960), (980, 990), (1010, 1020)]
    device = [ev(f"kernel{i}", CUDA, s, e) for i, (s, e) in enumerate(ops)]
    device.append(ev("coarse", CUDA, 120, 200, True))  # a span's device-side annotation
    got = spans.gaps_by_stage(host + device, NAMES)
    want_us = {"backbone": 10 + 45,   # a 10 us gap is kept
               "coarse": 80 + 50 + 10,  # 260-310 opens inside coarse.ncn
               "entry": 10,          # 405-415: in predict_fine, between stages
               "fine": 290 + 200,
               "caller": 20}         # 960-980: predict_fine has returned
    assert got == pytest.approx({k: v / 1e6 for k, v in want_us.items()})
    assert spans.gaps_by_stage(host, NAMES) is None


def _record():
    def s(i, name, parent, call, host, dev):
        return {"name": name, "id": i, "parent": parent, "call": call, "start_ns": 0,
                "end_ns": 0, "host_ms": host, "device_ms": dev}

    drained = [s(0, "immatch", None, 0, 4.0, 90.0), s(1, "backbone", 0, 0, 1.0, 5.0),
               s(2, "coarse", 0, 0, 2.5, 80.0), s(3, "coarse.ncn", 2, 0, 2.0, 70.0),
               s(4, "coarse.extract", None, 4, 1.0, 6.0)]
    setup = [s(9, "setup.construct", None, 9, 1500.0, None),
             s(10, "setup.kernel_load.tap_sum", 11, 11, 4000.0, None),
             s(12, "setup.nvcc", 10, 11, 3900.0, None),
             s(13, "setup.kernel_load.conv4d", 11, 11, 6000.0, None)]
    return {"setup_spans": setup, "span_calls": 2, "span_gaps": None,
            "span_trace": {"spans": drained, "counters": {"fine.rows": 40,
                                                          "fine.valid_rows": 10}}}


def test_read_gives_per_call_numbers():
    got = spans.read(_record())
    assert got == pytest.approx({
        "construct_s.setup": 1.5, "build_s.setup": 10.0,
        "backbone_span_ms.match": 2.5, "coarse_span_ms.match": 43.0,  # 80 + 6, a root extract
        "ncn_span_ms.match": 35.0, "enqueue_ms.match": 2.5,
        "fine_rows_useful_pct.match": 25.0})
    rec = _record()
    rec["span_gaps"] = {"backbone": 1e-3, "coarse": 2e-3, "fine": 0.0, "entry": 0.0,
                        "caller": 4e-3}
    got = spans.read(rec)
    assert (got["backbone_idle_ms.match"], got["coarse_idle_ms.match"],
            got["caller_idle_ms.match"]) == pytest.approx((0.2, 0.4, 0.8))
    assert "fine_idle_ms.match" not in got and "fine_span_ms.match" not in got
    assert spans.read({}) == {}


def _traced_run(cell_name, device):
    """A traced run of the cell at a tiny size, with the span set-up and
    phases put before the window through ``run_cell``'s hook.
    Returns (result, span record, tracing state at each harness call)."""
    ov = {"traffic": {"height": 64, "width": 96, "pool_pairs": 2},
          "cell": {"warmup_calls": 1, "trace_calls": 1, "check_calls": 1}}
    if cell_name.startswith("p2p"):
        ov["cell"]["options"] = {"mutual": True, "ncn_thres": 0.0, "fine_cap": 16}
    rec, states = {}, []

    def hook(drv):
        setup, call = drv.setup, drv.call
        inside = []

        def traced_setup():  # its warm-up and phases are not the harness's
            inside.append(True)
            spans.traced_setup(SimpleNamespace(setup=setup), rec)
            spans.phases(drv, call, 0, 2, device, rec)
            inside.clear()

        def spied(i):
            if not inside:
                states.append(profiling._on)
            return call(i)

        drv.setup, drv.call = traced_setup, spied

    res = harness.run_cell(harness.Cell(cell_name, overrides=ov), 2**31 + 17, 0.01, True,
                           device, time.perf_counter(), driver_hook=hook)
    return res, rec, states


CELLS = ["p2p_cs-match-b2", "ncnet_vgg16-match-b1"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_the_spans_with_its_own_phases_untraced(cell):
    res, rec, states = _traced_run(cell, "cpu")
    assert res["correct"] and set(res["metrics"]) == {"mfu.match"}
    assert states and not any(states)
    got = spans.read(rec)
    want = {"construct_s.setup", "build_s.setup", "enqueue_ms.match"}
    if cell.startswith("p2p"):
        want.add("fine_rows_useful_pct.match")
        assert 0 < got["fine_rows_useful_pct.match"] <= 100
    assert set(got) == want  # no device number on the CPU
    assert got["build_s.setup"] == 0.0 and got["construct_s.setup"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_on_the_card_reads_every_span_metric(card, cell):
    res, rec, states = _traced_run(cell, card)
    got = spans.read(rec)
    stages = ("backbone", "coarse", "fine") if cell.startswith("p2p") else ("backbone", "coarse")
    want = {"construct_s.setup", "build_s.setup", "enqueue_ms.match", "ncn_span_ms.match",
            "caller_idle_ms.match"}
    want |= {f"{s}_span_ms.match" for s in stages} | {f"{s}_idle_ms.match" for s in stages}
    if cell.startswith("p2p"):
        want.add("fine_rows_useful_pct.match")
    assert res["correct"] and set(got) == want
    assert not any(states)
    assert 0 < got["ncn_span_ms.match"] < got["coarse_span_ms.match"]
