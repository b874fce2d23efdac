"""NCNet's InLoc cell (``ncnet_r101_inloc-match-b1``) through
``harness.run_cell`` on the CPU at a size a test can hold (a pooled
volume of 8x10 cells a side): the sound run is correct; the control (the
plain reference in float8 in the program's place) is not, nor is the
reference with its NCN alone in float8, nor a run whose relocated cells
leave their windows' maxima, whose most confident pick moves across the
grid, whose every flag reads mutual, or whose every score is half as
large again. On the card, both controls at the cell's own size fail on
three seeds each."""

import time

import pytest

from benchmark import harness
from benchmark.reference import ncnet_r101_judge
from benchmark.tests.test_bench_faults import all_mutual, broken, with_control, worst_pick

CELL = "ncnet_r101_inloc-match-b1"
SIZE = {"height": 256, "width": 320, "pool_pairs": 2, "max_shift": 20}


def run(hook=None, seed=3):
    ov = {"traffic": SIZE, "cell": {"warmup_calls": 1, "trace_calls": 1, "check_calls": 2}}
    cell = harness.Cell(CELL, overrides=ov)
    return harness.run_cell(cell, seed, 0.01, False, "cpu", time.perf_counter(), hook)


def off_window_max(out):
    # every relocated cell moved to its neighbour along xA inside its window
    out = dict(out, grid=out["grid"].copy())
    out["grid"][..., 0] ^= 1
    return out


def scaled_scores(out):
    # every score half as large again: the softmax's sum off by a factor.
    # score_err reads log 1.5 over the volume's largest value, so at the
    # cell's own size it fails only where that value is under 2.9
    return dict(out, scores=out["scores"] * 1.5)


def with_ncn_control(drv):
    drv.call = lambda i: (drv.traffic["batch"], drv.control(i, "ncn_fp8"))


def test_sound_run_is_correct():
    res = run()
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(ncnet_r101_judge.NUMBERS)


def test_control_is_not_correct():
    res = run(with_control)
    assert not res["correct"], res["checks"]


def test_ncn_alone_in_float8_is_not_correct():
    res = run(with_ncn_control)
    assert not res["correct"], res["checks"]
    assert res["checks"]["reloc_gap"]["value"] == 0


@pytest.mark.parametrize("fault", [off_window_max, worst_pick, all_mutual, scaled_scores])
def test_fault_is_not_correct(fault):
    res = run(broken(fault))
    assert not res["correct"], res["checks"]


@pytest.mark.card
def test_control_fails_at_the_cells_own_size(card):
    """On the card: the control at the cell's own size, three seeds,
    fails at least one compared number on each."""
    from benchmark import calibrate

    cell = harness.Cell(CELL)
    for row in calibrate.readings(cell, (41, 42, 2 ** 31 + 43), "control", card):
        limits = cell.cell["limits"]
        assert any(row["numbers"][k] > v for k, v in limits.items()), row


@pytest.mark.card
def test_ncn_control_fails_at_the_cells_own_size(card):
    """On the card: the reference with its NCN alone in float8, at the
    cell's own size, three seeds, fails at least one compared number on
    each."""
    cell = harness.Cell(CELL)
    limits = cell.cell["limits"]
    for seed in (44, 45, 2 ** 31 + 46):
        drv = cell.driver(seed, card)
        drv.setup()
        drv.free_program()
        worst = {}
        for i in range(cell.cell["check_calls"]):
            for k, v in drv.judge(i, drv.control(i, "ncn_fp8")).items():
                worst[k] = max(worst.get(k, 0.0), v)
        assert any(worst[k] > v for k, v in limits.items()), (seed, worst)
        del drv
