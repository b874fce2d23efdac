"""A run with its timed path broken underneath comes out not correct,
and so does the control (the plain reference in float8 in the program's
place): the harness drives the rest of the run on the CPU, past its look
for a card, at a size a test can hold. The faults a match cell can have:
an answer altered where it is produced (a fine match, a coarse row that
leaves the grid or repeats a target cell, the validity or mutual flags,
a pick), and half of the batch left out.
A step that returns its state unchanged and the exchange between chips
belong to training and multi-chip cells, which this benchmark has not."""

import time

import numpy as np
import pytest

from benchmark import harness

SIZES = {"p2p_cs-match-b2": {"height": 64, "width": 96, "pool_pairs": 4},
         "ncnet_vgg16-match-b1": {"height": 128, "width": 160, "pool_pairs": 2}}


def run(cell_name, hook, seed=3):
    ov = {"traffic": SIZES[cell_name],
          "cell": {"warmup_calls": 1, "trace_calls": 1, "check_calls": 2}}
    if cell_name.startswith("p2p"):
        ov["cell"]["options"] = {"mutual": True, "ncn_thres": 0.0, "fine_cap": 16}
    cell = harness.Cell(cell_name, overrides=ov)
    return harness.run_cell(cell, seed, 0.01, False, "cpu", time.perf_counter(), hook)


def broken(transform):
    """A driver hook whose calls hand over ``transform(outputs)``."""
    def hook(drv):
        call = drv.call

        def altered(i):
            units, out = call(i)
            return units, transform(out)
        drv.call = altered
    return hook


def with_control(drv):
    drv.call = lambda i: (drv.traffic["batch"], drv.control(i))


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_sound_run_is_correct(cell):
    assert run(cell, None)["correct"]


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_control_is_not_correct(cell):
    res = run(cell, with_control)
    assert not res["correct"], res["checks"]


def shift_fine(out):
    out = dict(out, fine=out["fine"].copy())
    out["fine"][0, 0, 2] += 3.0  # one answer moved by three pixels
    return out


def worst_pick(out):
    # the most confident row's source cell moved across the grid
    out = dict(out, grid=out["grid"].copy())
    g = out["grid"][0]
    nb = len(g) // 2
    r = int(np.argmax(out["scores"][0][:nb]))
    g[r, 0], g[r, 1] = g[:, 0].max() - g[r, 0], g[:, 1].max() - g[r, 1]
    return out


def duplicate_coarse(out):
    # two rows name one target cell
    out = dict(out, coarse=out["coarse"].copy())
    out["coarse"][0, 1] = out["coarse"][0, 0]
    return out


def off_grid(out):
    # one coarse row a pixel off the cells' centres
    out = dict(out, coarse=out["coarse"].copy())
    out["coarse"][0, 0, 0] += 1.0
    return out


def all_valid(out):
    return dict(out, valid=np.ones_like(out["valid"]))


def all_mutual(out):
    return dict(out, mutual=np.ones_like(out["mutual"]))


def half_batch(out):
    # the second pair's matches are the first's: half of the batch left out
    return {k: np.concatenate([v[:1], v[:1]]) for k, v in out.items()}


@pytest.mark.parametrize("cell,fault", [("p2p_cs-match-b2", shift_fine),
                                        ("ncnet_vgg16-match-b1", worst_pick),
                                        ("p2p_cs-match-b2", half_batch),
                                        ("p2p_cs-match-b2", duplicate_coarse),
                                        ("p2p_cs-match-b2", off_grid),
                                        ("p2p_cs-match-b2", all_valid),
                                        ("ncnet_vgg16-match-b1", all_mutual)])
def test_fault_is_not_correct(cell, fault):
    res = run(cell, broken(fault))
    assert not res["correct"], res["checks"]


@pytest.mark.card
def test_control_fails_at_the_cells_own_size(card):
    """On the card: the control at the cells' own sizes, three seeds,
    fails at least one compared number on each."""
    from benchmark import calibrate

    for name in sorted(SIZES):
        cell = harness.Cell(name)
        for row in calibrate.readings(cell, (31, 32, 33), "control", card):
            limits = cell.cell["limits"]
            assert any(row["numbers"][k] > v for k, v in limits.items()), row
