"""Window arithmetic: rates over all work and time, percentiles over
every call, the idle share and the naming of idle gaps."""

import pytest

from benchmark import readers, trace, window


def test_rate_is_all_work_over_all_time():
    calls = [(0.0, 0.5, 2), (0.5, 0.75, 2), (0.75, 2.0, 2)]
    assert window.rate([c[2] for c in calls], 0.0, 2.0) == pytest.approx(3.0)


def test_p95_covers_every_call():
    lat = list(range(1, 101))
    assert window.percentile(lat, 95) == pytest.approx(95.05)
    # 11 slow calls in 200 set the 95th percentile; a median of chunks would not see them
    lat = [10.0] * 189 + [100.0] * 11
    assert window.percentile(lat, 95) == pytest.approx(100.0)


def test_busy_merges_overlaps_and_a_planted_stall_moves_idle():
    ops = [(0, 10), (5, 20), (20, 30), (40, 50)]
    assert window.busy(ops) == 40
    assert window.gaps(ops) == [(30, 40)]
    rec = {"trace": {"busy_s": 40e-6, "window_s": 50e-6, "calls": 1}}
    base = readers.idle_pct(rec)
    stalled = [(s + (15 if s >= 40 else 0), e + (15 if s >= 40 else 0)) for s, e in ops]
    rec2 = {"trace": {"busy_s": window.busy(stalled) / 1e6, "window_s": 65e-6, "calls": 1}}
    assert base == pytest.approx(20.0)
    assert readers.idle_pct(rec2) == pytest.approx(100 * 25 / 65)


def test_gaps_are_named_by_the_host_operation_open_at_their_start():
    gaps = [(100.0, 200.0), (300.0, 305.0), (400.0, 460.0)]
    host = [(90.0, 210.0, "aten::nonzero"), (95.0, 150.0, "cudaMemcpyAsync"),
            (390.0, 470.0, "aten::item"), (0.0, 1000.0, "predict_fine")]
    named = dict(trace.name_gaps(gaps, host))
    assert named["aten::nonzero"] == pytest.approx(100e-6)
    assert named["aten::item"] == pytest.approx(60e-6)
    assert named[f"gaps under {trace.GAP_MIN_US:g} us"] == pytest.approx(5e-6)


def test_a_traced_run_makes_its_plain_calls_past_a_spent_window():
    """The profiles may take the whole window; the traced run still makes
    as many plain calls as it traced, and reports the whole-call share."""
    import time

    from benchmark import harness

    ov = {"traffic": {"height": 64, "width": 96, "pool_pairs": 4},
          "cell": {"warmup_calls": 1, "trace_calls": 2, "check_calls": 1,
                   "options": {"mutual": True, "ncn_thres": 0.0, "fine_cap": 16}}}
    cell = harness.Cell("p2p_cs-match-b2", overrides=ov)
    res = harness.run_cell(cell, 7, 0.0, True, "cpu", time.perf_counter())
    assert res["attempted"] >= 2 * 2 + 7 + 2  # traced phases, then two plain calls
    assert res["metrics"]["mfu.match"]["value"] > 0
