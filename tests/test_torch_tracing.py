"""The port's tracer (``utils.profiling``: ``tracing``, ``span``,
``count``, ``drain``) on its main paths, on the CPU.

  * off, ``predict_fine``, ``ImMatchNet`` + ``corr_to_matches`` and the
    train step create no CUDA event, enter no ``record_function``, make
    no sync and record no span, and their outputs equal a traced run's
    bit for bit (the spies are shown to work by the traced run, with
    CUDA faked as in use);
  * on, ``predict_fine``'s span tree has the stage names, parents and
    one call id; every aten op of both matching paths lies inside a
    ``backbone``, ``coarse`` or ``fine`` span; the row counters equal
    the returned ``Matches``' counts; ImMatchNet's tree nests the
    correlation, the relocalising pool and the NCN under ``coarse``, the
    NCN holds one ``coarse.ncn.<route>`` span a layer and direction, and
    ``corr_to_matches`` is a root of its own; ``conv4d.xla_taps`` counts
    one per-tap layer call a direction; the
    train step has its phase spans, ``train.allreduce`` only with a
    group; a library's first load is ``setup.kernel_load.<name>`` with
    ``setup.nvcc`` and ``kernels.nvcc_runs`` when it compiles; ``drain``
    clears.
"""

import copy
import subprocess

import numpy as np
import pytest
import torch

from patch2pix_tpu_torch.config import ModelConfig, OptimConfig, RegressorConfig
from patch2pix_tpu_torch.data.synthetic import synthetic_batch
from patch2pix_tpu_torch.models.immatch_net import ImMatchNet
from patch2pix_tpu_torch.models.ncn import NeighConsensus
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
from patch2pix_tpu_torch.ops import _build
from patch2pix_tpu_torch.ops.match_extract import corr_to_matches
from patch2pix_tpu_torch.parallel.mesh import Mesh
from patch2pix_tpu_torch.train import create_train_state, make_train_step
from patch2pix_tpu_torch.utils import profiling
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

H, W = 64, 96
STAGES = ("backbone", "coarse", "fine")


@pytest.fixture(autouse=True)
def clean_tracer():
    profiling.drain()
    yield
    profiling.drain()


def _p2p():
    cfg = ModelConfig(change_stride=True,
                      regressor=RegressorConfig(conv_dims=(64, 64), fc_dims=(64, 32))).resolved()
    cfg.regressor.panc = 1
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return Patch2Pix(cfg, device="cpu")


@pytest.fixture(scope="module")
def p2p():
    return _p2p()


@pytest.fixture(scope="module")
def ncnet():
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        return ImMatchNet(ncons_kernel_sizes=(3, 3), ncons_channels=(4, 1), device="cpu")


@pytest.fixture(scope="module")
def ncnet_reloc():
    """ImMatchNet with relocalisation and NCNet's InLoc NCN: its 16 -> 16
    layer takes the per-tap route."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(2)
        return ImMatchNet(ncons_kernel_sizes=(3, 3, 3), ncons_channels=(16, 16, 1),
                          relocalization_k_size=2, device="cpu")


def _images(seed, b=2):
    g = torch.Generator().manual_seed(seed)
    base = torch.rand(b, H, W + 8, 3, generator=g)
    return base[:, :, :W].contiguous(), base[:, :, 8:].contiguous()


P2P_PAIRS = _images(3)
NCNET_PAIR = _images(4, b=1)


def _run_p2p(model, fine_cap=12):
    return model.predict_fine(*P2P_PAIRS, ksize=2, fine_cap=fine_cap)


def _run_immatch(model):
    im1, im2 = NCNET_PAIR
    with torch.inference_mode():
        corr, delta = model(im1, im2)
        return corr_to_matches(corr, delta, ksize=model.relocalization_k_size or 1)


def _run_train(model):
    """One train step on a copy of ``model``; the metrics and the
    parameters after it."""
    model = copy.deepcopy(model)
    state = create_train_state(model, OptimConfig(lr_init=5e-4))
    step = make_train_step(model, state.optimizer, ksize=2, ptmax=8)
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(np.random.RandomState(0), 2, H, W).items()}
    _, met = step(state, batch, rand=torch.rand(2, 48, generator=torch.Generator().manual_seed(5)))
    return list(met.values()) + [p.detach() for p in model.parameters()]


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


class FakeEvent:
    made = 0

    def __init__(self, enable_timing=False):
        FakeEvent.made += 1

    def record(self):
        pass

    def elapsed_time(self, other):
        return 1.0


@pytest.mark.parametrize("path", ["predict_fine", "immatch", "train_step", "immatch_reloc"])
def test_off_path_touches_nothing_and_equals_the_traced_run(monkeypatch, p2p, ncnet, ncnet_reloc,
                                                            path):
    entered, syncs = [], []
    real_rf = torch.profiler.record_function

    def spy_rf(name, *a, **k):
        entered.append(name)
        return real_rf(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", spy_rf)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(a))
    monkeypatch.setattr(profiling, "_cuda_in_use", lambda: True)
    run = {"predict_fine": lambda: _run_p2p(p2p), "immatch": lambda: _run_immatch(ncnet),
           "train_step": lambda: _run_train(_p2p()),
           "immatch_reloc": lambda: _run_immatch(ncnet_reloc)}[path]
    FakeEvent.made = 0
    off = _flat(run())
    assert (entered, FakeEvent.made, syncs) == ([], 0, [])
    assert profiling.drain()["spans"] == []
    with profiling.tracing():
        on = _flat(run())
    spans = profiling.drain()["spans"]
    assert spans and FakeEvent.made == 2 * len(spans) and len(syncs) == 1
    assert {s["name"] for s in spans} <= set(entered)
    assert len(off) == len(on) and all(torch.equal(a, b) for a, b in zip(off, on))


def test_predict_fine_span_tree(p2p):
    with profiling.tracing():
        _run_p2p(p2p)
    spans = profiling.drain()["spans"]
    by_id = {s["id"]: s for s in spans}
    tree = [(s["name"], by_id[s["parent"]]["name"] if s["parent"] is not None else None)
            for s in spans]
    # the NCN (3, 3)/(16, 1) in float32: a span a layer and direction
    ncn = [("coarse.ncn.fold_in", "coarse.ncn"), ("coarse.ncn.fold_out", "coarse.ncn")] * 2
    assert tree == [("predict_fine", None), ("backbone", "predict_fine"),
                    ("coarse", "predict_fine"), ("coarse.corr", "coarse"),
                    ("coarse.ncn", "coarse"), *ncn, ("coarse.extract", "coarse"),
                    ("fine", "predict_fine"), ("fine.cap", "fine"), ("fine.mid", "fine"),
                    ("fine.fine", "fine")]
    assert {s["call"] for s in spans} == {spans[0]["id"]}
    for s in spans:
        assert s["end_ns"] >= s["start_ns"] and s["device_ms"] is None
        if s["parent"] is not None:
            parent = by_id[s["parent"]]
            assert parent["start_ns"] <= s["start_ns"] and s["end_ns"] <= parent["end_ns"]


@pytest.mark.parametrize("path", ["predict_fine", "immatch", "immatch_reloc"])
def test_every_op_lies_inside_a_stage(p2p, ncnet, ncnet_reloc, path):
    run = {"predict_fine": lambda: _run_p2p(p2p), "immatch": lambda: _run_immatch(ncnet),
           "immatch_reloc": lambda: _run_immatch(ncnet_reloc)}[path]
    with profiling.tracing(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    names = {s["name"] for s in profiling.drain()["spans"]}
    events = list(prof.events())
    stages = [(e.time_range.start, e.time_range.end) for e in events
              if e.name in names and e.name.split(".")[0] in STAGES]
    ops = [e for e in events if e.name.startswith("aten::")]
    assert len(ops) > 100 and len(stages) >= 3
    outside = [e.name for e in ops
               if not any(a <= e.time_range.start and e.time_range.end <= b for a, b in stages)]
    assert outside == []


@pytest.mark.parametrize("fine_cap", [None, 5])
def test_row_counters_equal_the_returned_matches(p2p, fine_cap):
    uncapped = int(_run_p2p(p2p, fine_cap=None)[2].valid.sum())
    with profiling.tracing():
        fine, mid, cm = _run_p2p(p2p, fine_cap=fine_cap)
    counters = profiling.drain()["counters"]
    assert counters["coarse.valid_rows"] == uncapped > 0
    assert counters["fine.rows"] == 2 * cm.valid.numel()
    assert counters["fine.valid_rows"] == 2 * int(fine.valid.sum()) == 2 * int(mid.valid.sum())
    if fine_cap is not None:
        assert cm.valid.shape[1] == fine_cap and int(cm.valid.sum()) < uncapped


def test_immatch_span_tree(ncnet):
    with profiling.tracing():
        _run_immatch(ncnet)
    spans = profiling.drain()["spans"]
    by_id = {s["id"]: s for s in spans}
    tree = [(s["name"], by_id[s["parent"]]["name"] if s["parent"] is not None else None)
            for s in spans]
    ncn = [("coarse.ncn.fold_in", "coarse.ncn"), ("coarse.ncn.fold_out", "coarse.ncn")] * 2
    assert tree == [("immatch", None), ("backbone", "immatch"), ("coarse", "immatch"),
                    ("coarse.corr", "coarse"), ("coarse.ncn", "coarse"), *ncn,
                    ("coarse.extract", None)]
    assert [s["call"] for s in spans] == [spans[0]["id"]] * 9 + [spans[9]["id"]]


def test_relocalising_immatch_span_tree(ncnet_reloc):
    with profiling.tracing():
        _run_immatch(ncnet_reloc)
    out = profiling.drain()
    spans = out["spans"]
    by_id = {s["id"]: s for s in spans}
    tree = [(s["name"], by_id[s["parent"]]["name"] if s["parent"] is not None else None)
            for s in spans]
    ncn = [("coarse.ncn.fold_in", "coarse.ncn"), ("coarse.ncn.xla_taps", "coarse.ncn"),
           ("coarse.ncn.fold_out", "coarse.ncn")] * 2
    assert tree == [("immatch", None), ("backbone", "immatch"), ("coarse", "immatch"),
                    ("coarse.corr", "coarse"), ("coarse.reloc", "coarse"),
                    ("coarse.ncn", "coarse"), *ncn, ("coarse.extract", None)]
    assert out["counters"] == {"conv4d.fold_in": 2, "conv4d.xla_taps": 2}


@pytest.mark.parametrize("symmetric", [True, False])
def test_xla_taps_counts_each_direction(symmetric):
    """A (16, 16, 1) NCN call runs its 16 -> 16 layer once a direction."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        ncn = NeighConsensus((3, 3, 3), (16, 16, 1), symmetric_mode=symmetric, device="cpu")
        corr = torch.rand(1, 3, 4, 3, 4)
    with profiling.tracing(), torch.no_grad():
        ncn(corr)
    counters = profiling.drain()["counters"]
    assert counters["conv4d.xla_taps"] == (2 if symmetric else 1)


@pytest.mark.parametrize("group", [False, True], ids=["alone", "group"])
def test_train_step_phase_spans(monkeypatch, group):
    model = _p2p()
    mesh = None
    if group:  # a group of one: its collectives are the identity
        monkeypatch.setattr(torch.distributed, "all_reduce", lambda t, **k: None)
        mesh = Mesh("data", 1, 0, torch.device("cpu"), group=object())
    state = create_train_state(model, OptimConfig(lr_init=5e-4))
    step = make_train_step(model, state.optimizer, ksize=2, ptmax=8, mesh=mesh)
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(np.random.RandomState(0), 2, H, W).items()}
    with profiling.tracing():
        step(state, batch, generator=torch.Generator().manual_seed(0))
    spans = profiling.drain()["spans"]
    by_id = {s["id"]: s for s in spans}
    phases = [s["name"] for s in spans if s["parent"] is not None
              and by_id[s["parent"]]["name"] == "train.step"]
    want = ["train.forward", "train.loss", "train.backward"]
    want += ["train.allreduce"] * group + ["train.optimizer"]
    assert phases == want
    assert [s["name"] for s in spans if s["parent"] is None] == ["train.step"]
    assert {s["call"] for s in spans} == {spans[0]["id"]}


def test_kernel_load_span_and_nvcc_runs(monkeypatch, tmp_path):
    runs = []

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, **kw):
            runs.append(cmd)
            open(cmd[cmd.index("-o") + 1], "wb").close()

        def communicate(self):
            return "ptxas info", None

    class FakeLib:
        def __getattr__(self, fn):
            return type("F", (), {})()

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    with profiling.tracing():
        _build.library("tap_sum", {"p2p_tap_sum": "ppp"})
        _build.library("tap_sum", {"p2p_tap_sum": "ppp"})  # loaded: no span
    monkeypatch.setattr(_build, "_loaded", {})
    with profiling.tracing():
        _build.library("tap_sum", {"p2p_tap_sum": "ppp"})  # built: no nvcc
    out = profiling.drain()
    names = [(s["name"], s["parent"] is None) for s in out["spans"]]
    assert names == [("setup.kernel_load.tap_sum", True), ("setup.nvcc", False),
                     ("setup.kernel_load.tap_sum", True)]
    assert out["counters"]["kernels.nvcc_runs"] == len(runs) == 1


def test_drain_clears(p2p):
    with profiling.tracing():
        _run_p2p(p2p)
        profiling.count("extra", 3)
        profiling.count("extra", torch.tensor([True, False, True]))
    out = profiling.drain()
    assert out["spans"] and out["counters"]["extra"] == 5
    assert profiling.drain() == {"spans": [], "counters": {}}
    _run_p2p(p2p)  # off: nothing is recorded
    assert profiling.drain()["spans"] == []
