"""Each kernel's least time at the main path's shapes (the bounds of
PERF.md's kernel table), and the model operation counts against
``torch.utils.flop_counter`` over the plain references."""

import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, harness, inputs, kernels
from benchmark.reference import matching, nets


def test_kernel_bounds_at_the_main_path():
    assert kernels.b1_bound_s(2, 48, 64, 48, 64) * 1e3 == pytest.approx(0.1215, abs=5e-5)
    assert kernels.b2_bound_s(2, 96, 128, 256) * 1e3 == pytest.approx(0.1563, abs=5e-5)
    # PERF.md's 0.2127 came from uniformly random corners: every residue
    # pair modulo psize once gives the same expected window bytes
    m = 2400
    i = np.arange(m)
    ys, xs = (i % 16 + 16).astype(np.int32), ((i // 16) % 16 + 16).astype(np.int32)
    assert kernels.b3_bound_s([ys, xs, ys, xs]) * 1e3 == pytest.approx(0.2127, abs=5e-4)


def test_window_cells():
    # aligned windows cover t cells, unaligned t + 1, at every level
    for t in (16, 8, 4, 2):
        ds = 16 // t
        assert kernels.window_cells(np.array([32]), 16, t)[0] == t
        assert kernels.window_cells(np.array([33]), 16, t)[0] == t + (ds > 1)


def _config(name):
    return harness.load_json(harness.BENCH_DIR / "configs" / f"{name}.json")


def test_p2p_match_flops_count_the_reference():
    cfg = _config("patch2pix_r34_cs")
    h, w, b, cap = 64, 96, 2, 20
    P = inputs.make_weights(nets.patch2pix_shapes(cfg), 1, "cpu")
    im1, im2, _ = inputs.shifted_pairs(1, b, h, w, "cpu", 16, 0.05)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        matching.p2p_predict(P, cfg, {"ncn_thres": 0.0, "fine_cap": cap}, im1, im2)
    assert flops.p2p_match_flops(cfg, b, h, w, cap) == pytest.approx(fc.get_total_flops(),
                                                                      rel=1e-9)


def test_ncnet_match_flops_count_the_reference():
    cfg = _config("ncnet_vgg16")
    h, w = 64, 96
    P = inputs.make_weights(nets.ncnet_shapes(cfg), 1, "cpu")
    im1, im2, _ = inputs.shifted_pairs(1, 1, h, w, "cpu", 16, 0.05)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        nets.ncnet_volume(P, cfg, im1, im2)
    assert flops.ncnet_match_flops(cfg, 1, h, w) == pytest.approx(fc.get_total_flops(), rel=1e-9)


def test_main_path_model_operations():
    cfg = _config("patch2pix_r34_cs")
    assert flops.resnet34_flops(768, 1024, True)[1:] == (96, 128)
    assert flops.vgg16_pool4_flops(768, 1024)[1:] == (48, 64)
    assert flops.p2p_match_flops(cfg, 2, 768, 1024, 1200) / 1e12 == pytest.approx(4.1515, abs=1e-3)
    assert flops.ncnet_match_flops(_config("ncnet_vgg16"), 1, 768, 1024) / 1e12 == pytest.approx(
        1.2517, abs=1e-3)
