"""The plain references against the program at a tiny size on the CPU:
in float32 the judges read (near) nothing, and the float8 control reads
more than the program's bfloat16."""

import pytest
import torch

from benchmark import harness, inputs
from benchmark.reference import matching, nets

H, W = 64, 96


def _config(name):
    return harness.load_json(harness.BENCH_DIR / "configs" / f"{name}.json")


def _p2p(dtype, seed):
    from benchmark.drivers.p2p_match import port_model

    cfg = dict(_config("patch2pix_r34_cs"), dtype=dtype)
    model = port_model(cfg, "cpu")
    P = inputs.make_weights(nets.patch2pix_shapes(cfg), seed, "cpu")
    assert set(model.state_dict()) == set(P)
    model.load_state_dict(P)
    im1, im2, _ = inputs.shifted_pairs(seed, 2, H, W, "cpu", 16, 0.05)
    fine, mid, cm = model.predict_fine(im1, im2, ksize=2, mutual=True, fine_cap=16)
    out = dict(zip(("coarse", "scores", "valid", "mid", "mid_probs", "fine", "fine_probs"),
                   (t.numpy() for t in (cm.coords, cm.scores, cm.valid, mid.coords, mid.scores,
                                        fine.coords, fine.scores))))
    opts = {"ncn_thres": 0.0, "fine_cap": 16}
    return cfg, P, im1, im2, opts, out


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 7])
def test_p2p_reference_matches_the_program_in_float32(seed):
    cfg, P, im1, im2, opts, out = _p2p("float32", seed)
    assert out["valid"].sum() > 0
    got = matching.p2p_judge(P, cfg, opts, im1, im2, out)
    for name in ("coarse_malformed", "valid_unpaired", "reloc_gap"):
        assert got[name] == 0, name
    assert got["regress_err_px"] < 1e-3
    assert got["mid_prob_err"] < 1e-5 and got["fine_prob_err"] < 1e-5


def test_p2p_control_reads_beyond_bfloat16():
    cfg, P, im1, im2, opts, out = _p2p("bfloat16", 3)
    prog = matching.p2p_judge(P, cfg, opts, im1, im2, out)
    ctl = {k: v.numpy() for k, v in matching.p2p_predict(P, cfg, opts, im1, im2,
                                                         nets.Precision("fp8")).items()}
    ctl = matching.p2p_judge(P, cfg, opts, im1, im2, ctl)
    assert prog["valid_unpaired"] == 0 and ctl["valid_unpaired"] == 0
    assert ctl["regress_err_px"] > 3 * prog["regress_err_px"]
    assert ctl["reloc_gap"] > 3 * prog["reloc_gap"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ncnet_reference_matches_the_program(dtype):
    from patch2pix_tpu_torch.models.immatch_net import ImMatchNet
    from patch2pix_tpu_torch.ops.match_extract import corr_to_matches

    cfg = _config("ncnet_vgg16")
    P = inputs.make_weights(nets.ncnet_shapes(cfg), 4, "cpu")
    model = ImMatchNet("vgg", dtype=dtype, device="cpu")
    model.load_state_dict(P)
    # a pool4 volume of 8x10 cells: at 4x6 the control may keep every mutual pick
    im1, im2, _ = inputs.shifted_pairs(4, 1, 2 * H, 160, "cpu", 16, 0.05)
    with torch.inference_mode():
        grid, scores, mutual = corr_to_matches(model(im1, im2)[0])
    out = {"grid": grid.numpy(), "scores": scores.numpy(), "mutual": mutual.numpy()}
    got = matching.ncnet_judge(P, cfg, {}, im1, im2, out)
    ctl = {k: v.numpy() for k, v in matching.ncnet_predict(P, cfg, {}, im1, im2,
                                                           nets.Precision("fp8")).items()}
    ctl = matching.ncnet_judge(P, cfg, {}, im1, im2, ctl)
    assert got["grid_malformed"] == 0 and got["mutual_unpaired"] == 0
    if dtype == torch.float32:
        assert got["pick_gap_mean"] == 0
    assert ctl["pick_gap_mean"] > 3 * got["pick_gap_mean"]
