"""NCNet's InLoc model on the port against the benchmark's plain
reference (``benchmark/reference/ncnet_r101.py``), float32, on the CPU.

``ImMatchNet("resnet101", (3, 3, 3), (16, 16, 1), relocalization_k_size=2)``
and ``corr_to_matches(corr, delta4d, ksize=2)`` on seeded weights (the
benchmark's ``inputs.make_weights`` over the reference's key map, which
is the port's state dict, key for key) and a seeded matching pair at
256x320 (a pre-pool volume of 16x20 cells a side, pooled to 8x10):

  * the filtered volume within 1e-4 of its largest magnitude: the port
    folds every BatchNorm into its conv's weights and sums the 4D convs
    in another order than the reference's unfolded, per-tap float32
    stack, through 30 bottleneck blocks (ResNet34's and the JAX parity tests take
    the same tolerance for the same reasons);
  * the maxpool4d offsets: equal, at every pooled cell, to the
    reference's pool of the port's own pre-pool volume (the tie rule);
    and to the reference's own offsets at every cell whose window's best
    lies above its runner-up by more than twice the two pre-pool
    volumes' largest difference (a near-tie there is a rounding's to
    break; 1 cell of 6400 on the first seed);
  * the relocated grid on the same terms, the mutual flags equal and
    the scores within 1e-5;
  * the cell's judge reads 0 on every number but ``score_err``, which
    reads the float32 rounding of two softmaxes summed in another order
    (about 2e-6 of the volume's largest value; held under 1e-5).
"""

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.reference import ncnet_r101 as ref
from benchmark.reference import ncnet_r101_judge
from patch2pix_tpu_torch.models.immatch_net import ImMatchNet
from patch2pix_tpu_torch.ops.correlation import feat_correlation
from patch2pix_tpu_torch.ops.match_extract import corr_to_matches
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

CFG = {"ncn_kernel_sizes": [3, 3, 3], "ncn_channels": [16, 16, 1], "relocalization_k_size": 2}
H, W = 256, 320


@pytest.fixture(scope="module", params=[5, 2 ** 31 + 11])
def run(request):
    seed = request.param
    model = ImMatchNet("resnet101", ncons_kernel_sizes=(3, 3, 3), ncons_channels=(16, 16, 1),
                       relocalization_k_size=2, device="cpu")
    P = inputs.make_weights(ref.ncnet_r101_shapes(CFG), seed, "cpu")
    assert set(model.state_dict()) == set(P)
    model.load_state_dict(P)
    im1, im2, _ = inputs.shifted_pairs(seed, 1, H, W, "cpu", 20, 0.05)
    with torch.inference_mode():
        corr, delta = model(im1, im2)
        grid, scores, mutual = corr_to_matches(corr, delta, ksize=2)
        pre_port = feat_correlation(model.features(im1), model.features(im2))
    with torch.no_grad():
        pre, offsets, want = ref.volumes(P, CFG, im1, im2)
        want_out = ref.extract(want, offsets, 2)
    # per pooled cell: whether the reference's window holds a near-tie
    top2 = pre.reshape(1, 8, 2, 10, 2, 8, 2, 10, 2).permute(0, 1, 3, 5, 7, 2, 4, 6, 8).reshape(
        1, 8, 10, 8, 10, 16).topk(2, dim=-1).values
    tied = top2[..., 0] - top2[..., 1] <= 2 * float((pre_port - pre).abs().max())
    return {"P": P, "im": (im1, im2), "corr": corr, "delta": delta, "want": want,
            "offsets": offsets, "out": (grid, scores, mutual), "want_out": want_out,
            "pre_port": pre_port, "tied": tied}


def test_volume_matches_the_reference(run):
    corr, want = run["corr"], run["want"]
    assert corr.shape == want.shape == (1, 8, 10, 8, 10)
    scale = float(want.abs().max())
    np.testing.assert_allclose(corr.numpy() / scale, want.numpy() / scale, rtol=0, atol=1e-4)


def test_offsets_and_relocated_grid_equal_the_reference(run):
    got = torch.stack([d.long() for d in run["delta"]], dim=-1)
    assert torch.equal(got, ref.maxpool4d_offsets(run["pre_port"], 2)[1])
    tied = run["tied"]
    assert int(tied.sum()) <= tied.numel() // 100
    assert torch.equal(got[~tied], run["offsets"][~tied])
    grid, scores, mutual = run["out"]
    want = run["want_out"]
    cells = torch.div(want["grid"][0], 2, rounding_mode="floor")
    row_tied = tied[0, cells[:, 1], cells[:, 0], cells[:, 3], cells[:, 2]]
    assert torch.equal(grid[0].long()[~row_tied], want["grid"][0][~row_tied])
    assert torch.equal(mutual, want["mutual"]) and int(mutual.sum()) > 0
    np.testing.assert_allclose(scores.numpy(), want["scores"].numpy(), rtol=0, atol=1e-5)


def test_judge_reads_nothing(run):
    im1, im2 = run["im"]
    out = {k: v.numpy() for k, v in zip(("grid", "scores", "mutual"), run["out"])}
    got = ncnet_r101_judge.judge(run["P"], CFG, {}, im1, im2, out)
    assert got["score_err"] <= 1e-5
    assert got == {name: 0.0 for name in ncnet_r101_judge.NUMBERS} | {
        "score_err": got["score_err"]}
