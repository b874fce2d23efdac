"""The port's CUDA kernels and CUDA path, on a CUDA card.

Every test takes the ``cuda`` fixture, which skips without a card. This
file imports neither JAX nor the JAX package, so it also runs where JAX
is absent (``--noconftest`` skips ``tests/conftest.py``, which imports
JAX):

    python -m pytest --noconftest tests/test_torch_card.py

Each kernel is held against its plain version on the card, at small
and ragged shapes (partial tiles, channel counts that are not a
multiple of 8, a t=1 pyramid level), to its kernel's tolerance: tap_sum
bit-identical, corr_pool atol 1e-4 on unit-norm features,
expand_scale_pair f32 rtol 1e-6 / bf16 bit for bit, except at patch
pixels whose inverse norm rounds to the neighbouring bf16 value (one in
10^4 at most; chip_smoke's ``expand_bf16_mismatch``). The whole
pipeline on the card (f32, TF32 off) is held against the same model on
the CPU, which runs the plain versions.
"""

import json
import os

import numpy as np
import pytest
import torch

from chip_smoke import expand_bf16_mismatch
from patch2pix_tpu_torch.config import ModelConfig
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
from patch2pix_tpu_torch.ops.corr_pool import corr_pool, corr_pool_plain
from patch2pix_tpu_torch.ops.patch_expand import expand_scale_pair, expand_scale_pair_plain
from patch2pix_tpu_torch.ops.tap_sum import tap_sum, tap_sum_plain
from tests.ref_loader import seeded_state_dict

PSIZE = 16
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "pipeline_golden_cs.npz")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rs(seed):
    return np.random.RandomState(seed)


def _unit_feats(seed, b, h, w, c):
    f = _rs(seed).standard_normal((b, h, w, c)).astype(np.float32)
    return torch.from_numpy(f / np.linalg.norm(f, axis=-1, keepdims=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,h1,w1,hw,cout", [(2, 8, 8, 24, 1), (1, 5, 7, 300, 2)])
def test_tap_sum_bit_identical(cuda, dtype, bs, h1, w1, hw, cout):
    n = bs * h1 * w1
    z = torch.from_numpy(_rs(0).standard_normal((n, 9, cout * hw)).astype(np.float32))
    z = z.to(cuda, dtype)
    bias = torch.tensor([0.37, -1.5][:cout], device=cuda)
    n0 = tap_sum.launches
    got = tap_sum(z, bias, bs, h1, w1)
    assert tap_sum.launches == n0 + 1
    assert torch.equal(got, tap_sum_plain(z, bias, bs, h1, w1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h1,w1,h2,w2,c", [(2, 8, 12, 10, 6, 96), (1, 6, 70, 4, 36, 20)])
def test_corr_pool_matches_plain(cuda, dtype, b, h1, w1, h2, w2, c):
    f1 = _unit_feats(1, b, h1, w1, c).to(cuda, dtype)
    f2 = _unit_feats(2, b, h2, w2, c).to(cuda, dtype)
    n0 = corr_pool.launches
    got = corr_pool(f1, f2)
    assert corr_pool.launches == n0 + 1
    torch.testing.assert_close(got, corr_pool_plain(f1, f2), rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("levels", [((16, 3), (8, 64), (4, 64), (2, 128)),
                                    ((8, 64), (4, 64), (2, 128), (1, 256))])
def test_expand_scale_pair_matches_plain(cuda, dtype, levels):
    rs, m = _rs(3), 37
    rows = [[torch.from_numpy(rs.standard_normal((m, 4, t, t * c)).astype(np.float32))
             .to(cuda, dtype) for t, c in levels] for _ in range(2)]
    # a few negative corners: they count as 0 in both versions
    corners = [torch.from_numpy(rs.randint(-20, 80, (m,)).astype(np.int32)).to(cuda)
               for _ in range(4)]
    n0 = expand_scale_pair.launches
    got = expand_scale_pair(rows[0], rows[1], *corners, PSIZE, dtype)
    assert expand_scale_pair.launches == n0 + 1
    want = expand_scale_pair_plain(rows[0], rows[1], *corners, PSIZE, dtype)
    assert [g.shape for g in got] == [w.shape for w in want]
    if dtype == torch.float32:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
    else:
        flipped, pixels, _ = expand_bf16_mismatch(got, want, levels, PSIZE)
        assert flipped * 1e4 <= pixels


def test_wrappers_reject_bad_inputs(cuda):
    z = torch.zeros((8, 9, 4), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        tap_sum(z, torch.zeros(1, device=cuda), 1, 2, 4)
    f = torch.zeros((1, 4, 4, 8), device=cuda)
    with pytest.raises(ValueError):
        corr_pool(f, f.cpu())
    with pytest.raises(ValueError):
        corr_pool(f[:, :3], f)


@pytest.mark.parametrize("change_stride", [False, True])
def test_pipeline_on_card_matches_cpu(cuda, change_stride):
    meta = json.loads(str(np.load(FIXTURE, allow_pickle=True)["meta"]))
    sd = seeded_state_dict({k: tuple(s) for k, s in meta["shapes"].items()}, seed=0)
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    cfg = ModelConfig(change_stride=change_stride).resolved()
    cfg.regressor.panc = 1
    cpu, card = Patch2Pix(cfg, device="cpu"), Patch2Pix(cfg, device=cuda)
    cpu.load_state_dict(sd)
    card.load_state_dict(sd)
    rs = _rs(4)
    ims = [torch.from_numpy((rs.rand(1, 128, 192, 3).astype(np.float32) - 0.45) / 0.25)
           for _ in range(2)]
    counts = (tap_sum.launches, corr_pool.launches, expand_scale_pair.launches)
    want = cpu.predict_fine(*ims, ksize=2)
    got = card.predict_fine(*(im.to(cuda) for im in ims), ksize=2)
    assert all(a > b for a, b in zip(
        (tap_sum.launches, corr_pool.launches, expand_scale_pair.launches), counts))
    fine, mid, cm = ([t.cpu() for t in m] for m in got)
    wfine, wmid, wcm = want
    assert torch.equal(cm[2], wcm.valid) and torch.equal(cm[0], wcm.coords)
    valid = wcm.valid
    for g, w in ((mid, wmid), (fine, wfine)):
        torch.testing.assert_close(g[0][valid], w.coords[valid], rtol=0, atol=1e-3)
        torch.testing.assert_close(g[1][valid], w.scores[valid], rtol=0, atol=1e-4)
