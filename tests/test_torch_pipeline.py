"""The port's ``Patch2Pix`` and ``Matcher`` end to end, on the CPU.

  * ``predict_fine`` against the JAX package's at 128x192, both strides,
    from one seeded state dict: identical coarse matches, mid/fine
    coords within 1e-3 px and confidences within 1e-4 (f32 through the
    backbone, NCN and both regressors, summed in another order);
  * the committed ``s16`` and ``cs`` reference goldens, with the rule of
    ``tests/test_pipeline_e2e_parity.py`` (coords 0.05 px, scores 5e-3);
  * ``predict_coarse`` and ``refine_matches`` against the JAX package's,
    the latter also on images that are not psize-tileable;
  * fine_cap compaction, the Matcher façade and ``.pth`` loading.
"""

import json
import os
from argparse import Namespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from patch2pix_tpu.config import ModelConfig as JaxModelConfig
from patch2pix_tpu.models.patch2pix import Patch2Pix as JaxPatch2Pix
from patch2pix_tpu.utils.torch_import import convert_patch2pix_state_dict
from patch2pix_tpu_torch.config import ModelConfig
from patch2pix_tpu_torch.evaluation.matcher import Matcher, load_model
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
from tests.ref_loader import seeded_state_dict
from tests.test_pipeline_e2e_parity import assert_match_parity, seeded_images
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")


def load_golden(tag):
    g = np.load(os.path.join(FIXDIR, f"pipeline_golden_{tag}.npz"), allow_pickle=True)
    meta = json.loads(str(g["meta"]))
    sd = seeded_state_dict({k: tuple(s) for k, s in meta["shapes"].items()},
                           seed=meta["seed"])
    return g, meta, sd


@pytest.fixture(scope="module")
def seeded_sd():
    return load_golden("cs")[2]


def build_port(change_stride, sd, **kw):
    cfg = ModelConfig(change_stride=change_stride, **kw).resolved()
    cfg.regressor.panc = 1
    model = Patch2Pix(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    return model


def to_numpy(matches):
    return type(matches)(*(t.numpy() for t in matches))


@pytest.mark.parametrize("change_stride", [False, True])
def test_predict_fine_matches_jax(seeded_sd, change_stride):
    im1, im2 = seeded_images(2, 128, 192, 20), seeded_images(2, 128, 192, 21)
    params, stats = convert_patch2pix_state_dict(seeded_sd)
    variables = {"params": jax.tree.map(jnp.asarray, params),
                 "batch_stats": jax.tree.map(jnp.asarray, stats)}
    cfg = JaxModelConfig(change_stride=change_stride).resolved()
    cfg.regressor.panc = 1
    jm = JaxPatch2Pix(config=cfg)
    want = jax.jit(lambda v, a, b: jm.apply(v, a, b, ksize=2, method=jm.predict_fine))(
        variables, jnp.asarray(im1), jnp.asarray(im2))
    jfine, jmid, jcm = jax.tree.map(np.asarray, want)

    model = build_port(change_stride, seeded_sd)
    fine, mid, cm = (to_numpy(m) for m in model.predict_fine(
        torch.from_numpy(im1), torch.from_numpy(im2), ksize=2))
    np.testing.assert_array_equal(cm.valid, jcm.valid)
    assert cm.valid.sum() > 0
    np.testing.assert_array_equal(cm.coords, jcm.coords)
    np.testing.assert_allclose(cm.scores, jcm.scores, rtol=1e-5, atol=1e-7)
    for got, ref in ((mid, jmid), (fine, jfine)):
        np.testing.assert_allclose(got.coords, ref.coords, rtol=0, atol=1e-3)
        np.testing.assert_allclose(got.scores, ref.scores, rtol=0, atol=1e-4)


def test_predict_coarse_and_refine_match_jax(seeded_sd):
    """The NCNet-style coarse matcher (mutual=False keeps both
    directions) and the plug-in refinement of external matches."""
    im1, im2 = seeded_images(1, 128, 192, 22), seeded_images(1, 128, 192, 23)
    params, stats = convert_patch2pix_state_dict(seeded_sd)
    variables = {"params": jax.tree.map(jnp.asarray, params),
                 "batch_stats": jax.tree.map(jnp.asarray, stats)}
    cfg = JaxModelConfig(change_stride=True).resolved()
    cfg.regressor.panc = 1
    jm = JaxPatch2Pix(config=cfg)
    coords = np.asarray([[[5.5, 7.0, 20.0, 9.5], [100.2, 60.7, 90.0, 64.0],
                          [190.0, 127.0, 0.0, 3.0]]], np.float32)

    def run(v, a, b, c):
        return (jm.apply(v, a, b, ksize=2, mutual=False, method=jm.predict_coarse),
                jm.apply(v, a, b, c, method=jm.refine_matches))

    jcm, jref = jax.tree.map(np.asarray, jax.jit(run)(
        variables, jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(coords)))
    model = build_port(True, seeded_sd)
    a, b = torch.from_numpy(im1), torch.from_numpy(im2)
    cm = to_numpy(model.predict_coarse(a, b, ksize=2, mutual=False))
    np.testing.assert_array_equal(cm.valid, jcm.valid)
    np.testing.assert_array_equal(cm.coords, jcm.coords)
    np.testing.assert_allclose(cm.scores, jcm.scores, rtol=1e-5, atol=1e-7)
    ref = model.refine_matches(a, b, torch.from_numpy(coords))
    for got, want, tol in zip(ref, jref, (1e-3, 1e-4, 1e-3, 1e-4)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_refine_matches_untileable_matches_jax(seeded_sd):
    """Plug-in refinement on images whose sides are not multiples of 16
    (120x200): both stages take the per-pixel block gather, as the JAX
    package does."""
    im1, im2 = seeded_images(1, 120, 200, 24), seeded_images(1, 120, 200, 25)
    params, stats = convert_patch2pix_state_dict(seeded_sd)
    variables = {"params": jax.tree.map(jnp.asarray, params),
                 "batch_stats": jax.tree.map(jnp.asarray, stats)}
    coords = np.asarray([[[5.5, 7.0, 20.0, 9.5], [100.2, 60.7, 90.0, 64.0],
                          [199.0, 119.0, 0.0, 3.0], [150.0, 30.5, 160.25, 110.0]]], np.float32)
    for change_stride in (False, True):
        cfg = JaxModelConfig(change_stride=change_stride).resolved()
        cfg.regressor.panc = 1
        jm = JaxPatch2Pix(config=cfg)
        want = jax.tree.map(np.asarray, jax.jit(
            lambda v, a, b, c: jm.apply(v, a, b, c, method=jm.refine_matches))(
            variables, jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(coords)))
        got = build_port(change_stride, seeded_sd).refine_matches(
            torch.from_numpy(im1), torch.from_numpy(im2), torch.from_numpy(coords))
        for g, w_, tol in zip(got, want, (0.05, 5e-3, 0.05, 5e-3)):
            np.testing.assert_allclose(g.numpy(), w_, rtol=0, atol=tol)


@pytest.mark.parametrize("tag", ["s16", "cs"])
def test_port_reproduces_golden(tag):
    g, meta, sd = load_golden(tag)
    model = build_port(meta["change_stride"], sd)
    im1 = seeded_images(meta["batch"], meta["h"], meta["w"], seed=meta["im_seed"])
    im2 = seeded_images(meta["batch"], meta["h"], meta["w"], seed=meta["im_seed"] + 1)
    fine, mid, cm = (to_numpy(m) for m in model.predict_fine(
        torch.from_numpy(im1), torch.from_numpy(im2), ksize=2))
    for b in range(meta["batch"]):
        assert_match_parity(
            b, g[f"coarse_{b}"], g[f"mid_{b}"], g[f"mid_scores_{b}"],
            g[f"fine_{b}"], g[f"fine_scores_{b}"], fine, mid, cm,
            coord_tol=0.05, score_tol=5e-3)


def test_fine_cap_keeps_top_scored_rows(seeded_sd):
    model = build_port(False, seeded_sd)
    im1 = torch.from_numpy(seeded_images(1, 128, 192, 30))
    im2 = torch.from_numpy(seeded_images(1, 128, 192, 31))
    full = [to_numpy(m) for m in model.predict_fine(im1, im2)]
    cap = 3
    capped = [to_numpy(m) for m in model.predict_fine(im1, im2, fine_cap=cap)]
    valid = np.where(full[2].valid[0])[0]
    assert len(valid) > cap
    order = valid[np.argsort(-full[2].scores[0][valid], kind="stable")][:cap]
    np.testing.assert_array_equal(capped[2].coords[0], full[2].coords[0][order])
    assert capped[2].valid[0].all()
    for c, f in zip(capped[:2], full[:2]):
        np.testing.assert_allclose(c.coords[0], f.coords[0][order], atol=1e-4)
        np.testing.assert_allclose(c.scores[0], f.scores[0][order], atol=1e-5)


def test_matcher_without_device_needs_cuda(seeded_sd):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    model = build_port(True, seeded_sd)
    with pytest.raises(RuntimeError, match="CUDA"):
        Matcher(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        Patch2Pix(ModelConfig().resolved())


def test_matcher_match_arrays_and_files(seeded_sd, tmp_path):
    model = build_port(False, seeded_sd)
    matcher = Matcher(model, device="cpu", io_thres=0.0)
    im1, im2 = seeded_images(1, 128, 192, 40)[0], seeded_images(1, 128, 192, 41)[0]
    m, s, c = matcher.match_arrays(im1, im2, (2.0, 2.0), (1.0, 1.0))
    assert m.shape[1:] == (4,) and len(m) == len(s) == len(c) > 0
    fine = to_numpy(model.predict_fine(torch.from_numpy(im1[None]),
                                       torch.from_numpy(im2[None]), fine_cap=1200)[0])
    np.testing.assert_allclose(m, fine.coords[0][fine.valid[0]] * [2, 2, 1, 1], atol=1e-5)
    assert matcher.cap_stats["pairs"] == 1 and matcher.cap_stats["valid_sum"] == len(m)

    refined, scores, _ = matcher.refine_matches_arrays(im1, im2, c)
    assert refined.shape == c.shape and np.isfinite(refined).all()

    Image = pytest.importorskip("PIL.Image")
    paths = []
    for i, im in enumerate((im1, im2)):
        u8 = np.clip((im * 0.25 + 0.45) * 255, 0, 255).astype(np.uint8)
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(u8).save(paths[-1])
    m2, s2, _ = matcher.estimate_matches(*paths)
    assert m2.shape[1:] == (4,) and np.isfinite(m2).all()


def test_load_model_from_reference_checkpoint(seeded_sd, tmp_path):
    path = str(tmp_path / "patch2pix.pth")
    torch.save({
        "state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in seeded_sd.items()},
        "backbone": "ResNet34", "change_stride": True, "feat_idx": [0, 1, 2, 3],
        "regressor_config": Namespace(feat_comb="pre", conv_kers=[3, 3],
                                      conv_dims=[512, 512], conv_strs=[2, 1],
                                      fc_dims=[512, 256], psize=[16, 16], pshift=8,
                                      panc=8, shared=False),
    }, path)
    model = load_model(path, device="cpu")
    assert model.config.change_stride and model.config.regressor.panc == 1
    got = model.state_dict()
    for k, v in seeded_sd.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))


def test_model_config_gather_is_auto_only():
    """The JAX ``ModelConfig.gather`` key: the port's ``to_json`` writes
    the config's own value (so a checkpoint's meta equals JAX's), reads
    ``"auto"`` and ``"block"`` back, and refuses any other value. (The
    name predates the ``"block"`` route.)"""
    from patch2pix_tpu.config import to_json as jax_to_json
    from patch2pix_tpu_torch.config import from_dict, model_config_from_json, to_json

    for gather in ("auto", "block"):
        got = json.loads(to_json(ModelConfig(change_stride=True, gather=gather).resolved()))
        assert got == json.loads(jax_to_json(
            JaxModelConfig(change_stride=True, gather=gather).resolved()))
        assert got["gather"] == gather
        back = model_config_from_json(json.dumps(got))
        assert back.change_stride and back.gather == gather
    with pytest.raises(ValueError, match="gather='tiled'"):
        from_dict(ModelConfig, dict(got, gather="tiled"))
