"""The port's ``Matcher`` file API against the JAX package's, on the CPU.

On two PNG files written here (128x96), one seeded state dict in both
packages (ResNet34 change_stride, 64-wide regressors, f32):

  * the functional ``estimate_matches(model, im1_path, im2_path, ...)``
    with the JAX package's arguments: the same coarse matches, fine
    matches within 1e-3 px and scores within 1e-4 (f32 through the
    backbone, NCN and both regressors, summed in another order);
  * ``Matcher.refine_matches(..., max_matches=...)``: the same output for
    max_matches 16 and 2048 (no row is padded), and within the same
    tolerances of JAX's, which pads to 16 slots.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from patch2pix_tpu.config import ModelConfig as JaxModelConfig
from patch2pix_tpu.config import RegressorConfig as JaxRegressorConfig
from patch2pix_tpu.evaluation.matcher import Matcher as JaxMatcher
from patch2pix_tpu.evaluation.matcher import estimate_matches as jax_estimate_matches
from patch2pix_tpu.models.patch2pix import Patch2Pix as JaxPatch2Pix
from patch2pix_tpu.utils.torch_import import convert_patch2pix_state_dict
from patch2pix_tpu_torch.config import ModelConfig, RegressorConfig
from patch2pix_tpu_torch.evaluation.matcher import Matcher, estimate_matches
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
from tests.ref_loader import seeded_state_dict
from tests.test_pipeline_e2e_parity import seeded_images
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

REG = dict(conv_dims=(64, 64), fc_dims=(64, 32), panc=1)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The two packages' models from one seeded state dict, and two PNGs."""
    port = Patch2Pix(ModelConfig(change_stride=True, regressor=RegressorConfig(**REG)).resolved(),
                     device="cpu")
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in port.state_dict().items()}, seed=4)
    port.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    params, stats = convert_patch2pix_state_dict(sd)
    variables = {"params": jax.tree.map(jnp.asarray, params),
                 "batch_stats": jax.tree.map(jnp.asarray, stats)}
    jm = JaxPatch2Pix(config=JaxModelConfig(
        change_stride=True, regressor=JaxRegressorConfig(**REG)).resolved())
    d = tmp_path_factory.mktemp("pngs")
    paths = []
    for i, seed in enumerate((30, 31)):
        im = seeded_images(1, 96, 128, seed)[0]
        u8 = np.clip((im * 0.25 + 0.45) * 255, 0, 255).astype(np.uint8)
        paths.append(str(d / f"{i}.png"))
        Image.fromarray(u8).save(paths[-1])
    return port, jm, variables, paths


def _by_coarse(out):
    """Rows of (matches, scores, coarse) in the lexicographic order of
    the coarse matches."""
    order = np.lexsort(out[2].T[::-1])
    return [np.asarray(a)[order] for a in out]


def test_functional_estimate_matches_equals_jax(pair):
    port, jm, variables, paths = pair
    kw = dict(ksize=2, ncn_thres=0.0, mutual=True, io_thres=0.0, eval_type="fine",
              imsize=None)
    got = _by_coarse(estimate_matches(port, *paths, device="cpu", **kw))
    want = _by_coarse(jax_estimate_matches(jm, variables, *paths, **kw))
    assert len(got[0]) == len(want[0]) > 0
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)


def test_refine_matches_takes_max_matches(pair):
    port, jm, variables, paths = pair
    coarse = np.asarray([[5.5, 7.0, 20.0, 9.5], [100.2, 60.7, 90.0, 64.0],
                         [120.0, 90.0, 0.0, 3.0], [64.0, 48.0, 70.0, 40.0]])
    matcher = Matcher(port, device="cpu")
    outs = [matcher.refine_matches(*paths, coarse, max_matches=m) for m in (16, 2048)]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    want = JaxMatcher(jm, variables).refine_matches(*paths, coarse, max_matches=16)
    assert len(outs[0][0]) == len(want[0])
    np.testing.assert_array_equal(outs[0][2], want[2])
    np.testing.assert_allclose(outs[0][0], want[0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(outs[0][1], want[1], rtol=0, atol=1e-4)
