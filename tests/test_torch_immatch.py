"""The port's NCNet family against ``patch2pix_tpu``, float32, on the CPU.

The same numpy inputs and weights go through the JAX function and its
port (``device="cpu"``):

  * the VGG16 trunk (``pool4`` and ``relu3_3``), the DenseNet201 trunk
    (seeded running statistics): rtol 1e-4, atol 1e-5 on the outputs in
    units of their largest magnitude (activations reach ~7 here, and ten
    float32 convs summed in another order leave ~1e-5 absolute);
  * the ResNet50 and ResNet101 trunks (pyramid and layer3,
    ``change_stride`` both ways; one batch-statistics case): atol 1e-4
    of each level's scale, as ResNet34's test (deep f32 stacks with BN
    folded into the weights on both sides, summed in another order);
  * ``maxpool4d``: values ``torch.equal``, offsets equal on a volume with
    planted ties, ksize 1, 2 and 3, offsets equal to ``decode_delta_at``
    at every cell;
  * ``corr_to_matches_topk``: both directions, topk 1 and 3, with and
    without softmax, relocated by the offset volumes and by the
    pre-pool volume, and on tied values: grids equal, scores within 1e-6;
  * ``NeighConsensus`` at (3, 3, 3)/(10, 10, 1) and (5, 5, 5)/(16, 16,
    1), symmetric and not: rtol/atol 1e-5;
  * ``ImMatchNet`` end to end (vgg with relocalisation 0 and 2,
    densenet201, resnet101, ``forward_feat``, and NCNet's InLoc model:
    resnet101 with relocalisation 2 and the NCN (3, 3, 3)/(16, 16, 1)), weights carried from the
    JAX tree by ``load_jax_immatch_variables``: rtol 1e-4 of the
    volume's scale, offsets equal;
  * the checkpoint layouts (an NCNet dict with legacy ``.vgg.`` keys,
    torchvision VGG16, DenseNet and ResNet dicts) through the port's
    loaders, against the JAX converters: the same weights, bit for bit;
  * ``Patch2Pix(backbone="ResNet101", regressor=None).predict_coarse``:
    identical grids and validity, scores within 1e-5;
  * the new modules build on CUDA unless given the CPU (and raise where
    there is no CUDA);
  * the ImMatchNet golden's ``meta`` rebuilds the port's model.
"""

import functools
import importlib
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from patch2pix_tpu.config import ModelConfig as JaxModelConfig
from patch2pix_tpu.models.densenet import DenseNetFeatures as JaxDenseNet
from patch2pix_tpu.models.immatch_net import ImMatchNet as JaxImMatchNet
from patch2pix_tpu.models.ncn import NeighConsensus as JaxNCN
from patch2pix_tpu.models.patch2pix import Patch2Pix as JaxPatch2Pix
from patch2pix_tpu.models.resnet import BACKBONES as JAX_BACKBONES
from patch2pix_tpu.models.vgg import VGG16Features as JaxVGG
from patch2pix_tpu.ops import correlation as jcorr
from patch2pix_tpu.ops import match_extract as jme
from patch2pix_tpu.utils.torch_import import (
    convert_densenet_features,
    convert_ncnet_checkpoint,
    convert_patch2pix_state_dict,
    convert_torchvision_resnet,
    convert_vgg16_features,
    merge_variables,
)
from patch2pix_tpu_torch.config import ModelConfig
from patch2pix_tpu_torch.models.densenet import DenseNetFeatures
from patch2pix_tpu_torch.models.immatch_net import ImMatchNet
from patch2pix_tpu_torch.models.ncn import NeighConsensus
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
from patch2pix_tpu_torch.models.regressor import update_running_stats
from patch2pix_tpu_torch.models.resnet import BACKBONES
from patch2pix_tpu_torch.models.vgg import VGG16Features
from patch2pix_tpu_torch.ops import correlation as tcorr
from patch2pix_tpu_torch.ops import match_extract as tme
from patch2pix_tpu_torch.utils.jax_import import (
    immatch_state_dict_from_jax,
    load_jax_immatch_variables,
    load_jax_variables,
    ncn_state_dict_from_jax,
    state_dict_from_jax,
)
from patch2pix_tpu_torch.utils.torch_import import (
    load_ncnet_checkpoint,
    load_torchvision_densenet_features,
    load_torchvision_resnet,
    load_torchvision_vgg16_features,
)
from tests.ref_loader import seeded_state_dict
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

# the JAX NCN converter has no public name
_convert_ncn_keys = importlib.import_module(
    "patch2pix_tpu.utils.torch_import")._convert_ncn_keys

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "immatch_golden_vgg_1024.npz")
H, W = 64, 96
# the JAX modules' trees are traced at this size (nothing runs): their
# parameters' shapes do not depend on it
SMALL = jnp.zeros((1, 32, 32, 3), jnp.float32)


def jax_vars(jm, params, stats, *args, **kw):
    """A JAX module's variables from converted (params, stats): the
    tree's structure from ``jax.eval_shape`` of its ``init``, every leaf
    from the conversion (a leaf the conversion misses fails the apply)."""
    shapes = jax.eval_shape(functools.partial(jm.init, **kw), jax.random.PRNGKey(0), *args)
    return merge_variables(shapes, params, stats)


def jit_apply(jm, **kw):
    return jax.jit(functools.partial(jm.apply, **kw))


def T(a):
    return torch.from_numpy(np.array(a))


def shapes_of(module):
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def images(seed, n=1, h=H, w=W):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, h, w, 3).astype(np.float32) - 0.45) / 0.25


def close(got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def close_unit(got, want, rtol=1e-4, atol=1e-5):
    """rtol/atol on both sides divided by the largest |want|."""
    s = float(np.abs(np.asarray(want)).max())
    assert tuple(got.shape) == np.asarray(want).shape
    close(got / s, np.asarray(want) / s, rtol=rtol, atol=atol)


def close_scaled(got, want, rel=1e-4):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())


# ---------------------------------------------------------------- trunks


@pytest.mark.parametrize("last_layer", ["pool4", "relu3_3"])
def test_vgg16_trunk_matches_jax(last_layer):
    net = VGG16Features(last_layer, device="cpu")
    sd = seeded_state_dict({f"features.{k}": s for k, s in shapes_of(net).items()}, seed=1)
    load_torchvision_vgg16_features(net, sd)
    x = images(2)
    jm = JaxVGG(last_layer=last_layer)
    params = convert_vgg16_features(sd, scope=())
    variables = jax_vars(jm, params, {}, SMALL)
    with torch.no_grad():
        got = net(T(x))
    want = jit_apply(jm)(variables, jnp.asarray(x))
    close_unit(got, want)


def test_vgg16_rejects_unknown_layer():
    with pytest.raises(ValueError, match="unknown vgg16 layer"):
        VGG16Features("conv9_9", device="cpu")


def test_densenet_trunk_matches_jax():
    net = DenseNetFeatures(device="cpu")
    sd = seeded_state_dict({f"features.{k}": s for k, s in shapes_of(net).items()}, seed=2)
    load_torchvision_densenet_features(net, sd)
    x = images(3)
    jm = JaxDenseNet()
    params, stats = convert_densenet_features(sd, scope=())
    variables = jax_vars(jm, params, stats, SMALL)
    with torch.no_grad():
        got = net(T(x))
    want = jit_apply(jm)(variables, jnp.asarray(x))
    assert tuple(got.shape) == want.shape == (1, H // 16, W // 16, 256)
    close_unit(got, want)


def _resnet_pair(name, change_stride, seed):
    net = BACKBONES[name](change_stride, device="cpu")
    sd = seeded_state_dict(shapes_of(net), seed=seed)
    load_torchvision_resnet(net, sd)
    params, stats = convert_torchvision_resnet(sd)
    return net, JAX_BACKBONES[name](change_stride), params["extract"], stats["extract"]


@pytest.mark.parametrize("change_stride", [False, True])
@pytest.mark.parametrize("name", ["ResNet50", "ResNet101"])
def test_bottleneck_resnet_matches_jax(name, change_stride):
    net, jm, params, stats = _resnet_pair(name, change_stride, seed=4)
    x = images(5, n=2)
    with torch.no_grad():
        got = net(T(x), pyramid=True)
        last = net(T(x))
    want = jit_apply(jm, pyramid=True)({"params": params, "batch_stats": stats}, jnp.asarray(x))
    assert len(got) == len(want) == 5
    assert got[-1].shape[-1] == 1024
    assert got[-1].shape[1] == (H // 8 if change_stride else H // 16)
    for g, w in zip(got, want):
        close_scaled(g, w)
    assert torch.equal(last, got[-1])


def test_bottleneck_batch_statistics_match_jax():
    """ResNet50 on batch statistics (``stats=``) against the JAX train
    path: every pyramid level within 1e-3 of its scale, every running
    average after one update within rtol 1e-4, atol 1e-5. The looser
    level bound: both sides take the variance as ``E[y^2] - mean^2``
    (the JAX formula), whose cancellation scales the two reductions'
    rounding by ``E[y^2] / var`` at each of 53 BatchNorms (layer1 agrees
    to 1e-5 of its scale, layer3 to ~1.5e-4)."""
    net, jm, params, stats = _resnet_pair("ResNet50", True, seed=6)
    x = images(7, n=2)
    st = []
    with torch.no_grad():
        got = net(T(x), stats=st, pyramid=True)
        update_running_stats(st)
    want, upd = jit_apply(jm, train=True, pyramid=True, mutable=["batch_stats"])(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    for g, w in zip(got, want):
        close_scaled(g, w, rel=1e-3)
    back = state_dict_from_jax({"params": {"extract": params, "ncn": {}},
                                "batch_stats": {"extract": upd["batch_stats"]}})
    own = net.state_dict()
    n = 0
    for k, v in back.items():
        if "running" in k:
            close(own[k[len("extract."):]], v.numpy(), rtol=1e-4, atol=1e-5)
            n += 1
    assert n == 2 * len(st)


# ---------------------------------------------------------------- ops


def _tied_volume(rng, shape):
    """A volume of few distinct values (many exact ties in every window)."""
    return rng.integers(-3, 4, shape).astype(np.float32) / 4


@pytest.mark.parametrize("ksize", [1, 2, 3])
def test_maxpool4d_matches_jax(rng, ksize):
    shape = (2, 2 * ksize, 3 * ksize, 2 * ksize, 2 * ksize)
    for corr in (rng.standard_normal(shape).astype(np.float32), _tied_volume(rng, shape)):
        got, gd = tcorr.maxpool4d(T(corr), ksize)
        want, wd = jcorr.maxpool4d(jnp.asarray(corr), ksize)
        assert torch.equal(got, T(want))
        assert torch.equal(got, tcorr.maxpool4d_values(T(corr), ksize))
        for g, w in zip(gd, wd):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        if ksize > 1:
            # the offsets equal decode_delta_at's at every pooled cell
            b, h1, w1, h2, w2 = got.shape
            cells = np.stack(np.meshgrid(*(np.arange(n) for n in (h1, w1, h2, w2)),
                                         indexing="ij"), -1).reshape(-1, 4)
            idx = [T(np.broadcast_to(cells[:, i], (b, len(cells))).astype(np.int64))
                   for i in range(4)]
            dec = tcorr.decode_delta_at(T(corr), *idx, ksize)
            for g, d in zip(gd, dec):
                assert torch.equal(g.reshape(b, -1), d)


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("topk", [1, 3])
@pytest.mark.parametrize("do_softmax", [True, False])
@pytest.mark.parametrize("source", ["none", "offsets", "volume"])
def test_corr_to_matches_topk_matches_jax(rng, invert, topk, do_softmax, source):
    pre = rng.standard_normal((2, 4, 6, 6, 4)).astype(np.float32)
    if source == "none":
        corr, ksize, tdelta, jdelta = pre, 1, None, None
    else:
        corr, offsets = tcorr.maxpool4d(T(pre), 2)
        corr, ksize = corr.numpy(), 2
        tdelta = offsets if source == "offsets" else T(pre)
        jdelta = (tuple(jnp.asarray(d.numpy()) for d in offsets) if source == "offsets"
                  else jnp.asarray(pre))
    kw = dict(topk=topk, ksize=ksize, do_softmax=do_softmax, invert_matching_direction=invert)
    grid, scores = tme.corr_to_matches_topk(T(corr), tdelta, **kw)
    jgrid, jscores = jme.corr_to_matches_topk(jnp.asarray(corr), jdelta, **kw)
    assert grid.dtype == torch.int32 and scores.dtype == torch.float32
    np.testing.assert_array_equal(grid.numpy(), np.asarray(jgrid))
    close(scores, jscores, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("invert", [False, True])
def test_corr_to_matches_topk_breaks_ties_by_index(rng, invert):
    """Equal values rank lower index first, as ``lax.top_k`` does."""
    corr = _tied_volume(rng, (1, 3, 4, 4, 3))
    corr[0, 1, 2] = 0.75  # one source cell ties with itself across targets
    for do_softmax in (True, False):
        kw = dict(topk=4, do_softmax=do_softmax, invert_matching_direction=invert)
        grid, scores = tme.corr_to_matches_topk(T(corr), **kw)
        jgrid, jscores = jme.corr_to_matches_topk(jnp.asarray(corr), **kw)
        np.testing.assert_array_equal(grid.numpy(), np.asarray(jgrid))
        close(scores, jscores, rtol=1e-6, atol=1e-6)


def test_corr_to_matches_relocates_by_offset_volumes(rng):
    """``corr_to_matches`` with maxpool4d's 4-tuple equals JAX's and the
    pre-pool volume's relocation."""
    pre = rng.standard_normal((2, 4, 6, 4, 8)).astype(np.float32)
    pooled, offsets = tcorr.maxpool4d(T(pre), 2)
    got = tme.corr_to_matches(pooled, offsets, ksize=2)
    via_volume = tme.corr_to_matches(pooled, T(pre), ksize=2)
    want = jme.corr_to_matches(jnp.asarray(pooled.numpy()),
                               tuple(jnp.asarray(d.numpy()) for d in offsets), ksize=2)
    for g, v, w in zip(got, via_volume, want):
        assert torch.equal(g, v)
    for i in (0, 2):  # grid and mutual flags
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    close(got[1], want[1], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- NCN


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("kernels,channels", [((3, 3, 3), (10, 10, 1)),
                                              ((5, 5, 5), (16, 16, 1))])
def test_ncn_settings_match_jax(rng, kernels, channels, symmetric):
    """(3, 3, 3)/(10, 10, 1) runs fold-in, per-tap convs, fold-out (B1's
    plain version here); (5, 5, 5)/(16, 16, 1) the per-tap convs only."""
    jm = JaxNCN(kernel_sizes=kernels, channels=channels, symmetric_mode=symmetric)
    corr = rng.standard_normal((1, 4, 5, 5, 3)).astype(np.float32)
    params, cin = {}, 1
    for li, (k, cout) in enumerate(zip(kernels, channels)):
        fan = (2.0 / (cin * k ** 4)) ** 0.5
        params[f"conv{li}_kernel"] = (rng.standard_normal((k,) * 4 + (cin, cout)) * fan
                                      ).astype(np.float32)
        params[f"conv{li}_bias"] = (rng.standard_normal(cout) * 0.05).astype(np.float32)
        cin = cout
    ncn = NeighConsensus(kernels, channels, symmetric_mode=symmetric, device="cpu")
    ncn.load_state_dict(ncn_state_dict_from_jax(params))
    with torch.no_grad():
        got = ncn(T(corr))
    want = jit_apply(jm)({"params": params}, jnp.asarray(corr))
    close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- ImMatchNet


def _jax_immatch_variables(cnn, port):
    """A seeded state dict over the port's keys, carried into the JAX
    ImMatchNet's tree by the JAX converters."""
    sd = seeded_state_dict(shapes_of(port), seed=8)
    if cnn == "vgg":
        params, stats = convert_ncnet_checkpoint(sd)
    else:
        if cnn == "densenet201":
            params, stats = convert_densenet_features(sd, prefix="FeatureExtraction.model.")
        else:
            params, stats = convert_torchvision_resnet(
                {k[len("extract."):]: v for k, v in sd.items() if k.startswith("extract.")})
        _convert_ncn_keys(sd, params, scope=("NeighConsensus",), prefix="NeighConsensus.conv.")
    return params, stats


@pytest.mark.parametrize("cnn,reloc", [("vgg", 0), ("vgg", 2), ("densenet201", 0),
                                       ("resnet101", 0)])
def test_immatch_net_matches_jax(cnn, reloc):
    kw = dict(feature_extraction_cnn=cnn, relocalization_k_size=reloc)
    port = ImMatchNet(**kw, device="cpu")
    jm = JaxImMatchNet(**kw)
    a, b = images(9), images(10)
    params, stats = _jax_immatch_variables(cnn, port)
    variables = jax_vars(jm, params, stats, SMALL, SMALL)
    load_jax_immatch_variables(port, variables)
    with torch.no_grad():
        corr, delta = port(T(a), T(b))
    want, wdelta = jit_apply(jm)(variables, jnp.asarray(a), jnp.asarray(b))
    close_scaled(corr, want)
    if reloc:
        for g, w in zip(delta, wdelta):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    else:
        assert delta is None and wdelta is None


def test_immatch_net_inloc_matches_jax():
    """NCNet's InLoc model: ResNet101, relocalisation 2, NCN (3, 3, 3)/(16,
    16, 1), whose 16 -> 16 layer takes the per-tap route."""
    kw = dict(feature_extraction_cnn="resnet101", relocalization_k_size=2,
              ncons_kernel_sizes=(3, 3, 3), ncons_channels=(16, 16, 1))
    port = ImMatchNet(**kw, device="cpu")
    jm = JaxImMatchNet(**kw)
    a, b = images(13), images(14)
    params, stats = _jax_immatch_variables("resnet101", port)
    variables = jax_vars(jm, params, stats, SMALL, SMALL)
    load_jax_immatch_variables(port, variables)
    with torch.no_grad():
        corr, delta = port(T(a), T(b))
    want, wdelta = jit_apply(jm)(variables, jnp.asarray(a), jnp.asarray(b))
    close_scaled(corr, want)
    for g, w in zip(delta, wdelta):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_immatch_forward_feat_matches_jax(rng):
    port = ImMatchNet(device="cpu")
    jm = JaxImMatchNet()
    a, b = images(11), images(12)
    params, stats = _jax_immatch_variables("vgg", port)
    variables = jax_vars(jm, params, stats, SMALL, SMALL)
    load_jax_immatch_variables(port, variables)
    fa, fb = (rng.standard_normal((1, 4, 6, 512)).astype(np.float32) for _ in range(2))
    for normalize in (True, False):
        with torch.no_grad():
            got, _ = port.forward_feat(T(fa), T(fb), normalize=normalize)
        want, _ = jit_apply(jm, normalize=normalize, method=jm.forward_feat)(
            variables, jnp.asarray(fa), jnp.asarray(fb))
        close_scaled(got, want)


@pytest.mark.parametrize("build", [ImMatchNet, VGG16Features, DenseNetFeatures,
                                   BACKBONES["ResNet50"], BACKBONES["ResNet101"]])
def test_new_modules_need_cuda_unless_given_the_cpu(build):
    if torch.cuda.is_available():
        assert next(build().parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            build()


def test_immatch_net_rejects_unknown_backbone():
    with pytest.raises(ValueError, match="unsupported"):
        ImMatchNet(feature_extraction_cnn="mobilenet_v3", device="cpu")


# ---------------------------------------------------------------- loaders


def test_ncnet_checkpoint_loads_as_jax_converts_it():
    """A legacy NCNet dict (``FeatureExtraction.vgg.N``) through
    ``load_ncnet_checkpoint`` against ``convert_ncnet_checkpoint`` +
    ``merge_variables``."""
    port = ImMatchNet(device="cpu")
    sd = seeded_state_dict(shapes_of(port), seed=13)
    legacy = {k.replace(".model.", ".vgg."): v for k, v in sd.items()}
    legacy["optimizer_step"] = np.zeros(1, np.float32)  # outside the model: ignored
    load_ncnet_checkpoint(port, legacy)
    jm = JaxImMatchNet()
    params, stats = convert_ncnet_checkpoint(legacy)
    variables = jax_vars(jm, params, stats, SMALL, SMALL)
    want = immatch_state_dict_from_jax(jax.device_get(variables), "vgg")
    own = port.state_dict()
    assert set(want) == set(own)
    for k, v in want.items():
        assert torch.equal(own[k], v), k
    with pytest.raises(KeyError):
        load_ncnet_checkpoint(port, {"FeatureExtraction.model.99.weight": np.zeros(1)})


@pytest.mark.parametrize("cnn", ["vgg", "densenet201", "resnet101"])
def test_torchvision_dicts_load_as_jax_converts_them(cnn):
    """torchvision ``features.*`` / ResNet dicts, with the keys the trunk
    drops (VGG past pool4, denseblock3+ and norm5, fc), through the
    port's loaders and through the JAX converters."""
    port = ImMatchNet(feature_extraction_cnn=cnn, device="cpu")
    own = port.state_dict()
    prefix = "extract." if cnn == "resnet101" else "FeatureExtraction.model."
    trunk = {k[len(prefix):]: s for k, s in shapes_of(port).items() if k.startswith(prefix)}
    if cnn == "vgg":
        tv = {f"features.{k}": s for k, s in trunk.items()}
        tv.update({"features.24.weight": (512, 512, 3, 3), "features.24.bias": (512,),
                   "classifier.0.weight": (8, 4)})
    elif cnn == "densenet201":
        tv = {f"features.{k}": s for k, s in trunk.items()}
        tv.update({"features.norm5.weight": (1920,),
                   "features.denseblock3.denselayer1.conv1.weight": (128, 256, 1, 1)})
    else:
        tv = {**trunk, "fc.weight": (1000, 2048), "fc.bias": (1000,)}
    sd = seeded_state_dict(tv, seed=15)
    loader = {"vgg": load_torchvision_vgg16_features,
              "densenet201": load_torchvision_densenet_features,
              "resnet101": load_torchvision_resnet}[cnn]
    loader(port, sd)
    if cnn == "vgg":
        params, stats = convert_vgg16_features(
            {k: v for k, v in sd.items() if k.startswith("features.") and int(k.split(".")[1]) < 24}), {}
    elif cnn == "densenet201":
        params, stats = convert_densenet_features(sd)
    else:
        params, stats = convert_torchvision_resnet(sd)
    # the NCN, absent from the dict, as the port holds it
    _convert_ncn_keys({k: v.numpy() for k, v in own.items()}, params, scope=("NeighConsensus",),
                      prefix="NeighConsensus.conv.")
    jm = JaxImMatchNet(feature_extraction_cnn=cnn)
    variables = jax_vars(jm, params, stats, SMALL, SMALL)
    want = immatch_state_dict_from_jax(jax.device_get(variables), cnn)
    got = port.state_dict()
    n = 0
    for k, v in want.items():
        if k.startswith(prefix):
            assert torch.equal(got[k], v), k
            n += 1
    assert n == sum(1 for k in trunk if not k.endswith("num_batches_tracked")
                    and ".layer4." not in f".{k}")
    # the NCN was not in the dict: it keeps its values
    for k, v in own.items():
        if k.startswith("NeighConsensus."):
            assert torch.equal(got[k], v)


# ---------------------------------------------------------------- Patch2Pix


def test_patch2pix_resnet101_predict_coarse_matches_jax():
    cfg = dict(backbone="ResNet101", change_stride=True, regressor=None)
    port = Patch2Pix(ModelConfig(**cfg).resolved(), device="cpu")
    sd = seeded_state_dict(shapes_of(port), seed=17)
    jm = JaxPatch2Pix(JaxModelConfig(**cfg).resolved())
    params, stats = convert_patch2pix_state_dict(sd)
    a, b = images(18, n=2), images(19, n=2)
    variables = jax_vars(jm, params, stats, SMALL, SMALL, ksize=2, method=jm.predict_coarse)
    # the JAX tree of a ResNet101 Patch2Pix (Bottleneck conv3/bn3 included)
    # loads into the port and gives back the seeded dict
    load_jax_variables(port, jax.device_get(variables))
    own = port.state_dict()
    for k, v in sd.items():
        if ".layer4." not in k and not k.endswith("num_batches_tracked"):
            assert torch.equal(own[k], T(v)), k
    got = port.predict_coarse(T(a), T(b), ksize=2)
    want = jit_apply(jm, ksize=2, method=jm.predict_coarse)(
        variables, jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    close(got.scores, want.scores, rtol=0, atol=1e-5)


# ---------------------------------------------------------------- golden


def test_immatch_golden_meta_rebuilds_the_port_model():
    """The card reproduces ``immatch_golden_vgg_1024.npz``; here its
    ``meta`` must rebuild the port's ImMatchNet (keys and shapes) and
    its arrays must have the shapes of a 1024x768 VGG16 run."""
    g = np.load(GOLDEN, allow_pickle=True)
    meta = json.loads(str(g["meta"]))
    port = ImMatchNet(feature_extraction_cnn=meta["feature_extraction_cnn"],
                      ncons_kernel_sizes=meta["ncons_kernel_sizes"],
                      ncons_channels=meta["ncons_channels"], device="cpu")
    assert shapes_of(port) == {k: tuple(s) for k, s in meta["shapes"].items()}
    sd = seeded_state_dict({k: tuple(s) for k, s in meta["shapes"].items()}, seed=meta["seed"])
    load_ncnet_checkpoint(port, sd)
    h1, w1 = meta["h"] // 16, meta["w"] // 16
    n = 2 * h1 * w1
    assert g["grid"].shape == (meta["batch"], n, 4) and g["grid"].dtype == np.int32
    assert g["scores"].shape == g["mutual"].shape == g["margin"].shape == (meta["batch"], n)
    assert (g["margin"] >= 0).all() and np.isfinite(g["scores"]).all()
