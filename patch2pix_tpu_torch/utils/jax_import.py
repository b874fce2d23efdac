"""Carry ``patch2pix_tpu`` variable trees across to the port.

The port's modules use the reference PyTorch state-dict key names
(``extract.layer1.0.conv1.weight``, ``ncn.conv.0.weight``,
``regress_mid.fc.6.bias``, ...), so a reference ``.pth`` loads with
``load_state_dict`` as it is. A JAX ``{"params", "batch_stats"}`` tree
is mapped back with the inverse of the JAX package's
``convert_patch2pix_state_dict``:

  * flax conv ``(kh, kw, in, out)`` -> ``(out, in, kh, kw)``,
  * Dense ``(in, out)`` -> Linear ``(out, in)``,
  * conv4d ``(k1, k2, k3, k4, in, out)`` -> the reference's pre-permuted
    ``(k1, out, in, k2, k3, k4)``,
  * BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var.

The JAX tree has no ``layer4`` (never run) and no
``num_batches_tracked``; :func:`load_jax_variables` leaves those keys
at their initial values. The regressors' ``BNAffine`` ``convbn{i}``
running ``mean``/``var`` map onto the ``conv.{2i+1}`` BatchNorm
buffers, for either ``feat_comb`` (a ``post`` conv0 kernel has
``feat_dim`` input channels, a ``pre`` one twice that). A JAX
``TrainState``'s ``params`` and ``batch_stats`` load with
:func:`load_jax_train_state`; its optax state becomes the port's
``torch.optim`` state with :func:`optimizer_state_from_jax` (Adam's
``mu``/``nu``/``count``, or SGD's momentum ``trace``, through the same
layout maps as the weights).

A JAX ``ImMatchNet`` tree maps onto the port's ``ImMatchNet`` with
:func:`immatch_state_dict_from_jax`: its ``FeatureExtraction`` (VGG16
``conv{s}_{i}`` kernels and biases at torchvision's sequential indices;
DenseNet convs and BatchNorms at torchvision's child names) under
``FeatureExtraction.model``, its ``extract`` (ResNet, Bottleneck's
``conv3``/``bn3`` included) under ``extract``, its ``NeighConsensus``
under ``NeighConsensus.conv``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


# A leaf the tree does not hold (an optax ``MaskedNode``: a frozen
# parameter's moment) passes through every layout map as None, and
# ``_to_torch`` drops it.


def _leaf(w):
    return None if w is None else np.asarray(w)


def _conv2d(w) -> np.ndarray:
    return None if w is None else np.transpose(np.asarray(w), (3, 2, 0, 1))


def _linear(w) -> np.ndarray:
    return None if w is None else np.transpose(np.asarray(w), (1, 0))


def _conv4d(w) -> np.ndarray:
    # (k1, k2, k3, k4, in, out) -> (k1, out, in, k2, k3, k4)
    return None if w is None else np.transpose(np.asarray(w), (0, 5, 4, 1, 2, 3))


_BN_LEAVES = (("scale", "weight", "params"), ("bias", "bias", "params"),
              ("mean", "running_mean", "batch_stats"),
              ("var", "running_var", "batch_stats"))


def _put_bn(out, key, params, stats):
    trees = {"params": params, "batch_stats": stats}
    for leaf, tkey, coll in _BN_LEAVES:
        out[f"{key}.{tkey}"] = _leaf(trees[coll][leaf])


def _resnet(out, params, stats):
    p, s = params["extract"], stats["extract"]
    out["extract.conv1.weight"] = _conv2d(p["conv1"]["kernel"])
    _put_bn(out, "extract.bn1", p["bn1"], s["bn1"])
    for name in sorted(p):
        if not name.startswith("layer"):
            continue
        layer, block = name.split("_")
        pre = f"extract.{layer}.{block}"
        bp, bs = p[name], s[name]
        for conv in ("conv1", "conv2", "conv3"):
            if conv in bp:
                out[f"{pre}.{conv}.weight"] = _conv2d(bp[conv]["kernel"])
                bn = "bn" + conv[-1]
                _put_bn(out, f"{pre}.{bn}", bp[bn], bs[bn])
        if "downsample_conv" in bp:
            out[f"{pre}.downsample.0.weight"] = _conv2d(
                bp["downsample_conv"]["kernel"])
            _put_bn(out, f"{pre}.downsample.1", bp["downsample_bn"],
                    bs["downsample_bn"])


def _ncn(out, p, prefix="ncn."):
    li = 0
    while f"conv{li}_kernel" in p:
        out[f"{prefix}conv.{2 * li}.weight"] = _conv4d(p[f"conv{li}_kernel"])
        out[f"{prefix}conv.{2 * li}.bias"] = _leaf(p[f"conv{li}_bias"])
        li += 1


def _regressor(out, name, params, stats):
    p, s = params[name], stats[name]
    n_conv = sum(1 for k in p if k.startswith("conv") and k[4:].isdigit())
    n_fc = sum(1 for k in p if k.startswith("fc") and k[2:].isdigit())
    for li in range(n_conv):
        out[f"{name}.conv.{2 * li}.weight"] = _conv2d(p[f"conv{li}"]["kernel"])
        _put_bn(out, f"{name}.conv.{2 * li + 1}", p[f"convbn{li}"],
                s[f"convbn{li}"])
    for li in range(n_fc):
        out[f"{name}.fc.{3 * li}.weight"] = _linear(p[f"fc{li}"]["kernel"])
        out[f"{name}.fc.{3 * li}.bias"] = _leaf(p[f"fc{li}"]["bias"])
        _put_bn(out, f"{name}.fc.{3 * li + 1}", p[f"fcbn{li}"], s[f"fcbn{li}"])
    out[f"{name}.fc.{3 * n_fc}.weight"] = _linear(p["fc_out"]["kernel"])
    out[f"{name}.fc.{3 * n_fc}.bias"] = _leaf(p["fc_out"]["bias"])


def _to_torch(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()
            if v is not None}


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` tree of numpy arrays -> the port's
    state dict (reference key names, reference layouts)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: Dict[str, np.ndarray] = {}
    _resnet(out, params, stats)
    _ncn(out, params["ncn"])
    for name in ("regress_mid", "regress_fine"):
        if name in params:
            _regressor(out, name, params, stats)
    return _to_torch(out)


def regressor_state_dict_from_jax(params: Mapping, stats: Mapping) -> Dict[str, torch.Tensor]:
    """One JAX ``FeatRegressNet``'s ``params`` and ``batch_stats`` (either
    ``feat_comb``) -> the state dict of the port's ``FeatRegressNet``."""
    out: Dict[str, np.ndarray] = {}
    _regressor(out, "r", {"r": params}, {"r": stats})
    return _to_torch({k[2:]: v for k, v in out.items()})


def ncn_state_dict_from_jax(ncn_params: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX ``NeighConsensus`` params dict (``conv{i}_kernel``,
    ``conv{i}_bias``, any number of layers) -> the state dict of the
    port's ``NeighConsensus``."""
    out: Dict[str, np.ndarray] = {}
    _ncn(out, ncn_params, prefix="")
    return _to_torch(out)


def load_jax_variables(model: torch.nn.Module, variables: Mapping) -> None:
    """Load a JAX variable tree into a port ``Patch2Pix``. Only the
    keys the JAX tree cannot hold (``layer4``, ``num_batches_tracked``)
    may stay at their initial values."""
    _load_checked(model, state_dict_from_jax(variables))


def _vgg(out, p, prefix):
    from patch2pix_tpu_torch.models.vgg import VGG16_LAYERS

    for idx, (name, kind, _) in enumerate(VGG16_LAYERS):
        if kind == "conv" and name in p:
            out[f"{prefix}{idx}.weight"] = _conv2d(p[name]["kernel"])
            out[f"{prefix}{idx}.bias"] = np.asarray(p[name]["bias"])


def _densenet(out, p, s, prefix):
    out[f"{prefix}conv0.weight"] = _conv2d(p["conv0"]["kernel"])
    _put_bn(out, f"{prefix}norm0", p["norm0"], s["norm0"])
    for name in sorted(p):
        if name.startswith("denseblock"):
            block, layer = name.split("_")
            pre = f"{prefix}{block}.{layer}"
            for conv in ("conv1", "conv2"):
                out[f"{pre}.{conv}.weight"] = _conv2d(p[name][conv]["kernel"])
            for norm in ("norm1", "norm2"):
                _put_bn(out, f"{pre}.{norm}", p[name][norm], s[name][norm])
        elif name.startswith("transition"):
            trans, leaf = name.split("_")
            if leaf == "conv":
                out[f"{prefix}{trans}.conv.weight"] = _conv2d(p[name]["kernel"])
            else:
                _put_bn(out, f"{prefix}{trans}.norm", p[name], s[name])


def immatch_state_dict_from_jax(variables: Mapping,
                                feature_extraction_cnn: str) -> Dict[str, torch.Tensor]:
    """A JAX ``ImMatchNet``'s ``{"params", "batch_stats"}`` tree -> the
    state dict of the port's ``ImMatchNet`` with the same trunk."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: Dict[str, np.ndarray] = {}
    if feature_extraction_cnn == "vgg":
        _vgg(out, params["FeatureExtraction"], "FeatureExtraction.model.")
    elif feature_extraction_cnn == "densenet201":
        _densenet(out, params["FeatureExtraction"], stats["FeatureExtraction"],
                  "FeatureExtraction.model.")
    else:
        _resnet(out, params, stats)
    _ncn(out, params["NeighConsensus"], prefix="NeighConsensus.")
    return _to_torch(out)


def load_jax_immatch_variables(model: torch.nn.Module, variables: Mapping) -> None:
    """Load a JAX ``ImMatchNet`` variable tree into the port's
    ``ImMatchNet``; only ``layer4`` and ``num_batches_tracked`` (which
    the JAX tree does not hold) may stay at their initial values."""
    _load_checked(model, immatch_state_dict_from_jax(variables, model.feature_extraction_cnn))


def _load_checked(model, sd) -> None:
    missing, unexpected = model.load_state_dict(sd, strict=False)
    bad = [k for k in missing
           if ".layer4." not in k and not k.endswith("num_batches_tracked")]
    if bad or unexpected:
        raise KeyError(f"missing {bad}, unexpected {list(unexpected)}")


def load_jax_train_state(model: torch.nn.Module, state) -> None:
    """Load a JAX ``TrainState``'s ``params`` and ``batch_stats`` into a
    port ``Patch2Pix`` (as :func:`load_jax_variables`)."""
    load_jax_variables(model, {"params": state.params, "batch_stats": state.batch_stats})


class _NoStats(dict):
    """A ``batch_stats`` tree with no leaf: moments exist for parameters
    only."""

    def __missing__(self, key):
        return None if key in ("mean", "var") else _NoStats()


def _unmask(tree):
    """An optax moment tree with each ``MaskedNode`` leaf (a parameter
    the optimizer does not update) as None."""
    if type(tree).__name__ == "MaskedNode":
        return None
    if isinstance(tree, Mapping):
        return {k: _unmask(v) for k, v in tree.items()}
    return tree


def _nodes(tree, fields) -> list:
    """Every node of an optax state that holds all of ``fields``: a
    NamedTuple (a state restored on a template) or a dict (one restored
    without), at any depth, as a dict of those fields."""
    if type(tree).__name__ == "MaskedNode":
        return []
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, Mapping):
        if all(f in tree for f in fields):
            return [{f: tree[f] for f in fields}]
        children = tree.values()
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return []
    return [n for v in children for n in _nodes(v, fields)]


def _optimizer_node(opt_state, fields) -> dict:
    found = _nodes(opt_state, fields)
    if len(found) != 1:
        raise ValueError(f"the optax state holds {len(found)} nodes with {fields}; "
                         f"expected one")
    return found[0]


def optimizer_state_from_jax(opt_state, model: torch.nn.Module, optimizer) -> dict:
    """A JAX ``TrainState.opt_state`` (optax Adam or SGD with momentum,
    inside the JAX package's ``multi_transform`` freeze mask) -> the
    ``state_dict`` of ``optimizer.inner``, the port's ``torch.optim``
    optimizer over ``model``'s trainable parameters (``train.state``).

    Adam's ``mu``/``nu`` become ``exp_avg``/``exp_avg_sq`` and its
    ``count`` every parameter's ``step``; SGD's ``trace`` becomes
    ``momentum_buffer``. The moment trees go through
    :func:`state_dict_from_jax`'s layout maps as if they were the
    parameters. Frozen parameters (``MaskedNode`` in the optax tree) get
    no state: the port's optimizer never holds them. Raises
    ``KeyError`` when a parameter the optimizer holds has no moment in
    the tree, or its shape differs."""
    names = {id(p): n for n, p in model.named_parameters()}
    held = [names[id(p)] for g in optimizer.inner.param_groups for p in g["params"]]
    shapes = dict(model.named_parameters())

    def moments(tree, field):
        sd = state_dict_from_jax({"params": _unmask(tree), "batch_stats": _NoStats()})
        bad = [n for n in held if n not in sd or sd[n].shape != shapes[n].shape]
        if bad:
            raise KeyError(f"no {field!r} moment of the right shape for {bad}")
        return sd

    if isinstance(optimizer.inner, torch.optim.Adam):
        node = _optimizer_node(opt_state, ("count", "mu", "nu"))
        mu, nu = moments(node["mu"], "mu"), moments(node["nu"], "nu")
        count = float(np.asarray(node["count"]))
        state = {i: {"step": torch.tensor(count), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                 for i, n in enumerate(held)}
    elif isinstance(optimizer.inner, torch.optim.SGD):
        trace = moments(_optimizer_node(opt_state, ("trace",))["trace"], "trace")
        state = {i: {"momentum_buffer": trace[n]} for i, n in enumerate(held)}
    else:
        raise ValueError(f"unsupported optimizer {type(optimizer.inner).__name__}")
    return {"state": state, "param_groups": optimizer.inner.state_dict()["param_groups"]}
