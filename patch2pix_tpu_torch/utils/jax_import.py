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
``TrainState`` (its ``params`` and ``batch_stats``; the
optimizer state is not carried) loads with :func:`load_jax_train_state`.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _conv2d(w) -> np.ndarray:
    return np.transpose(np.asarray(w), (3, 2, 0, 1))


def _linear(w) -> np.ndarray:
    return np.transpose(np.asarray(w), (1, 0))


def _conv4d(w) -> np.ndarray:
    # (k1, k2, k3, k4, in, out) -> (k1, out, in, k2, k3, k4)
    return np.transpose(np.asarray(w), (0, 5, 4, 1, 2, 3))


_BN_LEAVES = (("scale", "weight", "params"), ("bias", "bias", "params"),
              ("mean", "running_mean", "batch_stats"),
              ("var", "running_var", "batch_stats"))


def _put_bn(out, key, params, stats):
    trees = {"params": params, "batch_stats": stats}
    for leaf, tkey, coll in _BN_LEAVES:
        out[f"{key}.{tkey}"] = np.asarray(trees[coll][leaf])


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
        out[f"{prefix}conv.{2 * li}.bias"] = np.asarray(p[f"conv{li}_bias"])
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
        out[f"{name}.fc.{3 * li}.bias"] = np.asarray(p[f"fc{li}"]["bias"])
        _put_bn(out, f"{name}.fc.{3 * li + 1}", p[f"fcbn{li}"], s[f"fcbn{li}"])
    out[f"{name}.fc.{3 * n_fc}.weight"] = _linear(p["fc_out"]["kernel"])
    out[f"{name}.fc.{3 * n_fc}.bias"] = np.asarray(p["fc_out"]["bias"])


def _to_torch(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


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
    missing, unexpected = model.load_state_dict(
        state_dict_from_jax(variables), strict=False)
    bad = [k for k in missing
           if ".layer4." not in k and not k.endswith("num_batches_tracked")]
    if bad or unexpected:
        raise KeyError(f"missing {bad}, unexpected {list(unexpected)}")


def load_jax_train_state(model: torch.nn.Module, state) -> None:
    """Load a JAX ``TrainState``'s ``params`` and ``batch_stats`` into a
    port ``Patch2Pix`` (as :func:`load_jax_variables`)."""
    load_jax_variables(model, {"params": state.params, "batch_stats": state.batch_stats})
