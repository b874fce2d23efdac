"""Inference façade: load checkpoints and estimate matches on images.

Port of ``patch2pix_tpu.evaluation.matcher``. It runs eagerly (no
compile cache); images are snapped to multiples of ``upsample * ksize``
as the reference does, and the fixed-shape device output becomes the
reference's variable-length numpy contract at the host boundary.
Reference ``.pth`` checkpoints load as they are: the port's modules use
the reference's key names; a checkpoint directory written by the port's
training (``train/checkpoint.py``) loads through ``restore_for_eval``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from patch2pix_tpu_torch.config import ModelConfig, RegressorConfig, resolve_device
from patch2pix_tpu_torch.data.preprocess import load_im_flexible, load_im_tensor
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix


def _config_from_torch_ckpt(ckpt: dict, method: str) -> ModelConfig:
    """Reference checkpoint dict -> ModelConfig (eval forces panc=1)."""
    if "patch2pix" in method:
        rc = ckpt["regressor_config"]
        reg = RegressorConfig(
            feat_comb=getattr(rc, "feat_comb", "pre"),
            conv_kers=tuple(getattr(rc, "conv_kers", (3, 3))),
            conv_dims=tuple(getattr(rc, "conv_dims", (512, 512))),
            conv_strs=tuple(getattr(rc, "conv_strs", (2, 1))),
            fc_dims=tuple(getattr(rc, "fc_dims", (512, 256))),
            psize=tuple(getattr(rc, "psize", (16, 16))),
            pshift=int(getattr(rc, "pshift", 8)),
            panc=1,
            shared=bool(getattr(rc, "shared", False)),
        )
        return ModelConfig(
            backbone=ckpt.get("backbone", "ResNet34"),
            change_stride=bool(ckpt.get("change_stride", True)),
            feat_idx=tuple(ckpt.get("feat_idx", (0, 1, 2, 3))),
            regressor=reg,
        ).resolved()
    # NCNet-only coarse matcher: Patch2Pix without regressors
    return ModelConfig(backbone="ResNet34", change_stride=True,
                       regressor=None).resolved()


def load_model(ckpt_path: str, method: str = "patch2pix", device=None,
               dtype: Optional[str] = None, tag: str = "last") -> Patch2Pix:
    """Build a Patch2Pix model from a reference ``.pth`` checkpoint
    (computing in ``dtype``, float32 by default), or from a checkpoint
    directory of the port's training (its ``tag``; the dtype it was
    trained in unless ``dtype`` is given). A full Patch2Pix checkpoint
    must hold every key; an NCNet-only checkpoint may leave keys at
    their initial values."""
    if os.path.isdir(ckpt_path):
        from patch2pix_tpu_torch.train.checkpoint import restore_for_eval

        return restore_for_eval(ckpt_path, tag, device=device, dtype=dtype)
    device = resolve_device(device)
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    if not isinstance(ckpt, dict):
        raise ValueError(f"unsupported checkpoint object: {type(ckpt)}")
    cfg = _config_from_torch_ckpt(ckpt, method)
    cfg.dtype = dtype or "float32"
    model = Patch2Pix(cfg, device=device)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if unexpected or ("patch2pix" in method and missing):
        raise KeyError(f"checkpoint keys: missing {missing}, "
                       f"unexpected {unexpected}")
    return model


class Matcher:
    """Callable matcher around a :class:`Patch2Pix`; runs on CUDA unless
    ``device`` is given."""

    def __init__(
        self,
        model: Patch2Pix,
        ksize: int = 2,
        io_thres: float = 0.25,
        ncn_thres: float = 0.0,
        mutual: bool = True,
        imsize: Optional[int] = None,
        eval_type: str = "fine",
        fine_cap: Optional[int] = 1200,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.ksize = ksize
        self.io_thres = io_thres
        self.ncn_thres = ncn_thres
        self.mutual = mutual
        self.imsize = imsize
        self.eval_type = eval_type
        # bound on rows entering the regression stages: exact whenever a
        # pair has <= fine_cap valid coarse matches, score-ranked
        # truncation beyond
        self.fine_cap = fine_cap
        self.upsample = model.config.upsample
        self.cap_stats = self._fresh_cap_stats()

    @staticmethod
    def _fresh_cap_stats() -> dict:
        return {
            "pairs": 0,
            "cap_hits": 0,
            "valid_sum": 0,
            "valid_min": None,
            "valid_max": None,
            # bucket k counts pairs with valid count in [2^k, 2^(k+1));
            # bucket 0 is the 0-or-1 corner
            "valid_hist": [0] * 24,
        }

    def _record_cap_stats(self, n_valid: int) -> None:
        s = self.cap_stats
        s["pairs"] += 1
        s["valid_sum"] += n_valid
        s["valid_min"] = n_valid if s["valid_min"] is None else min(s["valid_min"], n_valid)
        s["valid_max"] = n_valid if s["valid_max"] is None else max(s["valid_max"], n_valid)
        s["valid_hist"][min(max(n_valid, 1).bit_length() - 1, 23)] += 1
        if self.fine_cap is not None and n_valid >= self.fine_cap:
            s["cap_hits"] += 1

    def _batch(self, im: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(im, np.float32))[None].to(self.device)

    # ------------------------------------------------------------ API

    def match_arrays(
        self, im1: np.ndarray, im2: np.ndarray,
        scale1: Sequence[float] = (1.0, 1.0), scale2: Sequence[float] = (1.0, 1.0),
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Match two preprocessed HWC images (ImageNet-normalised, sides
        multiples of ``upsample * ksize``). ``scale*`` map matches back
        to original pixels. Returns (matches, scores, coarse_matches)."""
        upscale = np.asarray([*scale1, *scale2], np.float64)
        b1, b2 = self._batch(im1), self._batch(im2)
        if self.eval_type == "coarse":
            cm = self.model.predict_coarse(b1, b2, ksize=self.ksize,
                                           ncn_thres=self.ncn_thres,
                                           mutual=self.mutual)
            valid = cm.valid[0].cpu().numpy()
            matches = cm.coords[0].cpu().numpy()[valid] * upscale
            return matches, cm.scores[0].cpu().numpy()[valid], matches

        fine, _, coarse = self.model.predict_fine(
            b1, b2, ksize=self.ksize, ncn_thres=self.ncn_thres,
            mutual=self.mutual, fine_cap=self.fine_cap)
        valid = fine.valid[0].cpu().numpy()
        self._record_cap_stats(int(valid.sum()))
        fmat = fine.coords[0].cpu().numpy()[valid]
        fscore = fine.scores[0].cpu().numpy()[valid]
        cmat = coarse.coords[0].cpu().numpy()[valid]
        # io_thres filter with the reference keep-all fallback
        pos = fscore > self.io_thres
        if pos.any():
            fmat, fscore, cmat = fmat[pos], fscore[pos], cmat[pos]
        return fmat * upscale, fscore, cmat * upscale

    def estimate_matches(self, im1_path: str, im2_path: str):
        """Match two image files; returns (matches, scores,
        coarse_matches) in ORIGINAL image pixel coordinates."""
        im1, sc1 = load_im_flexible(im1_path, self.ksize, self.upsample, imsize=self.imsize)
        im2, sc2 = load_im_flexible(im2_path, self.ksize, self.upsample, imsize=self.imsize)
        return self.match_arrays(im1, im2, sc1, sc2)

    __call__ = estimate_matches

    def refine_matches(self, im1_path: str, im2_path: str,
                       coarse_matches: np.ndarray, io_thres: float = 0.0,
                       max_matches: int = 2048):
        """Refine an external detector's ``(N, 4)`` matches given in the
        ORIGINAL frames (plug-in mode). Returns (refined, scores, coarse)
        in original coords. ``max_matches`` is the JAX package's slot
        count, which pads the rows to bound its recompiles; rows are
        independent at eval and nothing compiles here, so no row is
        padded and the result does not depend on it."""
        del max_matches
        im1, sc1 = load_im_tensor(im1_path, self.imsize)
        im2, sc2 = load_im_tensor(im2_path, self.imsize)
        return self.refine_matches_arrays(im1, im2, coarse_matches, sc1, sc2, io_thres)

    def refine_matches_arrays(
        self, im1: np.ndarray, im2: np.ndarray, coarse_matches: np.ndarray,
        scale1: Sequence[float] = (1.0, 1.0), scale2: Sequence[float] = (1.0, 1.0),
        io_thres: float = 0.0,
    ):
        """:meth:`refine_matches` on preprocessed HWC images whose
        ``scale*`` map them to the original frames."""
        n = coarse_matches.shape[0]
        if n == 0:
            z = np.zeros((0, 4))
            return z, np.zeros((0,)), z
        downscale = 1.0 / np.asarray([*scale1, *scale2], np.float64)
        coords = torch.from_numpy(
            (np.asarray(coarse_matches, np.float64) * downscale).astype(np.float32)
        )[None].to(self.device)
        fmat, fscore, _, _ = self.model.refine_matches(
            self._batch(im1), self._batch(im2), coords)
        fmat, fscore = fmat[0].cpu().numpy(), fscore[0].cpu().numpy()
        pos = fscore > io_thres
        if pos.any():
            fmat, fscore = fmat[pos], fscore[pos]
            coarse_matches = np.asarray(coarse_matches)[pos]
        return fmat / downscale, fscore, coarse_matches


def estimate_matches(model: Patch2Pix, im1_path: str, im2_path: str, ksize: int = 2,
                     ncn_thres: float = 0.0, mutual: bool = True, io_thres: float = 0.25,
                     eval_type: str = "fine", imsize: Optional[int] = None, device=None):
    """One-shot matching of two image files (the JAX package's
    functional API): a :class:`Matcher` with these settings, then its
    ``estimate_matches``."""
    return Matcher(model, ksize=ksize, io_thres=io_thres, ncn_thres=ncn_thres,
                   mutual=mutual, imsize=imsize, eval_type=eval_type,
                   device=device).estimate_matches(im1_path, im2_path)


def init_patch2pix_matcher(ckpt: str, ksize: int = 2, io_thres: float = 0.25,
                           imsize: Optional[int] = None, device=None) -> Matcher:
    """A fine matcher from a reference ``.pth`` or a training run
    directory (its ``last`` checkpoint)."""
    model = load_model(ckpt, method="patch2pix", device=device)
    return Matcher(model, ksize=ksize, io_thres=io_thres, imsize=imsize,
                   eval_type="fine", device=device)


def init_ncn_matcher(ckpt: str, ksize: int = 2, ncn_thres: float = 0.0,
                     imsize: Optional[int] = None, device=None) -> Matcher:
    model = load_model(ckpt, method="nc", device=device)
    return Matcher(model, ksize=ksize, ncn_thres=ncn_thres, imsize=imsize,
                   eval_type="coarse", mutual=True, device=device)
