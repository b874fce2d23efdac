"""Patch2Pix pipeline: coarse 4D-correlation matching + two-stage
pixel-level regression.

Port of ``patch2pix_tpu.models.patch2pix``: fixed-shape ``(B, N, 4)``
matches with validity masks, both regressor stages as one batched
forward over every proposal. Behaviour kept from the reference:

  * regressor offsets are ``psize * tanh(relu(out)) - psize/2``,
  * coarse matches are grid indices * upsample + upsample/2,
  * eval uses panc=1 (anchors are the coarse matches),
  * match coords are clamped to ``[0, W]`` (inclusive W).

Kernels on this path: B2 (``corr_pool``) whenever ksize == 2 and the
feature maps have even sides, B1 (``tap_sum``) in both NCN branches,
B3 (``expand_scale_pair``) in every regression stage that is not
grid-aligned.

``forward`` is the training forward (the JAX ``__call__``): coarse
matches, ``select_ptmax``, ``panc`` anchors, then both regression stages
with the regressors' BatchNorms on batch statistics, differentiable
through B1-B3's backward passes. With ``backbone_train_bn`` the backbone
runs once per image side on batch statistics too (stacking the sides
would change them) and its running averages move; the kernels on the
path are the same.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from patch2pix_tpu_torch.config import ModelConfig, resolve_device
from patch2pix_tpu_torch.models.ncn import NeighConsensus
from patch2pix_tpu_torch.models.regressor import FeatRegressNet, update_running_stats
from patch2pix_tpu_torch.models.resnet import BACKBONES
from patch2pix_tpu_torch.ops.corr_pool import corr_pool, corr_pool_supported
from patch2pix_tpu_torch.ops.correlation import (
    feat_correlation,
    l2_normalize,
    maxpool4d_values,
    mutual_matching,
)
from patch2pix_tpu_torch.ops.match_extract import (
    Matches,
    corr_to_matches,
    grid_to_pixel,
    mutual_consistency_mask,
    score_threshold_mask,
    select_ptmax,
)
from patch2pix_tpu_torch.ops.patch_gather import (
    gather_local_patches_grid_levels,
    gather_local_patches_levels,
    gather_scaled_patch_pairs_fused,
    make_padded_tiles_levels,
    tileable,
)


def shift_to_anchors(coords: torch.Tensor, pshift: int, panc: int) -> torch.Tensor:
    """Expand each match to ``panc`` corner anchors: ``(B, N, 4)`` ->
    ``(B, N*panc, 4)``; panc=1 is the identity."""
    if panc == 1:
        return coords
    s = float(pshift)
    template = torch.tensor(
        [[-s, -s, 0, 0], [s, -s, 0, 0], [-s, s, 0, 0], [s, s, 0, 0],
         [0, 0, -s, -s], [0, 0, s, -s], [0, 0, -s, s], [0, 0, s, s]],
        dtype=coords.dtype, device=coords.device)[:panc]
    b, n, _ = coords.shape
    return (coords[:, :, None, :] + template).reshape(b, n * panc, 4)


def parse_regressor_out(out, in_coords, psize: int, ptype: str, bounds):
    """Raw regressor output ``(B, N, 5)`` -> refined matches (clamped to
    the image bounds, inclusive) and confidences. The clamp is a
    maximum then a minimum, whose gradient at a bound is halved, as
    ``jnp.clip``'s is; the coordinates keep their gradient, so the fine
    stage's loss reaches the mid regressor through ``in_coords``."""
    w1, h1, w2, h2 = bounds
    offset = float(psize) * torch.tanh(torch.relu(out[..., :4]))
    if ptype == "center":
        offset = offset - float(psize // 2)
    matches = in_coords.float() + offset
    io_probs = torch.sigmoid(out[..., 4])
    lims = torch.tensor([w1, h1, w2, h2], dtype=torch.float32, device=out.device)
    matches = torch.minimum(torch.maximum(matches, torch.zeros_like(lims)), lims)
    return matches, io_probs


class Patch2Pix(nn.Module):
    """The full matching pipeline. Parameters use the reference key
    names (``extract.*``, ``ncn.*``, ``regress_mid.*``,
    ``regress_fine.*``). Built on CUDA unless ``device`` is given."""

    def __init__(self, config: ModelConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        dtype = config.compute_dtype
        if config.backbone not in BACKBONES:
            raise NotImplementedError(f"backbone {config.backbone!r}: only "
                                      f"{list(BACKBONES)} is ported")
        self.extract = BACKBONES[config.backbone](config.change_stride, dtype, device)
        self.ncn = NeighConsensus((3, 3), (16, 1), dtype=dtype, device=device)
        r = config.regressor
        if r is not None:
            kw = dict(feat_dim=r.feat_dim, conv_dims=r.conv_dims,
                      conv_kers=r.conv_kers, conv_strs=r.conv_strs,
                      fc_dims=r.fc_dims, feat_comb=r.feat_comb, dtype=dtype,
                      device=device)
            self.regress_mid = FeatRegressNet(psize=r.psize[0], **kw)
            self.regress_fine = (self.regress_mid if r.shared
                                 else FeatRegressNet(psize=r.psize[1], **kw))
        self.eval()

    # ---------------- coarse stage ----------------

    def extract_pyramid_pair(self, im1, im2, stats=None):
        """Both images' pyramids; one stacked backbone call when the
        shapes match (exact: BN runs on running averages). ``stats``: a
        list to run the backbone's BatchNorms on batch statistics, one
        call per side (``ResNetFeatures.forward``)."""
        if stats is not None or im1.shape != im2.shape:
            return (self.extract(im1, pyramid=True, stats=stats),
                    self.extract(im2, pyramid=True, stats=stats))
        b = im1.shape[0]
        feats = self.extract(torch.cat([im1, im2], dim=0), pyramid=True)
        return tuple(f[:b] for f in feats), tuple(f[b:] for f in feats)

    def coarse_corr(self, feat1, feat2, ksize: int = 1):
        """L2norm -> correlate (+ 2^4 pool) -> mutual -> NCN -> mutual."""
        feat1 = l2_normalize(feat1.contiguous())
        feat2 = l2_normalize(feat2.contiguous())
        delta4d = None
        if ksize > 1 and corr_pool_supported(feat1, feat2, ksize):
            corr = corr_pool(feat1, feat2)
            delta4d = ("feats", feat1, feat2)
        elif ksize > 1:
            corr = feat_correlation(feat1, feat2)
            delta4d = corr
            corr = maxpool4d_values(corr, ksize)
        else:
            corr = feat_correlation(feat1, feat2)
        corr = mutual_matching(corr)
        corr = self.ncn(corr)
        corr = mutual_matching(corr)
        return corr, delta4d

    def coarse_matches(self, corr, delta4d, ksize: int, mutual: bool = True,
                       ncn_thres: float = 0.0) -> Matches:
        """Correlation volume -> fixed-shape pixel matches with validity."""
        nb = corr.shape[3] * corr.shape[4]
        grid, scores, mut = corr_to_matches(corr, delta4d, ksize=ksize)
        valid = mutual_consistency_mask(mut, nb, keep_mutual_only=mutual)
        valid = score_threshold_mask(valid, scores, ncn_thres)
        coords = grid_to_pixel(grid, upsample=self.config.upsample, center=True)
        return Matches(coords, scores, valid)

    # ---------------- fine stage ----------------

    def _shared_tiles(self, feats1, feats2):
        """Padded tile rows shared by the mid and fine stages (None when
        the stages' patch sizes differ or the superblock gather does not
        apply)."""
        cfg = self.config
        r = cfg.regressor
        psize = r.psize[1]
        if r.psize[0] != psize or not (tileable(feats1, psize) and tileable(feats2, psize)):
            return None, None
        return (make_padded_tiles_levels(feats1, cfg.feat_idx, cfg.feats_downsample, psize),
                make_padded_tiles_levels(feats2, cfg.feat_idx, cfg.feats_downsample, psize))

    def fine_match(self, feats1, feats2, coords, stage: str,
                   grid_aligned: bool = False, tiles1=None, tiles2=None, stats=None):
        """One regression stage over every proposal: coords ``(B, N, 4)``
        -> (refined ``(B, N, 4)``, probs ``(B, N)``). ``grid_aligned``
        asserts every coord is a coarse-cell centre and takes the
        space-to-depth gather; otherwise the superblock gather + B3 where
        both pyramids are psize-tileable, else the per-pixel block
        gather. ``stats``: a list to run the regressor on batch
        statistics (``FeatRegressNet.forward``)."""
        cfg = self.config
        r = cfg.regressor
        psize = r.psize[0] if stage == "mid" else r.psize[1]
        regressor = self.regress_mid if stage == "mid" else self.regress_fine
        b, n, _ = coords.shape
        h1, w1 = feats1[0].shape[1], feats1[0].shape[2]
        h2, w2 = feats2[0].shape[1], feats2[0].shape[2]
        bounds = (w1, h1, w2, h2)
        dtype = cfg.compute_dtype

        if not grid_aligned and tileable(feats1, psize) and tileable(feats2, psize):
            patches, smap = gather_scaled_patch_pairs_fused(
                feats1, feats2, coords, cfg.feat_idx, cfg.feats_downsample,
                psize, dtype, tiles1=tiles1, tiles2=tiles2)
            out = regressor(patches, None, slice_map=smap, stats=stats).reshape(b, n, 5)
            return parse_regressor_out(out, coords, psize, "center", bounds)

        def scaled(levels, inv):
            invc = inv if dtype == torch.float32 else inv.to(dtype)
            return tuple((lv.to(dtype) * invc).reshape(b * n, psize, psize, lv.shape[-1])
                         for lv in levels)

        gather = gather_local_patches_grid_levels if grid_aligned else gather_local_patches_levels
        lv1, inv1 = gather(feats1, coords[..., 0:2], cfg.feat_idx, cfg.feats_downsample, psize)
        lv2, inv2 = gather(feats2, coords[..., 2:4], cfg.feat_idx, cfg.feats_downsample, psize)
        out = regressor(scaled(lv1, inv1), scaled(lv2, inv2), stats=stats).reshape(b, n, 5)
        return parse_regressor_out(out, coords, psize, "center", bounds)

    # ---------------- end-to-end paths ----------------

    def forward(self, im1, im2, ksize: int = 2, ptmax: int = 400, train: bool = True,
                backbone_train_bn: bool = False, remat: str = "none", generator=None,
                rand=None):
        """Training forward on NHWC images ``(B, H, W, 3)``: coarse
        matches -> ``ptmax`` proposals per pair (:func:`select_ptmax` with
        ``generator``, or the explicit ``(B, N)`` uniform draw ``rand``)
        -> ``panc`` anchors -> mid stage -> fine stage. Returns the dict
        of the JAX ``__call__``: ``coarse`` (the anchors), ``mid``,
        ``mid_probs``, ``fine``, ``fine_probs``, ``corr``.

        ``train``: the regressors' BatchNorms run on batch statistics and
        their running averages are updated once the stages have run.
        ``remat``: activation checkpointing of the regression stages
        (``torch.utils.checkpoint``, non-reentrant): ``none``, ``fine``
        (the fine stage), ``both``; ``dots`` (the JAX policy that saves
        matmul outputs) recomputes both stages here, as ``both`` does.
        ``backbone_train_bn``: the backbone's BatchNorms run on each
        side's batch statistics and their running averages are updated
        with the regressors'."""
        if remat not in ("none", "fine", "both", "dots"):
            raise ValueError(f"unknown remat mode {remat!r}")
        r = self.config.regressor
        st_backbone = [] if backbone_train_bn else None
        feats1, feats2 = self.extract_pyramid_pair(im1, im2, st_backbone)
        corr, delta4d = self.coarse_corr(feats1[-1], feats2[-1], ksize)
        cm = self.coarse_matches(corr, delta4d, ksize, mutual=True, ncn_thres=0.0)
        sel = select_ptmax(cm.coords, cm.scores, cm.valid, ptmax, generator, rand)
        anchors = shift_to_anchors(sel.coords, r.pshift, r.panc)
        tiles1, tiles2 = self._shared_tiles(feats1, feats2)

        def stage(coords, name):
            # batch statistics are returned, not applied: a checkpointed
            # stage runs twice and its recomputation's are dropped
            st = [] if train else None
            matches, probs = self.fine_match(feats1, feats2, coords, name,
                                             tiles1=tiles1, tiles2=tiles2, stats=st)
            return matches, probs, st

        def run(coords, name, recompute):
            if recompute:
                return checkpoint(stage, coords, name, use_reentrant=False)
            return stage(coords, name)

        mid_matches, mid_probs, st_mid = run(anchors, "mid", remat in ("both", "dots"))
        fine_matches, fine_probs, st_fine = run(mid_matches, "fine", remat != "none")
        if train:
            update_running_stats(st_mid + st_fine)
        if backbone_train_bn:
            update_running_stats(st_backbone)
        return {"coarse": anchors, "mid": mid_matches, "mid_probs": mid_probs,
                "fine": fine_matches, "fine_probs": fine_probs, "corr": corr}

    @torch.inference_mode()
    def predict_coarse(self, im1, im2, ksize: int = 2, ncn_thres: float = 0.0,
                       mutual: bool = False) -> Matches:
        """Coarse-only inference (the NCNet-style matcher)."""
        if im1.shape == im2.shape:
            feat = self.extract(torch.cat([im1, im2], dim=0))
            feat1, feat2 = feat[:im1.shape[0]], feat[im1.shape[0]:]
        else:
            feat1, feat2 = self.extract(im1), self.extract(im2)
        corr, delta4d = self.coarse_corr(feat1, feat2, ksize)
        return self.coarse_matches(corr, delta4d, ksize, mutual, ncn_thres)

    @torch.inference_mode()
    def predict_fine(self, im1, im2, ksize: int = 2, ncn_thres: float = 0.0,
                     mutual: bool = True, fine_cap: Optional[int] = None
                     ) -> Tuple[Matches, Matches, Matches]:
        """Full inference on NHWC images ``(B, H, W, 3)``. Returns
        (fine, mid, coarse) Matches, all carrying the coarse validity.

        ``fine_cap``: bound on the rows entering the regression stages.
        Valid rows are compacted to the front, highest score first
        (a stable sort), so the result is exactly the uncapped one when a
        pair has <= fine_cap valid coarse matches."""
        feats1, feats2 = self.extract_pyramid_pair(im1, im2)
        corr, delta4d = self.coarse_corr(feats1[-1], feats2[-1], ksize)
        cm = self.coarse_matches(corr, delta4d, ksize, mutual, ncn_thres)
        if mutual:
            # every valid row lives in the direction-1 half
            nb = corr.shape[3] * corr.shape[4]
            cm = Matches(cm.coords[:, :nb], cm.scores[:, :nb], cm.valid[:, :nb])
        if fine_cap is not None and fine_cap < cm.coords.shape[1]:
            rank = torch.where(cm.valid, cm.scores,
                               torch.full_like(cm.scores, float("-inf")))
            order = torch.argsort(-rank, dim=1, stable=True)[:, :fine_cap]
            cm = Matches(
                torch.gather(cm.coords, 1, order[..., None].expand(-1, -1, 4)),
                torch.gather(cm.scores, 1, order),
                torch.gather(cm.valid, 1, order),
            )
        r = self.config.regressor
        aligned = self.config.upsample == r.psize[0]
        tiles1, tiles2 = self._shared_tiles(feats1, feats2)
        mid_matches, mid_probs = self.fine_match(
            feats1, feats2, cm.coords, "mid", grid_aligned=aligned,
            tiles1=tiles1, tiles2=tiles2)
        fine_matches, fine_probs = self.fine_match(
            feats1, feats2, mid_matches, "fine", tiles1=tiles1, tiles2=tiles2)
        return (Matches(fine_matches, fine_probs, cm.valid),
                Matches(mid_matches, mid_probs, cm.valid), cm)

    @torch.inference_mode()
    def refine_matches(self, im1, im2, coords):
        """Refine externally provided ``(B, N, 4)`` pixel matches
        (plug-in mode). Returns (fine, fine_probs, mid, mid_probs)."""
        feats1, feats2 = self.extract_pyramid_pair(im1, im2)
        tiles1, tiles2 = self._shared_tiles(feats1, feats2)
        mid_matches, mid_probs = self.fine_match(
            feats1, feats2, coords, "mid", tiles1=tiles1, tiles2=tiles2)
        fine_matches, fine_probs = self.fine_match(
            feats1, feats2, mid_matches, "fine", tiles1=tiles1, tiles2=tiles2)
        return fine_matches, fine_probs, mid_matches, mid_probs
