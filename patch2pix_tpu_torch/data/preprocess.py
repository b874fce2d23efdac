"""Host-side image loading / preprocessing (numpy + PIL, channels-last).

A copy of ``patch2pix_tpu.data.preprocess``: HWC float32 arrays, eval
sizes snapped to multiples of ``upsample * ksize``, and the training
loader's bottom-right aspect crop and intrinsics rescale. PIL is
imported inside the loaders so the package imports without it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def imagenet_normalize(im: np.ndarray) -> np.ndarray:
    """HWC float32 in [0, 1] -> ImageNet-normalised."""
    return (im - IMAGENET_MEAN) / IMAGENET_STD


def to_array(im, normalize: bool = True) -> np.ndarray:
    """PIL RGB -> HWC float32, scaled to [0,1], optionally normalised."""
    arr = np.asarray(im, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if normalize:
        arr = imagenet_normalize(arr)
    return arr


def load_image(path: str, crop: Optional[Tuple[float, float]] = None):
    """Open an RGB image (PIL); optionally crop (dw, dh) from the
    bottom-right: keep rows [0, h-dh) and cols [0, w-dw)."""
    from PIL import Image

    im = Image.open(path).convert("RGB")
    if crop is not None:
        dw, dh = int(crop[0]), int(crop[1])
        if dw or dh:
            im = im.crop((0, 0, im.width - dw, im.height - dh))
    return im


def cal_rescale_size(
    image_size: int, w: int, h: int, k_size: int = 2, upsample: int = 16
) -> Tuple[int, int]:
    """Largest (wt, ht) with max-dim scale ``image_size`` snapped DOWN to
    multiples of ``upsample * k_size``."""
    unit = upsample * k_size
    s = max(w, h) / image_size
    wt = int(math.floor(w / s / unit)) * unit
    ht = int(math.floor(h / s / unit)) * unit
    return wt, ht


def load_im_flexible(
    path: str,
    k_size: int = 2,
    upsample: int = 16,
    imsize: Optional[int] = None,
) -> Tuple[np.ndarray, Tuple[float, float]]:
    """Load an arbitrary image for matching: resize to the snapped grid.

    Returns (HWC normalised float32, (sx, sy)) where the scale maps
    matches back to original pixels (original / resized).
    """
    from PIL import Image

    im = load_image(path)
    wo, ho = im.width, im.height
    target = imsize if (imsize and imsize > 0) else max(wo, ho)
    target = min(target, max(wo, ho))  # never upsample
    wt, ht = cal_rescale_size(target, wo, ho, k_size, upsample)
    im = im.resize((wt, ht), Image.BICUBIC)
    return to_array(im), (wo / wt, ho / ht)


def load_im_tensor(path: str, imsize: Optional[int] = None, with_gray: bool = False):
    """Load + optionally resize to max dim ``imsize``; return the
    normalised RGB array, with ``with_gray`` also the unnormalised
    (H, W, 1) gray image in [0, 1], and the (sx, sy) scale."""
    from PIL import Image

    im = Image.open(path).convert("RGB")
    wo, ho = im.width, im.height
    wt, ht = wo, ho
    if imsize and imsize > 0 and max(wo, ho) > imsize:
        s = imsize / max(wo, ho)
        wt, ht = int(round(wo * s)), int(round(ho * s))
        im = im.resize((wt, ht), Image.BICUBIC)
    scale = (wo / wt, ho / ht)
    rgb = to_array(im)
    if with_gray:
        gray = np.asarray(im.convert("L"), dtype=np.float32)[..., None] / 255.0
        return rgb, gray, scale
    return rgb, scale


def crop_from_bottom_right(w: int, h: int, target_ratio: float = 1.5,
                           min_ratio: float = 1.3, max_ratio: float = 1.7
                           ) -> Optional[Tuple[float, float]]:
    """Bottom-right crop (dw, dh) bringing aspect w/h to ``target_ratio``;
    None when the aspect is outside [min_ratio, max_ratio] (the pair is
    rejected). The kept height is even, the kept width a multiple of 3."""
    ratio = w / h
    if ratio < min_ratio or ratio > max_ratio:
        return None
    if ratio == target_ratio:
        return 0.0, 0.0
    if ratio > target_ratio:
        dh = h % 2
        dw = w - (h - dh) * target_ratio
    else:
        dw = w % 3
        dh = h - (w - dw) / target_ratio
    return dw, dh


def scale_intrinsic(K: np.ndarray, wi: int, hi: int, wt: int, ht: int) -> np.ndarray:
    """Rescale a 3x3 intrinsic matrix for an (wi, hi) -> (wt, ht) resize."""
    return np.diag([wt / wi, ht / hi, 1.0]) @ K
