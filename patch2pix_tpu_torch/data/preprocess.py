"""Host-side image loading / preprocessing (numpy + PIL, channels-last).

A copy of ``patch2pix_tpu.data.preprocess``'s eval loaders: HWC float32
arrays, sizes snapped to multiples of ``upsample * ksize``. PIL is
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

    im = Image.open(path).convert("RGB")
    wo, ho = im.width, im.height
    target = imsize if (imsize and imsize > 0) else max(wo, ho)
    target = min(target, max(wo, ho))  # never upsample
    wt, ht = cal_rescale_size(target, wo, ho, k_size, upsample)
    im = im.resize((wt, ht), Image.BICUBIC)
    return to_array(im), (wo / wt, ho / ht)


def load_im_tensor(path: str, imsize: Optional[int] = None):
    """Load + optionally resize to max dim ``imsize``; return the
    normalised RGB array and its (sx, sy) scale."""
    from PIL import Image

    im = Image.open(path).convert("RGB")
    wo, ho = im.width, im.height
    wt, ht = wo, ho
    if imsize and imsize > 0 and max(wo, ho) > imsize:
        s = imsize / max(wo, ho)
        wt, ht = int(round(wo * s)), int(round(ho * s))
        im = im.resize((wt, ht), Image.BICUBIC)
    return to_array(im), (wo / wt, ho / ht)
