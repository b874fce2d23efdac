"""Synthetic epipolar-consistent training pairs with a known F.

A copy of ``patch2pix_tpu.data.synthetic`` (numpy only), kept in the
port so that it imports nothing of the JAX package. The reference trains
on MegaDepth pairs whose ground-truth F comes from COLMAP poses; this
module fabricates geometrically exact pairs instead:

  * a textured image (band-limited noise, enough structure for the
    correlation to latch onto),
  * a second view of the same PLANE under a random relative pose
    (R, t): the warp is the plane-induced homography
    ``H = K2 (R - t n^T / d) K1^{-1}`` and the pair is consistent with
    the fundamental matrix ``F = K2^{-T} [t]_x R K1^{-1}``, so every
    correspondence (x1, H x1) satisfies the epipolar constraint exactly
    and the loss's Sampson-threshold labels are clean.

Host-side numpy; returns channels-last float32 batches. The same
``RandomState`` seed gives the same batch as the JAX package's module.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def skew(t: np.ndarray) -> np.ndarray:
    return np.array(
        [[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]], np.float64
    )


def rot_xyz(rx: float, ry: float, rz: float) -> np.ndarray:
    cx, sx, cy, sy, cz, sz = (
        np.cos(rx), np.sin(rx), np.cos(ry), np.sin(ry), np.cos(rz), np.sin(rz),
    )
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def textured_image(rs: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """Band-limited random texture in [0, 1] with multi-scale detail."""
    im = np.zeros((h, w, 3), np.float32)
    for scale in (8, 16, 32):
        small = rs.rand(h // scale + 2, w // scale + 2, 3).astype(np.float32)
        ys = np.linspace(0, small.shape[0] - 1.001, h)
        xs = np.linspace(0, small.shape[1] - 1.001, w)
        y0, x0 = ys.astype(int), xs.astype(int)
        fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
        up = (
            small[y0][:, x0] * (1 - fy) * (1 - fx)
            + small[y0][:, x0 + 1] * (1 - fy) * fx
            + small[y0 + 1][:, x0] * fy * (1 - fx)
            + small[y0 + 1][:, x0 + 1] * fy * fx
        )
        im += up / len((8, 16, 32))
    return im


def warp_homography(im: np.ndarray, H: np.ndarray) -> np.ndarray:
    """Inverse-warp ``im`` by homography ``H`` (x2 = H x1), bilinear."""
    h, w, _ = im.shape
    Hinv = np.linalg.inv(H)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pts = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)], axis=0)
    src = Hinv @ pts
    sx = src[0] / src[2]
    sy = src[1] / src[2]
    x0 = np.clip(np.floor(sx).astype(int), 0, w - 2)
    y0 = np.clip(np.floor(sy).astype(int), 0, h - 2)
    fx = np.clip(sx - x0, 0, 1)[:, None]
    fy = np.clip(sy - y0, 0, 1)[:, None]
    out = (
        im[y0, x0] * (1 - fy) * (1 - fx)
        + im[y0, x0 + 1] * (1 - fy) * fx
        + im[y0 + 1, x0] * fy * (1 - fx)
        + im[y0 + 1, x0 + 1] * fy * fx
    )
    return out.reshape(h, w, 3).astype(np.float32)


def load_texture_pool(paths) -> list:
    """Real photographs as texture sources: natural-image statistics
    instead of band-limited noise for the synthetic-pair generator.
    Returns a list of float32 [0, 1] HxWx3 arrays."""
    from PIL import Image

    pool = []
    for p in paths:
        im = np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0
        pool.append(im)
    return pool


def textured_image_from_pool(
    rs: np.random.RandomState, h: int, w: int, pool: list
) -> np.ndarray:
    """Random crop (+flip/brightness jitter) of a pooled real image,
    resized to (h, w) if the crop must shrink to fit."""
    im = pool[rs.randint(len(pool))]
    ih, iw = im.shape[:2]
    # crop at a random scale in [1, 2]x the target, then box-resize
    s = rs.uniform(1.0, min(2.0, ih / h, iw / w)) if (
        ih >= h and iw >= w) else 1.0
    ch, cw = min(int(h * s), ih), min(int(w * s), iw)
    y0 = rs.randint(ih - ch + 1)
    x0 = rs.randint(iw - cw + 1)
    crop = im[y0:y0 + ch, x0:x0 + cw]
    if (ch, cw) != (h, w):
        ys = np.clip((np.arange(h) * ch / h).astype(int), 0, ch - 1)
        xs = np.clip((np.arange(w) * cw / w).astype(int), 0, cw - 1)
        crop = crop[ys][:, xs]
    if rs.rand() < 0.5:
        crop = crop[:, ::-1]
    crop = np.clip(crop * rs.uniform(0.7, 1.3) + rs.uniform(-0.08, 0.08),
                   0.0, 1.0)
    return np.ascontiguousarray(crop, np.float32)


def make_pair(
    rs: np.random.RandomState, h: int, w: int,
    max_angle: float = 0.12, max_shift: float = 0.25,
    texture_pool: list | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One planar-scene pair. Returns (im1, im2, F, H) with F and the
    plane homography H in the pixel frame (H gives exact dense
    correspondence x2 = H x1 — used by the self-supervised backbone
    warm-up)."""
    f = 0.9 * max(h, w)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float64)
    R = rot_xyz(*(rs.uniform(-max_angle, max_angle, 3)))
    t = rs.uniform(-max_shift, max_shift, 3)
    t[2] = rs.uniform(-0.05, 0.05)
    n = np.array([0.0, 0.0, 1.0])
    d = 2.0
    Kinv = np.linalg.inv(K)
    H = K @ (R - np.outer(t, n) / d) @ Kinv
    F = Kinv.T @ skew(t) @ R @ Kinv
    F /= np.linalg.norm(F)

    if texture_pool:
        im1 = textured_image_from_pool(rs, h, w, texture_pool)
    else:
        im1 = textured_image(rs, h, w)
    im2 = warp_homography(im1, H)
    return im1, im2, F.astype(np.float32), H.astype(np.float32)


def imagenet_normalize(im: np.ndarray) -> np.ndarray:
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    return (im - mean) / std


def synthetic_batch(
    rs: np.random.RandomState, batch: int, h: int, w: int,
    texture_pool: list | None = None,
    with_h: bool = False,
) -> Dict[str, np.ndarray]:
    """A training batch dict {im1, im2, F} of epipolar-consistent pairs
    (optionally + the exact plane homographies ``H``)."""
    im1s, im2s, fs, hs = [], [], [], []
    for _ in range(batch):
        im1, im2, F, H = make_pair(rs, h, w, texture_pool=texture_pool)
        im1s.append(imagenet_normalize(im1))
        im2s.append(imagenet_normalize(im2))
        fs.append(F)
        hs.append(H)
    out = {
        "im1": np.stack(im1s),
        "im2": np.stack(im2s),
        "F": np.stack(fs),
    }
    if with_h:
        out["H"] = np.stack(hs)
    return out
