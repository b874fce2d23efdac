"""Visual localization: query pose from matches against a mapped scene.

Port of ``patch2pix_tpu.evaluation.localize``. The reference defers
Aachen/InLoc localization to the external image-matching-toolbox; this
module implements the standard hierarchical-localization inner loop:

  1. match the query against retrieved database images (any
     ``matcher(q_path, db_path)`` callable, e.g. the port's ``Matcher``),
  2. lift each database-image match endpoint to a 3D point through the
     scene reconstruction (a COLMAP model) by nearest registered 2D
     observation within ``lift_radius`` pixels,
  3. solve the aggregated 2D-3D set with the PnP RANSAC of
     :mod:`patch2pix_tpu_torch.sfm.pnp`, on the card unless ``device`` is
     given.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from patch2pix_tpu_torch.config import resolve_device
from patch2pix_tpu_torch.sfm.pnp import ransac_pnp
from patch2pix_tpu_torch.sfm.twoview import normalize_points


@dataclass
class MapImage:
    """A database image with its registered 2D->3D observations."""

    path: str
    xys: np.ndarray  # (M, 2) registered 2D observations
    pts3d: np.ndarray  # (M, 3) corresponding 3D points


@dataclass
class LocalizationResult:
    R: Optional[np.ndarray]  # world->cam
    t: Optional[np.ndarray]
    num_inliers: int
    num_corrs: int

    @property
    def success(self) -> bool:
        return self.R is not None

    @property
    def camera_center(self) -> Optional[np.ndarray]:
        return None if self.R is None else -self.R.T @ self.t


def map_images_from_colmap(
    model_dir: str, image_dir: str, ext: str = ".bin"
) -> Dict[str, MapImage]:
    """Build MapImage records from a COLMAP sparse model."""
    import os

    from patch2pix_tpu_torch.data.colmap_model import read_model

    cams, images, points = read_model(model_dir, ext=ext)
    out = {}
    for im in images.values():
        sel = im.point3D_ids > 0
        pids = im.point3D_ids[sel]
        keep = np.asarray([p in points for p in pids])
        if keep.size == 0:
            continue
        xys = im.xys[sel][keep]
        p3d = np.stack([points[p].xyz for p in pids[keep]]) if keep.any() else np.zeros((0, 3))
        out[im.name] = MapImage(
            path=os.path.join(image_dir, im.name), xys=xys, pts3d=p3d
        )
    return out


def lift_matches(
    matches: np.ndarray, db: MapImage, lift_radius: float = 4.0
) -> Tuple[np.ndarray, np.ndarray]:
    """(query_xy, 3D point) pairs for matches whose database endpoint
    lies within ``lift_radius`` px of a registered observation."""
    if len(matches) == 0 or len(db.xys) == 0:
        return np.zeros((0, 2)), np.zeros((0, 3))
    d2 = (
        (matches[:, 2:3] - db.xys[None, :, 0]) ** 2
        + (matches[:, 3:4] - db.xys[None, :, 1]) ** 2
    )  # (N, M)
    nn = np.argmin(d2, axis=1)
    ok = d2[np.arange(len(matches)), nn] <= lift_radius**2
    return matches[ok, 0:2], db.pts3d[nn[ok]]


def localize_query(
    matcher: Callable[[str, str], Tuple[np.ndarray, np.ndarray, np.ndarray]],
    query_path: str,
    K_query: np.ndarray,
    retrieved: Sequence[MapImage],
    px_thres: float = 3.0,
    lift_radius: float = 4.0,
    min_corrs: int = 8,
    seed: int = 0,
    device=None,
) -> LocalizationResult:
    """Localize one query against retrieved database images; the PnP
    RANSAC's samples are drawn by a generator seeded with ``seed`` on
    ``device`` (the card unless given)."""
    device = resolve_device(device)
    q2d, p3d = [], []
    for db in retrieved:
        try:
            matches, scores, _ = matcher(query_path, db.path)
        except Exception:
            continue
        q, X = lift_matches(matches, db, lift_radius)
        q2d.append(q)
        p3d.append(X)
    if not q2d:
        return LocalizationResult(None, None, 0, 0)
    q2d = np.concatenate(q2d)
    p3d = np.concatenate(p3d)
    n = len(q2d)
    if n < min_corrs:
        return LocalizationResult(None, None, 0, n)

    pn = normalize_points(
        torch.as_tensor(q2d, dtype=torch.float32, device=device),
        torch.as_tensor(K_query, dtype=torch.float32, device=device),
    )
    f = (K_query[0, 0] + K_query[1, 1]) / 2.0
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    res = ransac_pnp(
        gen,
        torch.as_tensor(p3d, dtype=torch.float32, device=device),
        pn,
        512,
        float((px_thres / f) ** 2),
    )
    n_inl = int(res.num_inliers)
    if n_inl < min_corrs:
        return LocalizationResult(None, None, n_inl, n)
    return LocalizationResult(
        res.R.cpu().numpy().astype(np.float64), res.t.cpu().numpy().astype(np.float64),
        n_inl, n
    )
