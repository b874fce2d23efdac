"""VisualSFM NVM reconstruction parsing + Cambridge Landmarks helpers.

Capability parity with the reference's utils/datasets/data_parsing.py
(caller-less in the reference — kept for API completeness): NVM
point/visibility parsing, absolute-pose label files, Cambridge-scene
intrinsics from NVM focal lengths, and overlap-scored positive-pair
generation. Host-side numpy throughout (offline data prep, not a
device path).

NVM format (http://ccwu.me/vsfm/doc.html#nvm):
    NVM_V3 <optional calibration>
    <blank>
    <#cameras>
    <file> <focal> <qw qx qy qz> <cx cy cz> <radial distortion> 0
    ... one line per camera ...
    <blank>
    <#points>
    <xyz> <rgb> <#measurements> [<img idx> <feat idx> <x y>] ...

A copy of ``patch2pix_tpu.data.nvm``, kept in the port so that it
imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np


def parse_3d_points_from_nvm(nvm_file: str):
    """Point coordinates + per-camera visible-point index lists.

    Returns:
      (points, cam_points): ``points`` is a list of ``[x, y, z]`` string
      triples (reference-compatible); ``cam_points`` maps each camera
      filename to the list of 3D-point indices it observes.
    """
    with open(nvm_file, "r") as f:
        lines = f.read().splitlines()
    it = iter(lines)
    next(it)  # header
    next(it)  # blank
    n_cams = int(next(it).split()[0])
    cams = [next(it).split()[0] for _ in range(n_cams)]
    cam_points: Dict[str, List[int]] = {c: [] for c in cams}
    next(it)  # blank separator
    n_points = int(next(it).split()[0])
    points = []
    for pi in range(n_points):
        tok = next(it).split()
        points.append(tok[0:3])
        n_meas = int(tok[6])
        for mi in range(n_meas):
            cam_idx = int(tok[7 + 4 * mi])
            cam_points[cams[cam_idx]].append(pi)
    return points, cam_points


def parse_abs_pose_txt(fpath: str) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """``image x y z qw qx qy qz`` records (3 header lines) ->
    {image: (centre, quaternion)}."""
    poses: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    with open(fpath) as f:
        for line in f.read().splitlines()[3:]:
            tok = line.split(" ")
            if len(tok) < 8:
                continue
            c = np.asarray([float(v) for v in tok[1:4]], np.float32)
            q = np.asarray([float(v) for v in tok[4:8]], np.float32)
            poses[tok[0]] = (c, q)
    return poses


def parse_nvm_focals(nvm_file: str, to_png: bool = True) -> Dict[str, float]:
    """Per-image focal length from an NVM camera block."""
    with open(nvm_file, "r") as f:
        lines = f.read().splitlines()
    n_cams = int(lines[2].split()[0])
    focals = {}
    for line in lines[3 : 3 + n_cams]:
        tok = line.split()
        name = tok[0].replace("jpg", "png") if to_png else tok[0]
        focals[name] = float(tok[1])
    return focals


class CambridgeIntrinsics:
    """Cambridge Landmarks per-image K matrices (focal from the scene's
    ``reconstruction.nvm``, principal point at the image centre,
    rescaled to the working resolution)."""

    scenes = ("KingsCollege", "OldHospital", "ShopFacade", "StMarysChurch")

    def __init__(self, base_dir, scene, wt=1920, ht=1080, w=1920, h=1080):
        assert scene in self.scenes, f"unknown Cambridge scene {scene}"
        self.base_dir, self.scene = base_dir, scene
        self.wt, self.ht, self.w, self.h = wt, ht, w, h
        scale = np.diag([wt / w, ht / h, 1.0])
        self.focals = parse_nvm_focals(
            os.path.join(base_dir, scene, "reconstruction.nvm")
        )
        self.im_list = list(self.focals)
        self.intrinsic_matrices = {
            im: (
                scale
                @ np.asarray(
                    [[f, 0.0, w / 2], [0.0, f, h / 2], [0.0, 0.0, 1.0]],
                    np.float32,
                )
            )
            for im, f in self.focals.items()
        }

    def get_intrinsic_matrices(self):
        return self.intrinsic_matrices

    def get_im_intrinsics(self, im):
        return self.intrinsic_matrices[im]


@dataclass
class PosPair:
    """One positive training pair with overlap + relative pose."""

    im1: str
    im2: str
    overlap: float
    K1: np.ndarray
    K2: np.ndarray
    t: np.ndarray
    q: np.ndarray
    R: np.ndarray = field(default=None)


def get_positive_pairs(
    cam_points: Dict[str, Sequence[int]],
    imlist,
    thres_min: float = 0.15,
    thres_max: float = 0.8,
) -> List[PosPair]:
    """Overlap-scored positive pairs from NVM co-visibility.

    ``imlist`` entries carry ``name`` (png), ``K``, ``c``, ``q`` (the
    SceneImage/Namespace convention). Overlap = min of the two
    directional shared-point fractions; pairs inside
    (thres_min, thres_max) get their relative pose attached.
    """
    from patch2pix_tpu_torch.data.colmap_model import qvec2rotmat
    from patch2pix_tpu_torch.evaluation.geometry import abs2relapose

    visible = {
        name: frozenset(ids) for name, ids in cam_points.items()
    }
    pairs: List[PosPair] = []
    for i, im1 in enumerate(imlist):
        p1 = visible.get(im1.name.replace("png", "jpg"), frozenset())
        if not p1:
            continue
        for im2 in imlist[i + 1 :]:
            p2 = visible.get(im2.name.replace("png", "jpg"), frozenset())
            if not p2:
                continue
            shared = len(p1 & p2)
            score = min(shared / len(p1), shared / len(p2))
            if score < thres_min or score > thres_max:
                continue
            t, q = abs2relapose(im1.c, im2.c, im1.q, im2.q)
            pairs.append(
                PosPair(
                    im1=im1.name, im2=im2.name, overlap=score,
                    K1=im1.K, K2=im2.K, t=t, q=q, R=qvec2rotmat(q),
                )
            )
    return pairs
