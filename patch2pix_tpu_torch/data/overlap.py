"""Scene image loading + co-visibility overlap computation.

Capability parity with the reference's utils/colmap/data_loading.py:
``load_model_ims`` :72, ``cal_overlap_scores`` :54,
``sav_model_multi_ov_pairs`` :7 and ``parse_data`` :100 — with the
O(N^2) per-pair ``np.intersect1d`` loop replaced by one sparse
incidence-matrix product (images x points3D), which is orders of
magnitude faster on large scenes.

A copy of ``patch2pix_tpu.data.overlap``, kept in the port so that it
imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from patch2pix_tpu_torch.data.colmap_model import (
    Camera,
    ImagePose,
    qvec2rotmat,
    read_cameras_binary,
    read_images_binary,
)


@dataclass
class SceneImage:
    """Per-image pose/intrinsics record (the reference's ``parse_data``
    Namespace: name, K, c, q, R, id)."""

    name: str
    K: np.ndarray
    c: np.ndarray
    q: np.ndarray
    R: np.ndarray
    id: int


def parse_image(im: ImagePose, cam: Camera) -> SceneImage:
    R = qvec2rotmat(im.qvec)
    return SceneImage(
        name=im.name,
        K=cam.K,
        c=-R.T @ im.tvec,
        q=im.qvec,
        R=R,
        id=im.id,
    )


def load_model_ims(model_dir: str) -> Dict[str, SceneImage]:
    cameras = read_cameras_binary(os.path.join(model_dir, "cameras.bin"))
    images = read_images_binary(os.path.join(model_dir, "images.bin"))
    out = {}
    for im in images.values():
        if im.camera_id in cameras:
            out[im.name] = parse_image(im, cameras[im.camera_id])
    return out


def cal_overlap_scores(
    im_ids: Sequence[int], images: Dict[int, ImagePose]
) -> Tuple[np.ndarray, np.ndarray]:
    """Upper-triangular overlap matrix + per-image 3D-point counts.

    overlap(i, j) = |P_i ∩ P_j| / max(|P_i|, |P_j|) over each image's
    observed 3D points — computed as a single sparse boolean
    incidence-product instead of the reference's nested Python loops.
    """
    # reference counts *positions* of observed points (point3D_ids > 0
    # per its convention; unobserved entries are -1), one per 2D feature
    obs: List[np.ndarray] = [
        np.unique(images[i].point3D_ids[images[i].point3D_ids > 0])
        for i in im_ids
    ]
    nums_3d = np.array([len(o) for o in obs])
    n = len(im_ids)

    all_pids = np.unique(np.concatenate([o for o in obs if len(o)] or [np.zeros(0, np.int64)]))
    pid_index = {p: k for k, p in enumerate(all_pids)}
    try:
        from scipy import sparse

        rows, cols = [], []
        for i, o in enumerate(obs):
            rows.append(np.full(len(o), i, np.int64))
            cols.append(np.asarray([pid_index[p] for p in o], np.int64))
        A = sparse.csr_matrix(
            (
                np.ones(sum(len(o) for o in obs), np.float32),
                (np.concatenate(rows) if rows else np.zeros(0, np.int64),
                 np.concatenate(cols) if cols else np.zeros(0, np.int64)),
            ),
            shape=(n, max(len(all_pids), 1)),
        )
        inter = (A @ A.T).toarray()
    except ImportError:  # scipy unavailable: dense fallback
        A = np.zeros((n, max(len(all_pids), 1)), np.float32)
        for i, o in enumerate(obs):
            A[i, [pid_index[p] for p in o]] = 1.0
        inter = A @ A.T

    denom = np.maximum(nums_3d[:, None], nums_3d[None, :])
    denom = np.maximum(denom, 1)
    scores = inter / denom
    # reference returns identity diagonal and zeros below it
    return np.triu(scores, 1) + np.eye(n), nums_3d


def model_multi_ov_pairs(
    model_dir: str, overlaps: Iterable[float], cache: bool = True
) -> Dict[float, List[Tuple[str, str]]]:
    """Per-threshold overlap pair lists, cached to ``ov_pairs.npy``.

    Same output contract as ``sav_model_multi_ov_pairs``
    (the reference's utils/colmap/data_loading.py:7-38): pairs are
    (max(name1, name2), min(name1, name2)) tuples.
    """
    sav = os.path.join(model_dir, "ov_pairs.npy")
    if cache and os.path.exists(sav):
        d = np.load(sav, allow_pickle=True).item()
        if all(k in d for k in overlaps):
            return d

    images = read_images_binary(os.path.join(model_dir, "images.bin"))
    im_ids = list(images.keys())
    scores, _ = cal_overlap_scores(im_ids, images)
    out: Dict[float, List[Tuple[str, str]]] = {}
    for min_ov in overlaps:
        sel = np.logical_and(scores >= min_ov, scores < 1)
        ids = np.vstack(np.where(sel)).T
        pairs = []
        for i, j in ids:
            n1, n2 = images[im_ids[i]].name, images[im_ids[j]].name
            pairs.append((max(n1, n2), min(n1, n2)))
        out[min_ov] = pairs
    if cache:
        np.save(sav, out)  # noqa: allow dict save (reference format)
    return out


def load_colmap_matches(
    db_path: str, pair_names: Sequence[Tuple[str, str]]
) -> Dict[Tuple[str, str], np.ndarray]:
    """Pixel-coordinate matches for named image pairs from a COLMAP db.

    Parity with the reference's utils/colmap/data_loading.py:109-134:
    keypoint indices are resolved to (x1, y1, x2, y2) rows; pairs with
    no stored matches map to None.
    """
    from patch2pix_tpu_torch.data.colmap_db import ColmapDatabase

    db = ColmapDatabase(db_path)
    try:
        keypoints = db.load_keypoints(key_len=6)
        images = db.load_images(name_based=True)
        pair_ids = [
            (images[a][0], images[b][0]) for a, b in pair_names
        ]
        stored = db.load_pair_matches(pair_ids)
        out = {}
        for name, pid in zip(pair_names, pair_ids):
            m = stored.get(tuple(pid))
            if m is None:
                out[tuple(name)] = None
                continue
            k1 = keypoints[pid[0]][m[:, 0], 0:2]
            k2 = keypoints[pid[1]][m[:, 1], 0:2]
            out[tuple(name)] = np.concatenate([k1, k2], axis=1)
        return out
    finally:
        db.close()


def export_intrinsics_txt(model_dir: str, sav_path: str) -> None:
    """Write per-image camera lines: name model w h params...
    (parity with the reference's utils/colmap/data_loading.py:136-159)."""
    cameras = read_cameras_binary(os.path.join(model_dir, "cameras.bin"))
    images = read_images_binary(os.path.join(model_dir, "images.bin"))
    with open(sav_path, "w") as f:
        for im in images.values():
            cam = cameras.get(im.camera_id)
            if cam is None:
                continue
            ps = " ".join(str(float(p)) for p in cam.params)
            f.write(f"{im.name} {cam.model} {cam.width} {cam.height} {ps}\n")


def parse_camera_matrices(intrinsic_txt: str) -> Dict[str, np.ndarray]:
    """name -> 3x3 K from an intrinsics txt written by
    :func:`export_intrinsics_txt`."""
    from patch2pix_tpu_torch.data.colmap_model import Camera

    out = {}
    with open(intrinsic_txt) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 5:
                continue
            name, model, w, h = parts[0], parts[1], int(parts[2]), int(parts[3])
            params = np.asarray(parts[4:], np.float64)
            out[name] = Camera(0, model, w, h, params).K
    return out
