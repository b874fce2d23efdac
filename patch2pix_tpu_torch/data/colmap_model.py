"""COLMAP sparse-model I/O: cameras / images / points3D, binary + text.

Capability parity with the reference's vendored reader
(the reference's utils/colmap/read_write_model.py:40-459), written
fresh against the public COLMAP on-disk format. Both READ and WRITE
are implemented because the TPU framework's own SfM backend exports
reconstructions in this format for ATE comparison (SURVEY.md §2.5).

Implementation note: per-image 2D-point tables are parsed with
vectorised ``np.frombuffer`` record views rather than per-point
``struct.unpack`` loops — large MegaDepth models load in seconds.

A copy of ``patch2pix_tpu.data.colmap_model``, kept in the port so that it
imports nothing of the JAX package.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

# COLMAP camera models: id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}
CAMERA_MODEL_PARAMS = {name: n for _, (name, n) in CAMERA_MODELS.items()}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    @property
    def K(self) -> np.ndarray:
        """3x3 intrinsics (pinhole part only; distortion ignored)."""
        p = self.params
        if self.model == "PINHOLE":
            fx, fy, cx, cy = p[:4]
        elif self.model in (
            "SIMPLE_PINHOLE",
            "SIMPLE_RADIAL",
            "RADIAL",
            "SIMPLE_RADIAL_FISHEYE",
            "RADIAL_FISHEYE",
            "FOV",
        ):
            fx = fy = p[0]
            cx, cy = p[1], p[2]
        else:  # OPENCV family: fx fy cx cy ...
            fx, fy, cx, cy = p[:4]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float64)


@dataclass
class ImagePose:
    id: int
    qvec: np.ndarray  # (4,) w x y z — world->cam rotation
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray  # (N, 2)
    point3D_ids: np.ndarray  # (N,) int64, -1 = no 3D point

    @property
    def R(self) -> np.ndarray:
        return qvec2rotmat(self.qvec)

    @property
    def c(self) -> np.ndarray:
        """Camera centre in world coordinates."""
        return -self.R.T @ self.tvec


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z), largest-pivot form."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = [(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s,
             (R[0, 2] + R[2, 0]) / s]
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s,
             (R[1, 2] + R[2, 1]) / s]
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
             (R[1, 2] + R[2, 1]) / s, 0.25 * s]
    q = np.asarray(q)
    return q if q[0] >= 0 else -q


# ---------------------------------------------------------------- binary


def _read_cstring(buf: bytes, pos: int) -> Tuple[str, int]:
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("utf-8"), end + 1


def read_cameras_binary(path: str) -> Dict[int, Camera]:
    with open(path, "rb") as f:
        buf = f.read()
    (num,) = struct.unpack_from("<Q", buf, 0)
    pos = 8
    cams = {}
    for _ in range(num):
        cid, model_id, w, h = struct.unpack_from("<iiQQ", buf, pos)
        pos += 24
        name, nparams = CAMERA_MODELS[model_id]
        params = np.frombuffer(buf, "<f8", count=nparams, offset=pos).copy()
        pos += 8 * nparams
        cams[cid] = Camera(cid, name, int(w), int(h), params)
    return cams


def read_images_binary(path: str) -> Dict[int, ImagePose]:
    with open(path, "rb") as f:
        buf = f.read()
    (num,) = struct.unpack_from("<Q", buf, 0)
    pos = 8
    images = {}
    pt_rec = np.dtype([("x", "<f8"), ("y", "<f8"), ("pid", "<i8")])
    for _ in range(num):
        iid = struct.unpack_from("<i", buf, pos)[0]
        qvec = np.frombuffer(buf, "<f8", count=4, offset=pos + 4).copy()
        tvec = np.frombuffer(buf, "<f8", count=3, offset=pos + 36).copy()
        (cam_id,) = struct.unpack_from("<i", buf, pos + 60)
        name, pos = _read_cstring(buf, pos + 64)
        (npts,) = struct.unpack_from("<Q", buf, pos)
        pos += 8
        rec = np.frombuffer(buf, pt_rec, count=npts, offset=pos)
        pos += pt_rec.itemsize * npts
        images[iid] = ImagePose(
            id=iid,
            qvec=qvec,
            tvec=tvec,
            camera_id=cam_id,
            name=name,
            xys=np.stack([rec["x"], rec["y"]], axis=1) if npts else np.zeros((0, 2)),
            point3D_ids=rec["pid"].copy() if npts else np.zeros((0,), np.int64),
        )
    return images


def read_points3d_binary(path: str) -> Dict[int, Point3D]:
    with open(path, "rb") as f:
        buf = f.read()
    (num,) = struct.unpack_from("<Q", buf, 0)
    pos = 8
    pts = {}
    trk_rec = np.dtype([("iid", "<i4"), ("p2d", "<i4")])
    for _ in range(num):
        (pid,) = struct.unpack_from("<q", buf, pos)
        xyz = np.frombuffer(buf, "<f8", count=3, offset=pos + 8).copy()
        rgb = np.frombuffer(buf, "<u1", count=3, offset=pos + 32).copy()
        (err,) = struct.unpack_from("<d", buf, pos + 35)
        (tlen,) = struct.unpack_from("<Q", buf, pos + 43)
        pos += 51
        trk = np.frombuffer(buf, trk_rec, count=tlen, offset=pos)
        pos += trk_rec.itemsize * tlen
        pts[pid] = Point3D(
            pid, xyz, rgb, float(err), trk["iid"].copy(), trk["p2d"].copy()
        )
    return pts


def write_cameras_binary(cams: Dict[int, Camera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(np.asarray(cam.params, "<f8").tobytes())


def write_images_binary(images: Dict[int, ImagePose], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(np.asarray(im.qvec, "<f8").tobytes())
            f.write(np.asarray(im.tvec, "<f8").tobytes())
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n = len(im.point3D_ids)
            f.write(struct.pack("<Q", n))
            rec = np.zeros(n, np.dtype([("x", "<f8"), ("y", "<f8"), ("pid", "<i8")]))
            if n:
                rec["x"], rec["y"] = im.xys[:, 0], im.xys[:, 1]
                rec["pid"] = im.point3D_ids
            f.write(rec.tobytes())


def write_points3d_binary(pts: Dict[int, Point3D], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for p in pts.values():
            f.write(struct.pack("<q", p.id))
            f.write(np.asarray(p.xyz, "<f8").tobytes())
            f.write(np.asarray(p.rgb, "<u1").tobytes())
            f.write(struct.pack("<d", p.error))
            f.write(struct.pack("<Q", len(p.image_ids)))
            trk = np.zeros(
                len(p.image_ids), np.dtype([("iid", "<i4"), ("p2d", "<i4")])
            )
            trk["iid"], trk["p2d"] = p.image_ids, p.point2D_idxs
            f.write(trk.tobytes())


# ---------------------------------------------------------------- text


def read_cameras_text(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cid, model, w, h = int(parts[0]), parts[1], int(parts[2]), int(parts[3])
            cams[cid] = Camera(cid, model, w, h, np.asarray(parts[4:], np.float64))
    return cams


def read_images_text(path: str) -> Dict[int, ImagePose]:
    images = {}
    with open(path) as f:
        lines = iter([l.strip() for l in f if not l.startswith("#")])
    # each image is two lines; the second, its points, is empty for an image
    # without observations (the JAX package's reader drops that line and
    # pairs the next image's line with it)
    for meta in lines:
        if not meta:
            continue
        pts = next(lines, "")
        parts = meta.split()
        iid = int(parts[0])
        qvec = np.asarray(parts[1:5], np.float64)
        tvec = np.asarray(parts[5:8], np.float64)
        cam_id = int(parts[8])
        name = parts[9]
        vals = np.asarray(pts.split(), np.float64).reshape(-1, 3) if pts else np.zeros((0, 3))
        images[iid] = ImagePose(
            iid, qvec, tvec, cam_id, name,
            vals[:, :2].copy(), vals[:, 2].astype(np.int64),
        )
    return images


def read_points3d_text(path: str) -> Dict[int, Point3D]:
    pts = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            pid = int(parts[0])
            xyz = np.asarray(parts[1:4], np.float64)
            rgb = np.asarray(parts[4:7], np.uint8)
            err = float(parts[7])
            trk = np.asarray(parts[8:], np.int64).reshape(-1, 2)
            pts[pid] = Point3D(
                pid, xyz, rgb, err, trk[:, 0].astype(np.int32),
                trk[:, 1].astype(np.int32),
            )
    return pts


def write_cameras_text(cams: Dict[int, Camera], path: str) -> None:
    with open(path, "w") as f:
        f.write("# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n")
        for cam in cams.values():
            ps = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {ps}\n")


def write_images_text(images: Dict[int, ImagePose], path: str) -> None:
    with open(path, "w") as f:
        f.write("# Image list: IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME\n")
        for im in images.values():
            q = " ".join(repr(float(v)) for v in im.qvec)
            t = " ".join(repr(float(v)) for v in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            row = " ".join(
                f"{x} {y} {pid}"
                for (x, y), pid in zip(im.xys, im.point3D_ids)
            )
            f.write(row + "\n")


def write_points3d_text(pts: Dict[int, Point3D], path: str) -> None:
    with open(path, "w") as f:
        f.write("# 3D point list: POINT3D_ID X Y Z R G B ERROR TRACK[]\n")
        for p in pts.values():
            xyz = " ".join(repr(float(v)) for v in p.xyz)
            rgb = " ".join(str(int(v)) for v in p.rgb)
            trk = " ".join(
                f"{int(i)} {int(j)}" for i, j in zip(p.image_ids, p.point2D_idxs)
            )
            f.write(f"{p.id} {xyz} {rgb} {p.error} {trk}\n")


# ---------------------------------------------------------------- facade


def read_model(model_dir: str, ext: str = ".bin"):
    """Read (cameras, images, points3D) from a COLMAP model directory."""
    if ext == ".bin":
        return (
            read_cameras_binary(os.path.join(model_dir, "cameras.bin")),
            read_images_binary(os.path.join(model_dir, "images.bin")),
            read_points3d_binary(os.path.join(model_dir, "points3D.bin")),
        )
    return (
        read_cameras_text(os.path.join(model_dir, "cameras.txt")),
        read_images_text(os.path.join(model_dir, "images.txt")),
        read_points3d_text(os.path.join(model_dir, "points3D.txt")),
    )


def write_model(cameras, images, points3d, model_dir: str, ext: str = ".bin"):
    os.makedirs(model_dir, exist_ok=True)
    if ext == ".bin":
        write_cameras_binary(cameras, os.path.join(model_dir, "cameras.bin"))
        write_images_binary(images, os.path.join(model_dir, "images.bin"))
        write_points3d_binary(points3d, os.path.join(model_dir, "points3D.bin"))
    else:
        write_cameras_text(cameras, os.path.join(model_dir, "cameras.txt"))
        write_images_text(images, os.path.join(model_dir, "images.txt"))
        write_points3d_text(points3d, os.path.join(model_dir, "points3D.txt"))
