"""COLMAP sqlite database reader.

Capability parity with ``COLMAPDataLoader``
(the reference's utils/colmap/read_database.py:47-176): images,
cameras, keypoints (2/4/6-column layouts) and pairwise matches,
using COLMAP's public pair-id packing.

A copy of ``patch2pix_tpu.data.colmap_db``, kept in the port so that it
imports nothing of the JAX package.
"""

from __future__ import annotations

import sqlite3
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

MAX_IMAGE_ID = 2147483647  # COLMAP's pair-id packing base


def image_ids_to_pair_id(id1: int, id2: int) -> int:
    if id1 > id2:
        id1, id2 = id2, id1
    return id1 * MAX_IMAGE_ID + id2


def pair_id_to_image_ids(pair_id: int) -> Tuple[int, int]:
    id2 = pair_id % MAX_IMAGE_ID
    id1 = pair_id // MAX_IMAGE_ID
    return id1, id2


class ColmapDatabase:
    """Read-only access to a COLMAP database file."""

    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)

    def close(self):
        self.conn.close()

    def load_images(self, name_based: bool = False) -> Dict:
        """image_id -> (name, camera_id), or name -> (image_id, camera_id)."""
        rows = self.conn.execute(
            "SELECT image_id, name, camera_id FROM images"
        ).fetchall()
        if name_based:
            return {name: (iid, cid) for iid, name, cid in rows}
        return {iid: (name, cid) for iid, name, cid in rows}

    def load_cameras(self) -> Dict[int, Dict]:
        rows = self.conn.execute(
            "SELECT camera_id, model, width, height, params FROM cameras"
        ).fetchall()
        return {
            cid: {
                "model": model,
                "width": w,
                "height": h,
                "params": np.frombuffer(params, np.float64).copy(),
            }
            for cid, model, w, h, params in rows
        }

    def load_keypoints(self, key_len: Optional[int] = None) -> Dict[int, np.ndarray]:
        """image_id -> (N, cols) float32 keypoints.

        COLMAP stores 2 (x, y), 4 (+scale, orientation) or 6 (affine)
        column layouts; ``key_len`` filters to a specific layout.
        """
        out = {}
        for iid, rows, cols, blob in self.conn.execute(
            "SELECT image_id, rows, cols, data FROM keypoints"
        ):
            if rows == 0 or blob is None:
                continue
            if key_len is not None and cols != key_len:
                continue
            out[iid] = np.frombuffer(blob, np.float32).reshape(rows, cols).copy()
        return out

    def load_matches(self) -> Dict[Tuple[int, int], np.ndarray]:
        """(id1, id2) -> (N, 2) uint32 keypoint index pairs."""
        out = {}
        for pair_id, rows, cols, blob in self.conn.execute(
            "SELECT pair_id, rows, cols, data FROM matches"
        ):
            if rows == 0 or blob is None:
                continue
            ids = pair_id_to_image_ids(pair_id)
            out[ids] = np.frombuffer(blob, np.uint32).reshape(rows, cols).copy()
        return out

    def load_pair_matches(
        self, pair_ids: Iterable[Tuple[int, int]]
    ) -> Dict[Tuple[int, int], np.ndarray]:
        out = {}
        for id1, id2 in pair_ids:
            pid = image_ids_to_pair_id(id1, id2)
            row = self.conn.execute(
                "SELECT rows, cols, data FROM matches WHERE pair_id = ?", (pid,)
            ).fetchone()
            if row is None or row[0] == 0 or row[2] is None:
                continue
            rows, cols, blob = row
            m = np.frombuffer(blob, np.uint32).reshape(rows, cols).copy()
            if id1 > id2:  # stored with ids swapped -> swap columns back
                m = m[:, ::-1]
            out[(id1, id2)] = m
        return out
