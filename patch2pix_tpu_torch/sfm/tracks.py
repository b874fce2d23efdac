"""Feature-track building from dense pairwise matches (host side).

Patch2Pix is detector-free — matches are arbitrary sub-pixel
correspondences, not keypoint indices — so multi-view tracks are
formed by quantizing match endpoints to a per-image grid and
union-finding (image, cell) nodes connected by matches. This is the
standard detector-free SfM bridge. Copy of ``patch2pix_tpu.sfm.tracks``
(host Python and numpy), with the C++ builder of
:mod:`patch2pix_tpu_torch.native` as the default path.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np


class UnionFind:
    """Union-find with image-conflict-aware merging.

    Each root tracks {image_id: node} for its component; a union that
    would put one image into a component at TWO different cells is
    REJECTED (the edge is treated as an outlier). Without this, a few
    spurious matches percolate the whole scene into one giant
    inconsistent component (observed at 50 cams / 640k matches with 5%
    outliers: max consistent track length 5)."""

    def __init__(self):
        self.parent: Dict = {}
        self.images: Dict = {}  # root -> {image_id: node}

    def find(self, x):
        p = self.parent.get(x)
        if p is None:
            self.parent[x] = x
            self.images[x] = {x[0]: x}
            return x
        if p != x:
            self.parent[x] = p = self.find(p)
        return p

    def union(self, a, b) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return True
        ia, ib = self.images[ra], self.images[rb]
        if len(ib) > len(ia):  # small-to-large
            ra, rb, ia, ib = rb, ra, ib, ia
        for im, node in ib.items():
            if ia.get(im, node) != node:
                return False  # image conflict: reject the edge
        ia.update(ib)
        self.parent[rb] = ra
        del self.images[rb]
        return True


def build_tracks(
    pair_matches: Dict[Tuple[int, int], np.ndarray],
    cell: float = 4.0,
    min_track_len: int = 2,
    use_native: bool = True,
) -> List[Dict[int, np.ndarray]]:
    """Merge dense pairwise matches into multi-view tracks.

    Args:
      pair_matches: {(i, j): (N, 4) pixel matches x1 y1 x2 y2}
        with i < j image indices.
      cell: quantization cell size in pixels — endpoints of different
        pairs within the same cell are treated as the same feature.
      min_track_len: drop tracks observed in fewer images.

    Returns:
      list of tracks; each track is {image_id: (2,) mean pixel coords}.
      Conflict policy is observation-level: when a component observes
      an image in two different cells (an outlier edge merged two real
      tracks, or a point straddles a cell boundary), only THAT image's
      observations are dropped; the track survives if min_track_len
      consistent images remain. (Dropping whole conflicted tracks
      collapsed scene-scale reconstruction: with a few percent outlier
      matches, essentially every large component carries a conflict.)

    The C++ union-find (``native/tracks.cpp``) is the default path and
    raises where it cannot be built or loaded; the Python union-find
    below, the reference, runs only with ``use_native=False``.
    """
    if use_native:
        from patch2pix_tpu_torch.native import build_tracks_native

        return build_tracks_native(pair_matches, cell, min_track_len)

    uf = UnionFind()
    obs: Dict[Tuple[int, int, int], List[np.ndarray]] = defaultdict(list)

    def node(im, x, y):
        return (im, int(np.floor(x / cell)), int(np.floor(y / cell)))

    for (i, j), m in pair_matches.items():
        for x1, y1, x2, y2 in np.asarray(m, np.float64):
            n1 = node(i, x1, y1)
            n2 = node(j, x2, y2)
            if uf.union(n1, n2):  # rejected outlier edges contribute
                obs[n1].append(np.array([x1, y1]))  # no coordinates
                obs[n2].append(np.array([x2, y2]))

    groups: Dict = defaultdict(list)
    for n in obs:
        groups[uf.find(n)].append(n)

    tracks = []
    for nodes in groups.values():
        ims = [n[0] for n in nodes]
        counts = defaultdict(int)
        for im in ims:
            counts[im] += 1
        keep = [n for n in nodes if counts[n[0]] == 1]
        if len(keep) < min_track_len:
            continue
        tracks.append(
            {n[0]: np.mean(obs[n], axis=0) for n in keep}
        )
    return tracks
