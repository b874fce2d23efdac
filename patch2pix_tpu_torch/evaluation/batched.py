"""Batched matching of many pairs, the pairs sharded over a mesh.

Port of ``patch2pix_tpu.evaluation.batched``. Image pairs are bucketed
by processed shape and stacked into chunks of ``per_chip_batch`` rows
for each rank of the mesh; rank r runs its rows of each chunk through
``Patch2Pix.predict_fine``. Pairs are independent, so the device work
moves no collective; on a mesh of more than one rank, one
``all_gather_object`` of the per-pair results at the end gives every
rank the full list.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from patch2pix_tpu_torch.data.preprocess import load_im_flexible
from patch2pix_tpu_torch.parallel import comm_stats
from patch2pix_tpu_torch.parallel.mesh import Mesh, make_mesh


class BatchedMatcher:
    """Match many image pairs, pairs sharded over the ranks of ``mesh``
    (when None, this process alone on the CUDA card). Same per-pair contract as
    ``Matcher.estimate_matches``: (matches, scores, coarse) in original
    pixel coordinates. The model holds its weights.

    ``per_chip_batch``: rows per rank in one ``predict_fine`` call; by
    default 4 for change_stride models and 1 for upsample 16, the JAX
    package's rule."""

    def __init__(
        self,
        model,
        mesh: Optional[Mesh] = None,
        ksize: int = 2,
        io_thres: float = 0.25,
        ncn_thres: float = 0.0,
        mutual: bool = True,
        imsize: Optional[int] = None,
        fine_cap: Optional[int] = 1200,
        per_chip_batch: Optional[int] = None,
    ):
        self.mesh = mesh if mesh is not None else make_mesh(1)
        self.model = model.to(self.mesh.device).eval()
        self.n_dev = self.mesh.size
        self.ksize = ksize
        self.io_thres = io_thres
        self.ncn_thres = ncn_thres
        self.mutual = mutual
        self.imsize = imsize
        self.fine_cap = fine_cap  # see evaluation.matcher.Matcher
        if per_chip_batch is None:
            per_chip_batch = 4 if model.config.change_stride else 1
        self.per_chip_batch = max(int(per_chip_batch), 1)
        self.upsample = model.config.upsample

    def _predict(self, im1: np.ndarray, im2: np.ndarray):
        dev = self.mesh.device
        b1 = torch.from_numpy(im1).to(dev)
        b2 = torch.from_numpy(im2).to(dev)
        fine, _, coarse = self.model.predict_fine(
            b1, b2, ksize=self.ksize, ncn_thres=self.ncn_thres, mutual=self.mutual,
            fine_cap=self.fine_cap)
        return (fine.coords.cpu().numpy(), fine.scores.cpu().numpy(),
                fine.valid.cpu().numpy(), coarse.coords.cpu().numpy())

    def match_pairs(
        self, pairs: Sequence[Tuple[str, str]]
    ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Match a list of (im1_path, im2_path) on every rank of the mesh
        (each with the same list); returns per-pair (matches, scores,
        coarse) in original pixel coordinates, the whole list on every
        rank."""
        loaded = []
        buckets: Dict[Tuple, List[int]] = defaultdict(list)
        for idx, (pa, pb) in enumerate(pairs):
            im1, sc1 = load_im_flexible(pa, self.ksize, self.upsample, self.imsize)
            im2, sc2 = load_im_flexible(pb, self.ksize, self.upsample, self.imsize)
            loaded.append((im1, im2, np.asarray([*sc1, *sc2])))
            buckets[(im1.shape, im2.shape)].append(idx)

        mine: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        per = self.per_chip_batch
        chunk = per * self.n_dev
        lo_row = self.mesh.rank * per
        for ids in buckets.values():
            # every chunk is padded with its last id to chunk rows, so
            # each rank runs per_chip_batch rows of it
            for lo in range(0, len(ids), chunk):
                ids_c = ids[lo:lo + chunk]
                if lo_row >= len(ids_c):
                    continue  # this rank's rows are all padding
                ids_p = (ids_c + ids_c[-1:] * (chunk - len(ids_c)))[lo_row:lo_row + per]
                coords, scores, valid, coarse = self._predict(
                    np.stack([loaded[i][0] for i in ids_p]),
                    np.stack([loaded[i][1] for i in ids_p]))
                for row, i in enumerate(ids_p):
                    if lo_row + row >= len(ids_c):
                        break  # padding
                    v = valid[row]
                    m, s, c = coords[row][v], scores[row][v], coarse[row][v]
                    pos = s > self.io_thres
                    if pos.any():
                        m, s, c = m[pos], s[pos], c[pos]
                    up = loaded[i][2]
                    mine[i] = (m * up, s, c * up)
        results: List = [None] * len(pairs)
        parts = (comm_stats.all_gather_object(mine, self.mesh.group) if self.n_dev > 1
                 else [mine])
        for part in parts:
            for i, r in part.items():
                results[i] = r
        return results

    def __call__(self, im1_path: str, im2_path: str):
        return self.match_pairs([(im1_path, im2_path)])[0]
