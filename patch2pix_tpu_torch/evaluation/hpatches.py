"""HPatches homography-sequences MMA evaluation.

A copy of ``patch2pix_tpu.evaluation.hpatches`` (numpy only), kept in
the port so that it imports nothing of the JAX package. The reference
delegates HPatches evaluation to the external image-matching-toolbox
(its ``README.md:28-31``); this module implements the standard
protocol:

  * each sequence ``i_*`` / ``v_*`` has images 1..6 and ground-truth
    homographies ``H_1_k`` mapping image 1 onto image k,
  * match image 1 against 2..6, project matches with H, count the
    fraction within a pixel threshold (Mean Matching Accuracy),
  * report MMA@1..10 overall and split by illumination/viewpoint.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def project_homography(pts: np.ndarray, H: np.ndarray) -> np.ndarray:
    """Apply a 3x3 homography to (N, 2) points."""
    ph = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ H.T
    return ph[:, :2] / ph[:, 2:3]


def match_reprojection_errors(
    matches: np.ndarray, H: np.ndarray
) -> np.ndarray:
    """Per-match distance between H-projected p1 and predicted p2."""
    proj = project_homography(matches[:, 0:2], H)
    return np.linalg.norm(proj - matches[:, 2:4], axis=1)


@dataclass
class HpatchesResults:
    errors: Dict[str, List[np.ndarray]] = field(
        default_factory=lambda: {"i": [], "v": []}
    )
    num_matches: List[int] = field(default_factory=list)
    failed: List[Tuple[str, str]] = field(default_factory=list)

    def mma(
        self, thresholds: Sequence[float] = tuple(range(1, 11)), split: str = "all"
    ) -> np.ndarray:
        """Mean matching accuracy at each threshold.

        Per-pair accuracy first (empty pairs count 0), then averaged —
        the D2-Net/toolbox convention.
        """
        if split == "all":
            errs = self.errors["i"] + self.errors["v"]
        else:
            errs = self.errors[split]
        if not errs:
            return np.zeros(len(thresholds))
        out = []
        for t in thresholds:
            accs = [np.mean(e <= t) if e.size else 0.0 for e in errs]
            out.append(float(np.mean(accs)))
        return np.asarray(out)


def eval_hpatches(
    matcher: Callable[[str, str], Tuple[np.ndarray, np.ndarray, np.ndarray]],
    data_root: str,
    sequences: Optional[List[str]] = None,
    max_pairs_per_seq: int = 5,
    log: Callable[[str], None] = print,
    batch_matcher=None,
) -> HpatchesResults:
    """Run the HPatches protocol.

    ``matcher(p1, p2)`` is called per pair; alternatively pass
    ``batch_matcher``, any object with a ``match_pairs(list[(p1, p2)])``
    method returning one (matches, scores, coarse) a pair, such as
    ``evaluation.batched.BatchedMatcher``, which shards the pairs over a
    mesh.
    """
    sequences = sequences or sorted(
        s for s in os.listdir(data_root)
        if os.path.isdir(os.path.join(data_root, s))
    )
    # collect the evaluation pairs first
    jobs = []  # (split, ref, tgt, H)
    for seq in sequences:
        seq_dir = os.path.join(data_root, seq)
        split = "i" if seq.startswith("i_") else "v"
        ref = _find_image(seq_dir, 1)
        if ref is None:
            continue
        for k in range(2, 2 + max_pairs_per_seq):
            tgt = _find_image(seq_dir, k)
            hfile = os.path.join(seq_dir, f"H_1_{k}")
            if tgt is None or not os.path.exists(hfile):
                continue
            jobs.append((split, ref, tgt, np.loadtxt(hfile)))

    res = HpatchesResults()
    if batch_matcher is not None:
        outs = batch_matcher.match_pairs([(r, t) for _, r, t, _ in jobs])
    else:
        outs = []
        for _, ref, tgt, _ in jobs:
            try:
                outs.append(matcher(ref, tgt))
            except Exception:
                outs.append(None)
    for (split, ref, tgt, H), out in zip(jobs, outs):
        if out is None:
            res.failed.append((ref, tgt))
            continue
        matches = out[0]
        res.num_matches.append(len(matches))
        errs = (
            match_reprojection_errors(matches, H)
            if len(matches)
            else np.zeros(0)
        )
        res.errors[split].append(errs)

    mma = res.mma()
    log(
        f"HPatches seqs={len(sequences)} pairs="
        f"{len(res.errors['i']) + len(res.errors['v'])} "
        f"failed={len(res.failed)} "
        f"matches/pair={np.mean(res.num_matches) if res.num_matches else 0:.1f}"
    )
    log(
        f"MMA@1/3/5/10: {mma[0]:.3f}/{mma[2]:.3f}/{mma[4]:.3f}/{mma[9]:.3f} "
        f"(i: {res.mma(split='i')[2]:.3f}@3, v: {res.mma(split='v')[2]:.3f}@3)"
    )
    return res


def _find_image(seq_dir: str, idx: int) -> Optional[str]:
    for ext in (".ppm", ".png", ".jpg"):
        p = os.path.join(seq_dir, f"{idx}{ext}")
        if os.path.exists(p):
            return p
    return None
