"""PhotoTourism image-matching validation protocol.

Port of ``patch2pix_tpu.evaluation.immatch``, the reference's
``eval_immatch_val_sets`` (its ``utils/train/eval_epoch_immatch.py:12-98``): per scene,
sample <= ``sample_max`` pairs with overlap >= ``min_overlap``
(np.random.seed(0) for determinism), estimate matches, measure sampson
distances vs the GT fundamental matrix, run 5-pt RANSAC relative pose,
and report qt error (max of rotation/translation angular error),
pass rates qt<1..10 deg and inlier-distance histograms.

``matcher`` is any callable ``(path1, path2) -> (matches, scores,
coarse)``, e.g. the port's ``Matcher``; relative pose runs through the
5-point Nister RANSAC (``sfm/fivepoint.py``) on the card unless
``device`` is given, with the reference's cv2 path available via
``geo_backend='cv2'`` as a cross-check. A raise in the matcher is
recorded in ``match_failed``, one in the geometry in ``geo_failed``,
and the protocol goes on.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from patch2pix_tpu_torch.config import resolve_device
from patch2pix_tpu_torch.data.colmap_model import qvec2rotmat
from patch2pix_tpu_torch.data.overlap import load_model_ims
from patch2pix_tpu_torch.evaluation.geometry import abs2relapose, pose2fund
from patch2pix_tpu_torch.evaluation.measure import (
    eval_matches_relapose,
    inlier_distance_histogram,
    sampson_distance,
)


@dataclass
class ImmatchResults:
    qt: List[float] = field(default_factory=list)
    fdist: List[np.ndarray] = field(default_factory=list)
    cdist: List[np.ndarray] = field(default_factory=list)
    indist: List[np.ndarray] = field(default_factory=list)
    irat: List[float] = field(default_factory=list)
    num_matches: List[int] = field(default_factory=list)
    num_inls: List[int] = field(default_factory=list)
    match_failed: List[Tuple[str, str]] = field(default_factory=list)
    geo_failed: List[Tuple[str, str]] = field(default_factory=list)

    @property
    def qt_mean(self) -> float:
        return float(np.mean(self.qt)) if self.qt else float("inf")

    @property
    def qt_median(self) -> float:
        return float(np.median(self.qt)) if self.qt else float("inf")

    def pass_rates(self, thresholds=range(1, 11)) -> np.ndarray:
        qt = np.asarray(self.qt)
        if qt.size == 0:
            return np.zeros(len(list(thresholds)))
        return np.array([100.0 * np.mean(qt < t) for t in thresholds])

    @property
    def best_ckpt_score(self) -> float:
        """The reference's best-checkpoint mix
        (the reference's ``train_patch2pix.py:352``):
        0.34*P@1deg + 0.33*P@5deg + 0.33*P@10deg."""
        pr = self.pass_rates()
        return float(0.34 * pr[0] + 0.33 * pr[4] + 0.33 * pr[9])


def eval_immatch_val_sets(
    matcher: Callable[[str, str], Tuple[np.ndarray, np.ndarray, np.ndarray]],
    data_root: str = "data/immatch_benchmark/val_dense",
    rthres: float = 0.5,
    sample_max: int = 300,
    min_overlap: float = 0.3,
    scenes: Optional[List[str]] = None,
    log: Callable[[str], None] = print,
    geo_backend: str = "device",
    device=None,
) -> Tuple[float, np.ndarray, ImmatchResults]:
    """Run the validation protocol; returns (qt_mean, pass_rates, full).
    ``device``: the device geometry's (the card unless given), resolved
    before any pair, so that a missing card raises here and is not
    recorded as a failed pair."""
    if geo_backend == "device":
        device = resolve_device(device)
    np.random.seed(0)  # deterministic pair sampling across epochs
    scenes = scenes or sorted(os.listdir(data_root))
    errs = ImmatchResults()
    count = 0
    t0 = time.time()
    for scene in scenes:
        model_dir = os.path.join(data_root, scene, "dense/sparse")
        im_dir = os.path.join(data_root, scene, "dense/images")
        ims = load_model_ims(model_dir)
        ov = np.load(
            os.path.join(model_dir, "ov_pairs.npy"), allow_pickle=True
        ).item()
        pair_names = list(ov[min_overlap])
        if len(pair_names) > sample_max:
            np.random.shuffle(pair_names)
            pair_names = pair_names[:sample_max]

        for im1_name, im2_name in pair_names:
            im1, im2 = ims[im1_name], ims[im2_name]
            t_gt, q_gt = abs2relapose(im1.c, im2.c, im1.q, im2.q)
            F = pose2fund(im1.K, im2.K, qvec2rotmat(q_gt), t_gt)
            p1 = os.path.join(im_dir, im1_name)
            p2 = os.path.join(im_dir, im2_name)
            count += 1
            try:
                matches, scores, coarse = matcher(p1, p2)
            except Exception:
                errs.match_failed.append((p1, p2))
                continue
            n = len(matches)
            cd = sampson_distance(coarse[:, 0:2], coarse[:, 2:4], F)
            fd = sampson_distance(matches[:, 0:2], matches[:, 2:4], F)
            errs.cdist.append(cd)
            errs.fdist.append(fd)
            errs.num_matches.append(n)
            try:
                terr, qerr, inls = eval_matches_relapose(
                    matches, im1.K, im2.K, q_gt, t_gt, rthres,
                    backend=geo_backend, device=device,
                )
            except Exception:
                errs.geo_failed.append((p1, p2))
                continue
            errs.qt.append(max(terr, qerr))
            errs.irat.append(len(inls) / max(n, 1))
            errs.indist.append(fd[inls])
            errs.num_inls.append(len(inls))

    dt = time.time() - t0
    log(
        f"Pairs {count} match_failed={len(errs.match_failed)} "
        f"geo_failed={len(errs.geo_failed)} "
        f"num_matches={np.mean(errs.num_matches) if errs.num_matches else 0:.2f} "
        f"irat={np.mean(errs.irat) if errs.irat else 0:.3f} time:{dt:.2f}s"
    )
    bins = [0, 1e-2, 1, 5, 10, 25, 50, 100, 2500, 1e5]
    for dists, tag in ((errs.cdist, "cdist"), (errs.fdist, "fdist"), (errs.indist, "indist")):
        _, txt = inlier_distance_histogram(dists, bins=bins, tag=tag)
        log(txt)
    pass_rate = errs.pass_rates()
    log(
        f"Pose err: qt_mean={errs.qt_mean:.2f}/{errs.qt_median:.2f} "
        f"qt<[1-10]deg:{pass_rate}"
    )
    return errs.qt_mean, pass_rate, errs
