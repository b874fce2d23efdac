"""patch2pix_tpu_torch.sfm: the SfM backend — the two-view, 5-point and
PnP solvers and their RANSACs, tracks (the C++ union-find of
:mod:`patch2pix_tpu_torch.native`), Schur bundle adjustment on one
device and point-sharded over ``torch.distributed``, incremental
mapping with its COLMAP export, trajectory metrics and the synthetic
scale scene (``python -m patch2pix_tpu_torch.sfm.scale_demo``)."""

from patch2pix_tpu_torch.sfm.ba import (
    BAProblem,
    build_problem,
    cost,
    reprojection_rmse,
    run_ba,
)
from patch2pix_tpu_torch.sfm.dist_ba import ShardedBA, run_dist_ba, shard_problem
from patch2pix_tpu_torch.sfm.fivepoint import (
    estimate_relative_pose_5pt,
    five_point,
    ransac_essential_5pt,
)
from patch2pix_tpu_torch.sfm.incremental import (
    IncrementalSfM,
    Reconstruction,
    export_colmap,
)
from patch2pix_tpu_torch.sfm.metrics import ate_rmse, rotation_errors_deg, umeyama_alignment
from patch2pix_tpu_torch.sfm.pnp import PnPResult, dlt_pnp, ransac_pnp
from patch2pix_tpu_torch.sfm.tracks import build_tracks
from patch2pix_tpu_torch.sfm.twoview import (
    TwoViewResult,
    decompose_essential,
    draw_sample_ids,
    eight_point,
    estimate_relative_pose,
    normalize_points,
    ransac_essential,
    triangulate,
)

__all__ = [
    "BAProblem",
    "build_problem",
    "cost",
    "reprojection_rmse",
    "run_ba",
    "ShardedBA",
    "run_dist_ba",
    "shard_problem",
    "IncrementalSfM",
    "Reconstruction",
    "export_colmap",
    "ate_rmse",
    "rotation_errors_deg",
    "umeyama_alignment",
    "build_tracks",
    "estimate_relative_pose_5pt",
    "five_point",
    "ransac_essential_5pt",
    "PnPResult",
    "dlt_pnp",
    "ransac_pnp",
    "TwoViewResult",
    "decompose_essential",
    "draw_sample_ids",
    "eight_point",
    "estimate_relative_pose",
    "normalize_points",
    "ransac_essential",
    "triangulate",
]
