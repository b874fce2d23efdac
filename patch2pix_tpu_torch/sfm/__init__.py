"""patch2pix_tpu_torch.sfm: the two-view, 5-point and PnP solvers and
their RANSACs (the SfM backend's bundle adjustment, tracks and
incremental mapping are not ported yet)."""

from patch2pix_tpu_torch.sfm.fivepoint import (
    estimate_relative_pose_5pt,
    five_point,
    ransac_essential_5pt,
)
from patch2pix_tpu_torch.sfm.pnp import PnPResult, dlt_pnp, ransac_pnp
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
