"""patch2pix_tpu_torch.evaluation: the matcher façade, the batched
matcher (pairs sharded over a mesh, ``batched.py``) and the evaluation
protocols (PhotoTourism immatch validation, HPatches MMA, localisation
against a COLMAP map) with their geometry and measures; the JAX
package's names."""

from patch2pix_tpu_torch.evaluation.batched import BatchedMatcher
from patch2pix_tpu_torch.evaluation.geometry import (
    abs2relapose,
    ess2fund,
    fund2ess,
    matches2relapose_cv,
    norm_fund,
    pose2ess,
    pose2fund,
    skew,
)
from patch2pix_tpu_torch.evaluation.hpatches import HpatchesResults, eval_hpatches
from patch2pix_tpu_torch.evaluation.localize import (
    LocalizationResult,
    MapImage,
    localize_query,
    map_images_from_colmap,
)
from patch2pix_tpu_torch.evaluation.immatch import ImmatchResults, eval_immatch_val_sets
from patch2pix_tpu_torch.evaluation.matcher import (
    Matcher,
    estimate_matches,
    init_ncn_matcher,
    init_patch2pix_matcher,
    load_model,
)
from patch2pix_tpu_torch.evaluation.measure import (
    eval_matches_relapose,
    inlier_distance_histogram,
    quat_angle_error,
    rot_angle_error,
    sampson_distance,
    symmetric_epipolar_distance,
    vec_angle_error,
)

__all__ = [
    "BatchedMatcher",
    "abs2relapose",
    "ess2fund",
    "fund2ess",
    "matches2relapose_cv",
    "norm_fund",
    "pose2ess",
    "pose2fund",
    "skew",
    "LocalizationResult",
    "MapImage",
    "localize_query",
    "map_images_from_colmap",
    "HpatchesResults",
    "eval_hpatches",
    "ImmatchResults",
    "eval_immatch_val_sets",
    "Matcher",
    "estimate_matches",
    "init_ncn_matcher",
    "init_patch2pix_matcher",
    "load_model",
    "eval_matches_relapose",
    "inlier_distance_histogram",
    "quat_angle_error",
    "rot_angle_error",
    "sampson_distance",
    "symmetric_epipolar_distance",
    "vec_angle_error",
]
