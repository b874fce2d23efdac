"""patch2pix_tpu_torch.ops: the matching ops and the kernels' wrappers,
under the JAX package's names.

``ops.conv4d`` is the function, as in the JAX package; code that needs
the module (to replace one of its names) takes it with
``importlib.import_module("patch2pix_tpu_torch.ops.conv4d")``.
"""

from patch2pix_tpu_torch.ops.conv4d import conv4d, conv4d_xla_taps
from patch2pix_tpu_torch.ops.correlation import (
    feat_correlation,
    l2_normalize,
    maxpool4d,
    mutual_matching,
)
from patch2pix_tpu_torch.ops.geometry import (
    ess2fund,
    fund2ess,
    pose2ess,
    pose2fund,
    sampson_dist,
    skew,
    sym_epi_dist,
)
from patch2pix_tpu_torch.ops.match_extract import (
    Matches,
    corr_to_matches,
    mutual_consistency_mask,
    select_ptmax,
)
from patch2pix_tpu_torch.ops.patch_gather import (
    gather_local_patches,
    gather_local_patches_grid,
    gather_local_patches_ref,
)

__all__ = [
    "l2_normalize",
    "feat_correlation",
    "mutual_matching",
    "maxpool4d",
    "conv4d",
    "corr_to_matches",
    "mutual_consistency_mask",
    "select_ptmax",
    "Matches",
    "gather_local_patches",
    "sampson_dist",
    "sym_epi_dist",
    "pose2fund",
    "pose2ess",
    "ess2fund",
    "fund2ess",
    "skew",
]
