"""patch2pix_tpu_torch.data: image loading and preprocessing, the
MegaDepth pair dataset and the overlap scores, under the JAX package's
names."""

from patch2pix_tpu_torch.data.megadepth import MegaDepthPairDataset, batch_iterator
from patch2pix_tpu_torch.data.overlap import (
    SceneImage,
    cal_overlap_scores,
    load_model_ims,
    model_multi_ov_pairs,
)
from patch2pix_tpu_torch.data.preprocess import (
    cal_rescale_size,
    crop_from_bottom_right,
    imagenet_normalize,
    load_im_flexible,
    load_im_tensor,
    load_image,
    scale_intrinsic,
    to_array,
)

__all__ = [
    "cal_rescale_size",
    "crop_from_bottom_right",
    "imagenet_normalize",
    "load_im_flexible",
    "load_im_tensor",
    "load_image",
    "scale_intrinsic",
    "to_array",
    "MegaDepthPairDataset",
    "batch_iterator",
    "SceneImage",
    "cal_overlap_scores",
    "load_model_ims",
    "model_multi_ov_pairs",
]
