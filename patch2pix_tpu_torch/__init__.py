"""patch2pix_tpu_torch — the Patch2Pix dense-matching inference path in
PyTorch, with hand-written CUDA kernels for Hopper (``sm_90a``).

A port of ``patch2pix_tpu`` that keeps its module layout and its
channels-last public layouts, so the two packages can be compared
function by function:

  * ``models``: ResNet34 feature pyramid, symmetric neighbourhood
    consensus, mid/fine regressors and the ``Patch2Pix`` pipeline,
  * ``ops``: correlation, conv4d, match extraction, patch gathers and
    the fused fine-stage head, each kernel (``tap_sum``, ``corr_pool``,
    ``patch_expand``, ``conv4d_small``, ``fine_stage``) beside its plain
    PyTorch version,
  * ``evaluation``: the inference façade ``Matcher`` and the evaluation
    protocols (immatch validation, HPatches, localisation),
  * ``sfm``: the 5-point, 8-point and PnP RANSACs, batched
    ``torch.linalg`` work on the card,
  * ``data``: image loading, the MegaDepth loader, the COLMAP and NVM
    readers, synthetic scenes.

Entry points run on CUDA unless the caller passes ``device="cpu"``;
on CPU tensors every kernel wrapper runs its plain version.
"""

__version__ = "0.1.0"
