"""patch2pix_tpu_torch — the Patch2Pix dense-matching inference path in
PyTorch, with hand-written CUDA kernels for Hopper (``sm_90a``).

A port of ``patch2pix_tpu`` that keeps its module layout and its
channels-last public layouts, so the two packages can be compared
function by function:

  * ``models``: ResNet34 feature pyramid, symmetric neighbourhood
    consensus, mid/fine regressors and the ``Patch2Pix`` pipeline,
  * ``ops``: correlation, conv4d, match extraction and patch gathers,
    each kernel (``tap_sum``, ``corr_pool``, ``patch_expand``) beside
    its plain PyTorch version,
  * ``evaluation.Matcher``: the inference façade.

Entry points run on CUDA unless the caller passes ``device="cpu"``;
on CPU tensors every kernel wrapper runs its plain version.
"""

__version__ = "0.1.0"
