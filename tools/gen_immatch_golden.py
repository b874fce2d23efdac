"""Generate the ImMatchNet golden: the JAX package's NCNet matcher at
1024x768, float32, on the CPU.

Runs ``patch2pix_tpu.models.immatch_net.ImMatchNet`` (VGG16 to pool4,
NCN (3, 3, 3) / (10, 10, 1), symmetric, normalised features, no
relocalisation) with numpy-seeded weights (``tests/ref_loader
.seeded_state_dict`` over the NCNet checkpoint's key layout, converted
by ``convert_ncnet_checkpoint``) on seeded noise images, then
``corr_to_matches`` on the filtered volume. Stores only the outputs and
the shape map, so the fixture stays small and a port rebuilds the
weights from ``meta``:

  * ``grid`` (B, N, 4) int32, ``scores`` (B, N) float32 and ``mutual``
    (B, N) bool, N = h2*w2 + h1*w1 (both directions);
  * ``margin`` (B, N) float32: for each row, its best value minus the
    second best along the reduced axis of the volume. A port's row may
    pick another cell only where this margin is below its float32
    rounding (a score tie);
  * ``meta``: seed, shapes, image seeds, size, batch, the model's
    settings and ``corr_max`` (max |volume|).

Usage: python tools/gen_immatch_golden.py  (a few minutes on 8 cores)
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tests.ref_loader import seeded_state_dict
from tests.test_pipeline_e2e_parity import FIXDIR, seeded_images

SEED = 0
IM_SEEDS = (21, 22)
H, W, BATCH = 768, 1024, 1
KERNELS, CHANNELS = (3, 3, 3), (10, 10, 1)
OUT = os.path.join(FIXDIR, "immatch_golden_vgg_1024.npz")


def ncnet_shapes():
    """{key: shape} of an NCNet VGG16 checkpoint for this setting."""
    from patch2pix_tpu.models.vgg import VGG16_LAYERS

    shapes, cin = {}, 3
    for idx, (name, kind, cout) in enumerate(VGG16_LAYERS):
        if kind == "conv":
            shapes[f"FeatureExtraction.model.{idx}.weight"] = (cout, cin, 3, 3)
            shapes[f"FeatureExtraction.model.{idx}.bias"] = (cout,)
            cin = cout
        if name == "pool4":
            break
    cin = 1
    for li, (k, cout) in enumerate(zip(KERNELS, CHANNELS)):
        # the reference's pre-permuted conv4d layout (k1, out, in, k2, k3, k4)
        shapes[f"NeighConsensus.conv.{2 * li}.weight"] = (k, cout, cin, k, k, k)
        shapes[f"NeighConsensus.conv.{2 * li}.bias"] = (cout,)
        cin = cout
    return shapes


def top2_margin(flat, axis):
    """Best minus second best along ``axis`` of (B, na, nb)."""
    part = -np.partition(-flat, 1, axis=axis)
    first = np.take(part, 0, axis=axis)
    second = np.take(part, 1, axis=axis)
    return (first - second).astype(np.float32)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from patch2pix_tpu.models.immatch_net import ImMatchNet
    from patch2pix_tpu.ops.match_extract import corr_to_matches
    from patch2pix_tpu.utils.torch_import import convert_ncnet_checkpoint, merge_variables

    shapes = ncnet_shapes()
    sd = seeded_state_dict(shapes, seed=SEED)
    model = ImMatchNet(feature_extraction_cnn="vgg", ncons_kernel_sizes=KERNELS,
                       ncons_channels=CHANNELS)
    a = jnp.asarray(seeded_images(BATCH, H, W, IM_SEEDS[0]))
    b = jnp.asarray(seeded_images(BATCH, H, W, IM_SEEDS[1]))
    small = jnp.zeros((1, 64, 64, 3), jnp.float32)
    params, stats = convert_ncnet_checkpoint(sd)
    variables = merge_variables(model.init(jax.random.PRNGKey(0), small, small), params, stats)
    corr, _ = jax.jit(model.apply)(variables, a, b)
    grid, scores, mutual = jax.jit(corr_to_matches)(corr)
    corr = np.asarray(corr)
    bsz, h1, w1, h2, w2 = corr.shape
    flat = corr.reshape(bsz, h1 * w1, h2 * w2)
    # direction-1 rows reduce over source cells, direction-2 over targets
    margin = np.concatenate([top2_margin(flat, 1), top2_margin(flat, 2)], axis=1)
    meta = dict(seed=SEED, shapes={k: list(v) for k, v in shapes.items()},
                im_seeds=list(IM_SEEDS), h=H, w=W, batch=BATCH,
                feature_extraction_cnn="vgg", ncons_kernel_sizes=list(KERNELS),
                ncons_channels=list(CHANNELS), normalize_features=True,
                relocalization_k_size=0, corr_max=float(np.abs(corr).max()))
    np.savez_compressed(OUT, grid=np.asarray(grid).astype(np.int32),
                        scores=np.asarray(scores).astype(np.float32),
                        mutual=np.asarray(mutual), margin=margin, meta=json.dumps(meta))
    print(f"wrote {OUT}: volume {corr.shape}, max |corr| {meta['corr_max']:.6g}, "
          f"{int(np.asarray(mutual).sum())} mutual rows, smallest margin {margin.min():.3g}")


if __name__ == "__main__":
    main()
