#!/usr/bin/env python3
"""Drive the PyTorch port (``patch2pix_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

  1. print the card's name and power limit, build the five CUDA sources
     (one ``nvcc`` per source, in parallel) and print the build time;
  2. for each kernel (B1 tap_sum, B2 corr_pool, B3 expand_scale_pair, B4
     conv4d_small, B5 fused_fine_head, B7 expand_level), at the shapes of
     its path (change_stride, 1024x768, B=2: the NCN volume, M = 2400
     proposals, F = 512; B2 also at upsample 16 and at the ResNet101
     change_stride layer3, (2, 96, 128, 1024), which bf16 runs through the
     kernel's streamed instance), in bf16 and in float32:
     hold the kernel against its plain PyTorch version on the card, time
     kernel, plain version and library yardstick, and compute the bound
     from the bytes and operations this run's inputs need (B3, B4, B5 and
     B7 also print their share of the bound, B4 and B7 their registers,
     shared memory and spills; B4 is held and timed on the
     channels-last volume the NCN's fold-in leaves and on an NCHW view,
     and prints its tensor-core kernel's registers and shared memory for
     each staging and, as a yardstick the port never calls for these
     channels,
     ``conv4d_xla_taps``); for B1-B3, the gradients through the
     kernel route must be ``torch.equal`` to autograd's through the plain
     version, and their named backward is timed;
  3. golden parity in float32 with TF32 off: rebuild the seeded weights
     and reproduce ``tests/fixtures/pipeline_golden_{s16,cs}_1024.npz``
     (identical coarse set, coords 0.05 px, scores 5e-3) — every kernel's
     launch count must rise;
  4. the main path in bf16 at 1024x768: ``Matcher.match_arrays`` on one
     pair, then ``Patch2Pix.predict_fine`` at B=2, fine_cap 1200, for
     change_stride and upsample 16: output checks, kernel launches per
     call, pairs/s over 10 calls back to back, the median latency of 10
     calls each waited for, peak device memory; then, per stride, the
     top device kernels (and the port's own wherever they rank) and the
     device busy share over 3 calls under torch.profiler (after the
     launch counts are read);
  5. the conv4d path: a symmetric NeighConsensus with channels (4, 4, 1)
     in bf16 on the change_stride volume — B4 twice (both on its
     tensor-core kernel, staging channels-last) and B1 twice per call,
     output held against the
     same NCN with B4's plain version; then one B4 layer's backward
     through the kernel against the CPU's, and one bf16 4->4 layer's
     backward timed at the change_stride shape;
  6. the fine-head path (the port's ``tools/try_fine_stage.py``): a
     full-width fine FeatRegressNet, M = 2400 seeded bf16 rows, (M, 5)
     outputs fused (prolog with B7, B5, fc_head) and unfused (B3,
     ``forward``), held to the rules below, both timed; then the ten B7
     calls of one prolog, each held ``torch.equal`` to its plain version
     and timed, their sum printed beside the fused stage's split;
  7. training: the Patch2Pix train step at the reference setting
     (ResNet34 change_stride, 480x320, batch 4, ptmax 400, panc 8, ksize
     2, Adam 5e-4, backbone and NCN frozen, remat auto), seeded weights
     and synthetic pairs, 3 warm-up and 10 timed steps in bf16, then in
     float32: ms per step, training pairs/s, peak memory, launches and
     backward calls per step (B1 and B3 must launch), the profiler's
     kernel table and busy share; frozen weights bit-identical, trained
     ones and the regressors' running averages moved, finite losses;
     then one step with nothing frozen, which runs B3's backward. In
     each run, every B1 and B3 call of the step whose launches are
     counted is held against its plain version by phase 2's rules at the
     step's own shapes (B3 at M = 12800, bf16 and float32), and the
     first of each through both backward routes (``torch.equal``);
  8. the training forward's golden in float32:
     ``pipeline_golden_train_panc8.npz`` (480x320, panc 8, M = 2400),
     anchors 1e-3, coords 0.05 px, scores 5e-3;
  9. NCN pretraining at 1024x768, change_stride, ksize 2, bf16, one
     triplet: 2 warm-up and 5 timed steps (B1 and B2 forward, B1's
     backward; only the NCN moves, as in JAX, so no training path
     reaches B2's backward), then one more step whose B1 and B2 calls
     are held as in phase 7;
  10. the training entry point, ``python -m patch2pix_tpu_torch.train.cli``
     through ``train.cli.main``: a seeded MegaDepth-layout fixture (12
     pairs of 480x320 PNGs from ``make_posed_pair``, their K, R, t in the
     pair npy) and the seeded state dict as a ``.pth``; the reference
     best-model setting (phase 7's) with ``--pretrain``, bf16,
     ``--no_eval``, 2 epochs x 3 steps, with B1-B3's launches counted from
     zero and the first call of each held against its plain version as in
     phase 7; then ``--resume`` for a third epoch (the meta's epoch, the
     step count, frozen weights bit-identical to the ``.pth``, the
     regressors and their running averages moved, finite losses); one
     epoch of 2 steps with ``--feat_comb post --backbone_train_bn`` (B1-B3
     launch, the backbone's running averages move, its weights do not);
     ``init_patch2pix_matcher`` on the run directory (its parameters
     ``torch.equal`` to ``load_ckpt``'s) and the functional
     ``estimate_matches(model, ...)`` on two fixture PNGs (equal to the
     matcher's method); one epoch of 2 steps without ``--no_eval``, whose
     immatch validation on a 2-pair ``val_dense`` fixture at 1024x768
     must log ``Pose err:`` with no failed pair and no ``Failed to eval
     immatch``, and write ``immatch_best``. Prints the CLI's ms per step
     beside phase 7's, split into each epoch's first-batch wait, device
     ms per step and metrics flush; the peak memory, the checkpoint's
     bytes and its save and restore ms;
  11. the NCNet family's ImMatchNet at the reference default (VGG16 to
     pool4, NCN (3, 3, 3)/(10, 10, 1), symmetric), seeded weights and
     images, 1024x768, B = 1, bf16: forward + ``corr_to_matches`` timed
     (latency, pairs/s, peak memory, the profiler's table and busy share),
     B1 twice a call and its first call held as in phase 2; relocalisation
     k = 2 (``maxpool4d``, both extractions, grids in the pre-pool grid);
     then float32 against ``tests/fixtures/immatch_golden_vgg_1024.npz``;
  12. the NCNet-only coarse matcher with ResNet101 (``Patch2Pix``,
     change_stride, no regressor), ``predict_coarse`` at 1024x768, B = 2,
     ksize 2, bf16: B2 on 1024 bf16 channels once and B1 twice a call,
     each first call held as in phase 2, timed, its match set held to the
     same model's float32 run;
  13. evaluation: (a) the 5-point, 8-point and PnP RANSACs on a
     ``make_posed_pair`` pose at 1024x768 (1200 correspondences of
     off-plane points, 0.3 px noise, 25% outliers), on the card against
     the CPU on the same sample ids (inlier masks within 0.5% of rows, R
     within 0.05 deg, t within 0.1 deg), then with the card's generator
     within 0.5 deg of the true pose (the 8-point's t within 2 deg),
     host ms per call (median of 10) and
     device ms and ops per call (profiler); (b) ``eval_immatch_val_sets``
     on a 4-scene PhotoTourism-layout fixture (``write_val_dense_fixture``,
     1024x768): the oracle matcher under 1 deg at every pair, then the
     Matcher at the JAX CLI's validation setting (ResNet34 change_stride,
     seeded, bf16, ksize 2, io_thres 0.5, imsize 1024) twice with no
     failed pair, B1-B3 launched, ms per pair split into matching and
     geometry; (c) ``eval_hpatches`` on one synthetic sequence (a
     reference and 5 warps) with the same Matcher: no failed pair,
     MMA@1..10 printed; the phase's seconds;
  14. the SfM backend, which has no kernel (TF32 off): (a) one
     ``ba_step`` (lambda 1e-3, no Huber) on ``tools/bench_ba.py``'s
     (200, 20000, 9) scene with its perturbed points, on the card against
     the CPU (old cost rtol 1e-5, new cost rtol 1e-3, R and t atol 1e-5)
     and a second step from the same problem bit for bit equal to the
     first, then ms per LM iteration by bench_ba's marginal method (k = 6 minus
     k = 2 iterations, best of 3) at (200, 20000, 9) and (500, 100000, 6),
     with the peak memory, the profiler's top kernels of one iteration and
     the bound (Bt^T Bt's operations at the f32 peak or Bt's bytes, the
     larger); (b) the point-sharded BA at world size 1 over NCCL on (a)'s
     problem: the first step against ``ba_step`` by (a)'s rules, and
     ``run_dist_ba(max_iters=10, debug_checks=True)`` below 1e-2 of the
     initial cost and within 0.5 relative of ``run_ba``'s; (c) the scale
     demo (``python -m patch2pix_tpu_torch.sfm.scale_demo``) at its
     defaults, 50 cameras, 5000 points, ``--mesh 1``: every camera
     registered, more than 3000 points, ATE under 1% of the scene radius
     after the incremental run and after the dist BA, the C++ track
     builder used, the COLMAP export read back; the stage attribution,
     the RANSAC, PnP and BA calls, the LM iterations and the dist BA's
     host synchronisations per iteration; the phase's seconds;
  15. one JSON line of per-kernel numbers (B1's and B2's launches summed
     over phases 4, 11, 12 and 13, B3's over 4 and 13), then the result
     line.

Each path's launches are counted from zero just before it runs: phase 4
for B1-B3, phase 5 for B4, phase 6 for B5 and B7, phase 10 for B1-B3
under the CLI, phases 11 and 12 for B1 and B2, phase 13 for B1-B3
under the protocols' Matcher.

Needs one CUDA card, ``nvcc`` and the repository checkout; imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from patch2pix_tpu_torch.config import ModelConfig, OptimConfig, model_config_from_json
from patch2pix_tpu_torch.data.synthetic import (
    make_pair,
    make_posed_pair,
    oracle_matcher,
    synthetic_batch,
    warp_homography,
    write_megadepth_fixture,
    write_val_dense_fixture,
)
from patch2pix_tpu_torch.evaluation import immatch as immatch_module
from patch2pix_tpu_torch.evaluation.hpatches import eval_hpatches
from patch2pix_tpu_torch.evaluation.immatch import eval_immatch_val_sets
from patch2pix_tpu_torch.evaluation.matcher import (
    Matcher,
    estimate_matches,
    init_patch2pix_matcher,
)
from patch2pix_tpu_torch.models import patch2pix as patch2pix_module
from patch2pix_tpu_torch.models.immatch_net import ImMatchNet
from patch2pix_tpu_torch.models.ncn import NeighConsensus
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix, shift_to_anchors
from patch2pix_tpu_torch.models.regressor import FeatRegressNet
from patch2pix_tpu_torch.ops import _build
from patch2pix_tpu_torch.ops import conv4d as conv4d_module
from patch2pix_tpu_torch.ops import fine_stage as fine_stage_module
from patch2pix_tpu_torch.ops import patch_gather as patch_gather_module
from patch2pix_tpu_torch.ops.conv4d_small import _SIGNATURES as CONV4D_SIGNATURES
from patch2pix_tpu_torch.ops.conv4d_small import (
    banded_filter,
    conv4d_small,
    conv4d_small_plain,
    mma_fragments,
)
from patch2pix_tpu_torch.ops.corr_pool import LAYOUTS as CORR_POOL_LAYOUTS
from patch2pix_tpu_torch.ops.corr_pool import (
    cell_parity_rows,
    corr_pool,
    corr_pool_backward,
    corr_pool_plain,
)
from patch2pix_tpu_torch.ops.correlation import feat_correlation, l2_normalize
from patch2pix_tpu_torch.ops.fine_stage import _SIGNATURES as FINE_HEAD_SIGNATURES
from patch2pix_tpu_torch.ops.fine_stage import (
    fused_fine_head,
    fused_fine_head_plain,
    fused_fine_stage,
    head_args,
    head_prolog,
    segment_weights,
)
from patch2pix_tpu_torch.ops.match_extract import corr_to_matches, corr_to_matches_topk
from patch2pix_tpu_torch.ops.patch_expand import _SIGNATURES as EXPAND_SIGNATURES
from patch2pix_tpu_torch.ops.patch_expand import (
    _window_indices,
    expand_level,
    expand_level_plain,
    expand_scale_pair,
    expand_scale_pair_backward,
    expand_scale_pair_plain,
    level_plan,
    output_slice_map,
    window_extent,
)
from patch2pix_tpu_torch.ops.patch_expand import plan as expand_plan
from patch2pix_tpu_torch.ops.tap_sum import (
    flat_shift_masks,
    tap_sum,
    tap_sum_backward,
    tap_sum_plain,
)
from patch2pix_tpu_torch import native as native_module
from patch2pix_tpu_torch.data.colmap_model import read_model
from patch2pix_tpu_torch.sfm import ba as ba_module
from patch2pix_tpu_torch.sfm import incremental as incremental_module
from patch2pix_tpu_torch.sfm import scale_demo
from patch2pix_tpu_torch.sfm.ba import build_problem, cost, run_ba
from patch2pix_tpu_torch.sfm.dist_ba import (
    local_problem,
    make_dist_ba_step,
    process_group,
    run_dist_ba,
    shard_problem,
)
from patch2pix_tpu_torch.sfm.fivepoint import ransac_essential_5pt
from patch2pix_tpu_torch.sfm.pnp import ransac_pnp
from patch2pix_tpu_torch.sfm.scale_demo import (
    lm_iteration_ms,
    lm_iterations,
    make_ba_scene,
    perturb_points,
)
from patch2pix_tpu_torch.sfm.twoview import draw_sample_ids, ransac_essential
from patch2pix_tpu_torch.train import cli as train_cli
from patch2pix_tpu_torch.train import create_train_state, make_ncn_pretrain_step, make_train_step
from patch2pix_tpu_torch.train.checkpoint import load_ckpt, read_meta, save_ckpt
from patch2pix_tpu_torch.train.step import resolve_remat
from patch2pix_tpu_torch.utils import logging as logging_module
from patch2pix_tpu_torch.utils.torch_import import load_ncnet_checkpoint
from tests.ref_loader import seeded_state_dict

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXDIR = os.path.join(ROOT, "tests", "fixtures")

# published H100 SXM peaks (dense): HBM bytes/s, bf16 tensor-core and
# f32 (non-tensor) FLOP/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

KERNELS = {  # wrapper -> (name, source, TPU kernel it replaces)
    tap_sum: ("tap_sum", "patch2pix_tpu_torch/csrc/tap_sum.cu",
              "patch2pix_tpu/ops/tap_sum_pallas.py:123"),
    corr_pool: ("corr_pool", "patch2pix_tpu_torch/csrc/corr_pool.cu",
                "patch2pix_tpu/ops/corr_pool_pallas.py:126"),
    expand_scale_pair: ("expand_scale_pair", "patch2pix_tpu_torch/csrc/patch_expand.cu",
                        "patch2pix_tpu/ops/patch_expand_pallas.py:436"),
    conv4d_small: ("conv4d_small", "patch2pix_tpu_torch/csrc/conv4d.cu",
                   "patch2pix_tpu/ops/conv4d_pallas.py:169"),
    fused_fine_head: ("fused_fine_head", "patch2pix_tpu_torch/csrc/fine_head.cu",
                      "patch2pix_tpu/ops/fine_stage_pallas.py:332"),
    expand_level: ("expand_level", "patch2pix_tpu_torch/csrc/patch_expand.cu",
                   "tools/try_expand_kernels.py:93"),
}

# the device functions of csrc/*.cu, as the profiler names them
PORT_KERNEL_NAMES = ("tap_sum_kernel", "corr_pool_bf16_kernel", "corr_pool_f32_kernel",
                     "expand_kernel", "expand_level_kernel", "conv4d_small_kernel",
                     "conv4d_small_mma_kernel", "fine_head_bf16_kernel",
                     "fine_head_f32_kernel")

# the main path's setting: 1024x768, B=2, fine_cap 1200
H, W, BATCH, FINE_CAP = 768, 1024, 2, 1200
PSIZE = 16
# the change_stride fine stage: (t, C) per pyramid level, regressor width
LEVELS = ((16, 3), (8, 64), (4, 64), (2, 128))
F_REG = 512


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"FAIL: {msg}")


def time_ms(fn, iters=20, warmup=3):
    """Mean ms per call over ``iters`` calls, CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn):
    """{device kernel name: ms} of one call of fn, from torch.profiler."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.name] = out.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    return out


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bf16_ulps(got, want, atol=0.0):
    """(|got - want| - atol)+ in units of one bf16 ulp of ``want`` (float32
    tensors holding bf16 values). ``atol`` absorbs the float32 rounding of
    a sum whose value is small beside its terms, where one bf16 ulp of the
    value is below the sum's own rounding error."""
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    return ((got - want).abs() - atol).clamp_min(0) / ulp


def reset_counts():
    for fn in KERNELS:
        fn.launches = 0
    conv4d_small.mma_launches = 0
    conv4d_small.channels_last_launches = 0


def counts():
    return {KERNELS[fn][0]: fn.launches for fn in KERNELS}


# ------------------------------------------------------------ phase 2


def tap_sum_inputs(dtype, gen, dev):
    """B1's arguments at the cs main-path shape."""
    bs, h1, w1, hw = BATCH, H // 16, W // 16, (H // 16) * (W // 16)
    z = torch.randn((bs * h1 * w1, 9, hw), generator=gen, device=dev).to(dtype)
    bias = torch.randn((1,), generator=gen, device=dev)
    return z, bias, bs, h1, w1


def hold_tap_sum(tag, z, bias, bs, h1, w1):
    """B1's rule: bit-identical to the plain version. Returns (out, max
    abs err)."""
    got = tap_sum(z, bias, bs, h1, w1)
    want = tap_sum_plain(z, bias, bs, h1, w1)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"{tag}: not bit-identical to the plain version "
             f"(max err {(got - want).abs().max().item()})")
    return got, (got - want).abs().max().item()


def check_tap_sum(dtype, gen, dev):
    """B1 at the cs main-path shape: N = B*48*64 cells, HW = 48*64."""
    bs, h1, w1, hw = BATCH, H // 16, W // 16, (H // 16) * (W // 16)
    n = bs * h1 * w1
    z, bias = tap_sum_inputs(dtype, gen, dev)[:2]
    got, err = hold_tap_sum(f"tap_sum {dtype}", z, bias, bs, h1, w1)
    ms = time_ms(lambda: tap_sum(z, bias, bs, h1, w1))
    plain_ms = time_ms(lambda: tap_sum_plain(z, bias, bs, h1, w1), iters=5)
    # the function reads z only at the taps its masks keep
    taps = sum(int(mask.sum()) for _, mask in flat_shift_masks(bs, h1, w1, dev))
    z_bytes = taps * hw * z.element_size()
    b_ms, b_by = bound(z_bytes + nbytes(bias, got), (taps + n) * hw, torch.float32)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                shape=f"z {tuple(z.shape)} {dtype} -> {tuple(got.shape)} f32")


def bmm_amax(f1, f2, out_dtype=None):
    """The library yardstick: one cuBLAS bmm then the 2^4 values pool."""
    b, h1, w1, c = f1.shape
    _, h2, w2, _ = f2.shape
    a, m = f1.reshape(b, h1 * w1, c), f2.reshape(b, h2 * w2, c).transpose(1, 2)
    c4 = torch.bmm(a, m) if out_dtype is None else torch.bmm(a, m, out_dtype=out_dtype)
    return c4.reshape(b, h1 // 2, 2, w1 // 2, 2, h2 // 2, 2, w2 // 2, 2).amax(dim=(2, 4, 6, 8))


def corr_pool_library(f1, f2):
    """(call, label): for bf16, ``torch.bmm(..., out_dtype=torch.float32)``
    computes the kernel's function (f32 sums and output) where this torch
    has that overload; else the bf16-output bmm, labelled so."""
    if f1.dtype == torch.float32:
        return (lambda: bmm_amax(f1, f2)), "bmm + amax"
    try:
        bmm_amax(f1[:1, :2, :2], f2[:1, :2, :2], torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return (lambda: bmm_amax(f1, f2)), "bf16-output bmm + amax"
    return (lambda: bmm_amax(f1, f2, torch.float32)), "bmm (f32 out) + amax"


def corr_pool_inputs(dtype, gen, dev, h, w, c=256):
    """B2's arguments: 2x (BATCH, h, w, c) unit-norm features."""
    return tuple(l2_normalize(torch.randn((BATCH, h, w, c), generator=gen,
                                          device=dev)).to(dtype) for _ in range(2))


def hold_corr_pool(tag, f1, f2):
    """B2's rule: max abs err <= 1e-4 of the plain version. Returns (out,
    max abs err)."""
    got = corr_pool(f1, f2)
    want = corr_pool_plain(f1, f2)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not err <= 1e-4:
        fail(f"{tag}: max abs err {err} > 1e-4")
    return got, err


def corr_pool_case(dtype, gen, dev, h, w, c=256):
    """B2 on 2x (BATCH, h, w, c) unit-norm features (layer3): held
    against the plain version (max abs err <= 1e-4), timed beside it and
    the library yardstick."""
    f1, f2 = corr_pool_inputs(dtype, gen, dev, h, w, c)
    got, err = hold_corr_pool(f"corr_pool {dtype} {tuple(f1.shape)}", f1, f2)
    ms = time_ms(lambda: corr_pool(f1, f2))
    plain_ms = time_ms(lambda: corr_pool_plain(f1, f2), iters=5)
    library, label = corr_pool_library(f1, f2)
    library_ms = time_ms(library, iters=5)
    # the wrapper's share: the two operand layout copies
    rows1, rows2, chans, k_major = CORR_POOL_LAYOUTS[dtype]
    layout_ms = time_ms(lambda: (cell_parity_rows(f1, rows1, chans, k_major),
                                 cell_parity_rows(f2, rows2, chans, k_major)))
    flops = 2 * BATCH * (h * w) * (h * w) * c
    b_ms, b_by = bound(nbytes(f1, f2, got), flops, dtype)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms,
                shape=f"2x {tuple(f1.shape)} {dtype} -> {tuple(got.shape)} f32, "
                      f"library = {label}, of ms the layout copies {layout_ms:.4f}")


def check_corr_pool(dtype, gen, dev):
    """B2 at the cs main-path shape, layer3 (B, 96, 128, 256); first the
    upsample-16 shape (B, 48, 64, 256), which runs it too, and the
    ResNet101 change_stride layer3 (B, 96, 128, 1024) of phase 12's path
    (bf16 through the streamed instance) are checked and their numbers
    logged."""
    for tag, h, w, c in (("upsample 16", H // 16, W // 16, 256),
                         ("ResNet101 change_stride", H // 8, W // 8, 1024)):
        u = corr_pool_case(dtype, gen, dev, h, w, c)
        log(f"kernel corr_pool [{str(dtype)[6:]}] {tag}, {u['shape']}: max_abs_err "
            f"{u['max_abs_err']:.3g} ms {u['ms']:.4f} plain_ms {u['plain_ms']:.4f} library_ms "
            f"{u['library_ms']:.4f} bound_ms {u['bound_ms']:.4f} ({u['bound_by']})")
        torch.cuda.empty_cache()
    return corr_pool_case(dtype, gen, dev, H // 8, W // 8)


def expand_inputs(dtype, gen, dev):
    """B3's arguments at the cs main-path shape: M = B*fine_cap, both
    sides' rows, padded corners (y1, x1, y2, x2) in [0, H + psize) and
    [0, W + psize), psize, out dtype."""
    m = BATCH * FINE_CAP
    rows = [[torch.randn((m, 4, t, t * c), generator=gen, device=dev).to(dtype)
             for t, c in LEVELS] for _ in range(2)]
    corners = [torch.randint(0, lim + PSIZE, (m,), generator=gen, device=dev,
                             dtype=torch.int32) for lim in (H, W, H, W)]
    return (rows[0], rows[1], *corners, PSIZE, dtype)


def hold_expand(tag, rows1, rows2, y1, x1, y2, x2, psize, out_dtype):
    """B3's rules: float32 outputs within rtol 1e-6 of the plain
    version's, bf16 ones as :func:`expand_bf16_mismatch` bounds them.
    Returns (outs, max abs err, note)."""
    levels = tuple((r.shape[2], r.shape[3] // r.shape[2]) for r in rows1)
    args = (rows1, rows2, y1, x1, y2, x2, psize, out_dtype)
    got = expand_scale_pair(*args)
    want = expand_scale_pair_plain(*args)
    torch.cuda.synchronize()
    err = 0.0
    for g, w_ in zip(got, want):
        if g.shape != w_.shape or g.dtype != w_.dtype:
            fail(f"{tag}: output {g.shape} vs {w_.shape}")
        diff = (g.float() - w_.float()).abs()
        err = max(err, diff.max().item())
        if out_dtype == torch.float32 and (diff > 1e-6 * w_.abs()).any():
            fail(f"{tag}: {int((diff > 1e-6 * w_.abs()).sum())} "
                 f"values beyond rtol 1e-6 (max rel err "
                 f"{(diff / w_.abs().clamp_min(1e-30)).max().item():.3g})")
    note = ""
    if out_dtype == torch.bfloat16:
        # a flip needs the two f32 inverse norms, a few f32 ulps apart, to
        # straddle a bf16 rounding midpoint; a bf16 ulp is 2^16 f32 ulps,
        # so flips are rare: one pixel in 10^4 at most
        flipped, pixels, max_ulps = expand_bf16_mismatch(got, want, levels, psize)
        if flipped * 1e4 > pixels:
            fail(f"{tag}: {flipped} of {pixels} patch pixels "
                 f"disagree with the plain version")
        note = f", {flipped} of {pixels} pixels flipped inv (max {max_ulps:.3g} ulps off)"
    return got, err, note


def check_expand(dtype, gen, dev):
    """B3 at the cs main-path shape: M = B*fine_cap proposals, levels
    (t, C) = (16, 3), (8, 64), (4, 64), (2, 128)."""
    args = expand_inputs(dtype, gen, dev)
    rows, corners, psize = args[:2], args[2:6], args[6]
    m = rows[0][0].shape[0]
    got, err, note = hold_expand(f"expand_scale_pair {dtype}", *args)
    ms = time_ms(lambda: expand_scale_pair(*args))
    plain_ms = time_ms(lambda: expand_scale_pair_plain(*args), iters=5)
    flops = 3 * 2 * m * psize * psize * sum(c for _, c in LEVELS)
    rows_bytes = window_bytes(LEVELS, corners, psize, rows[0][0].element_size())
    b_ms, b_by = bound(rows_bytes + nbytes(*corners, *got), flops, torch.float32)
    smem = expand_plan(LEVELS, psize, rows[0][0].element_size()).smem
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                shape=f"M={m} rows {[tuple(r.shape) for r in rows[0]]} {dtype}{note}, "
                      f"window reads {rows_bytes / 1e6:.1f} MB of "
                      f"{nbytes(*rows[0], *rows[1]) / 1e6:.1f} MB rows, "
                      f"{smem} B shared memory a block, {100 * b_ms / ms:.1f}% of its bound")


def expand_bf16_mismatch(got, want, levels, psize):
    """Hold B3's bf16 outputs against the plain version's, patch pixel by
    patch pixel. Both round the f32 inverse norm to bf16 and multiply the
    same operands, so a pixel whose rounded inverse norm agrees must agree
    bit for bit. The two sum the squares in different orders, so a
    rounding may flip to the neighbouring bf16 value, 2^-7 of it at most;
    each value of such a pixel may then be off by 2^-7 of it plus two
    ulps. Returns (pixels that disagree, pixels, most ulps off); fails on
    a value beyond the bound."""
    cs = [c for _, c in levels]
    d = sum(cs)  # side 2's channels start here in output_slice_map
    slices = output_slice_map([psize // t for t, _ in levels], cs, psize)
    flipped = [None, None]
    max_ulps = 0.0
    for g, w_, sl in zip(got, want, slices):
        k = 0
        for off, c in sl:
            side = int(off >= d)
            gs, ws = g[..., k:k + c].float(), w_[..., k:k + c].float()
            k += c
            ulp = torch.exp2(torch.floor(torch.log2(ws.abs().clamp_min(1e-30))) - 7)
            diff = (gs - ws).abs()
            if (diff > 2 ** -7 * ws.abs() + 2 * ulp).any():
                fail("expand_scale_pair bf16: a value beyond an inverse norm's flip")
            max_ulps = max(max_ulps, (diff / ulp).max().item())
            differs = (gs != ws).any(dim=-1)
            flipped[side] = differs if flipped[side] is None else flipped[side] | differs
    return (sum(int(f.sum()) for f in flipped), sum(f.numel() for f in flipped), max_ulps)


def window_bytes(levels, corners, psize, elsize):
    """Bytes of superblock rows that an expansion's outputs depend on:
    for each proposal, side (corners (y, x) in pairs) and level, the cells
    its patch window covers (t or t+1 along each axis, by the corner's
    alignment), C channels each."""
    total = 0
    for t, c in levels:
        for y0, x0 in zip(corners[0::2], corners[1::2]):
            cells = window_extent(y0, psize, t)[1] * window_extent(x0, psize, t)[1]
            total += int(cells.sum()) * c * elsize
    return total


def conv4d_small_attrs(cin, cout, out_dtype, mode):
    """Registers a thread, static shared memory and spill bytes a block of
    B4's bf16 (tensor-core) kernel with staging ``mode`` (0: any strides,
    1: channels-last Cin 4)."""
    lib = _build.library("conv4d", CONV4D_SIGNATURES)
    vals = [ctypes.c_int() for _ in range(3)]
    rc = lib.p2p_conv4d_small_mma_attrs(cin, cout, int(out_dtype == torch.bfloat16), mode,
                                        *(ctypes.addressof(v) for v in vals))
    _build.check_launch(rc, "conv4d_small attributes")
    return [v.value for v in vals]


def conv4d_small_any_strides_ms(x, w, b):
    """ms of B4's bf16 kernel on the channels-last Cin 4 volume x when it
    is made to stage any strides (mode 0), not a position at a time (mode
    1, the wrapper's choice): the gain of mode 1. Calls the library entry
    directly, so the launches do not count. Returns the ms and the output
    as the wrapper returns it."""
    bs, h1, w1, h2, w2, cin = x.shape
    cout = w.shape[-1]
    frag = mma_fragments(banded_filter(w.to(torch.bfloat16)))
    bias = b.float().contiguous()
    out = torch.empty((bs * h1 * w1, cout, h2, w2), dtype=x.dtype, device=x.device)
    lib = _build.library("conv4d", CONV4D_SIGNATURES)
    _, _, sj, sk, sl, sc = x.stride()
    stream = _build.current_stream(x.device)

    def run():
        rc = lib.p2p_conv4d_small_mma(x.data_ptr(), frag.data_ptr(), bias.data_ptr(),
                                      out.data_ptr(), bs, h1, w1, h2, w2, cin, cout, sj, sc,
                                      sk, sl, 1, 1, 0, stream)
        _build.check_launch(rc, "conv4d_small (any-strides staging)")
    return time_ms(run), out.view(bs, h1, w1, cout, h2, w2).permute(0, 1, 2, 4, 5, 3)


def check_conv4d_small(dtype, gen, dev):
    """B4 at the change_stride NCN volume: a 4->4 layer on (2, 48, 64, 48,
    64, 4); bf16 in and out (the NCN's intermediate; the tensor-core
    kernel), or float32 (the SIMT kernel). Held and timed on two layouts
    of the same values: the contiguous channels-last volume, which the
    NCN's fold-in leaves (the conv4d path's input, phase 5; its time is the
    kernel's number), and the NCHW-per-cell view."""
    cin = cout = 4
    dims = (BATCH, H // 16, W // 16, H // 16, W // 16)
    x = torch.randn(dims + (cin,), generator=gen, device=dev).to(dtype)
    nchw = (x.reshape(-1, *dims[3:], cin).permute(0, 3, 1, 2).contiguous()
            .view(*dims[:3], cin, *dims[3:]).permute(0, 1, 2, 4, 5, 3))
    w = torch.randn((3, 3, 3, 3, cin, cout), generator=gen, device=dev) / (81 * cin) ** 0.5
    b = torch.randn((cout,), generator=gen, device=dev) * 0.1
    want = conv4d_small_plain(x, w, b, dtype)
    mma = int(dtype == torch.bfloat16)
    errs, times, notes = [], [], []
    for xin, layout, mode in ((x, "channels-last", 1), (nchw, "NCHW", 0)):
        mma0, cl0 = conv4d_small.mma_launches, conv4d_small.channels_last_launches
        got = conv4d_small(xin, w, b, dtype)
        if (conv4d_small.mma_launches - mma0 != mma
                or conv4d_small.channels_last_launches - cl0 != mma * mode):
            fail(f"conv4d_small {dtype} {layout}: the wrong kernel or staging ran")
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        errs.append(diff.max().item())
        if dtype == torch.float32:
            if not errs[-1] <= 1e-4:
                fail(f"conv4d_small f32 {layout}: max abs err {errs[-1]} > 1e-4")
        else:
            ulps = bf16_ulps(got.float(), want.float(), atol=1e-5)
            if ulps.max().item() > 1:
                fail(f"conv4d_small bf16 {layout}: {int((ulps > 1).sum())} values beyond one "
                     f"bf16 ulp + 1e-5")
        times.append(time_ms(lambda: conv4d_small(xin, w, b, dtype)))
        note = f"{layout} {times[-1]:.4f} ms"
        if mma:
            regs, smem, local = conv4d_small_attrs(cin, cout, dtype, mode)
            note += (f" ({int((diff > 0).sum())} of {diff.numel()} values one ulp off; "
                     f"staging mode {mode}: {regs} registers a thread, {smem} B shared "
                     f"memory a block, {local} B spilled)")
        notes.append(note)
    ms = times[0]
    if mma:
        any_ms, got = conv4d_small_any_strides_ms(x, w, b)
        if bf16_ulps(got.float(), want.float(), atol=1e-5).max().item() > 1:
            fail("conv4d_small bf16 channels-last, any-strides staging: values beyond one "
                 "bf16 ulp + 1e-5")
        notes.insert(1, f"channels-last made to stage any strides (mode 0) {any_ms:.4f} ms")
    plain_ms = time_ms(lambda: conv4d_small_plain(x, w, b, dtype), iters=2, warmup=1)
    # yardstick, never called by the port for these channels: the per-tap
    # path (nine cuDNN convs), float32 sums rounded to dtype
    taps_ms = time_ms(lambda: conv4d_module.conv4d_xla_taps(x, w, b).to(dtype), iters=10)
    flops = 2 * (x.numel() // cin) * 81 * cin * cout
    b_ms, b_by = bound(nbytes(x, w, b, want), flops, dtype)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None,
                shape=f"x {tuple(x.shape)} {dtype} -> 4 channels {want.dtype}; "
                      f"{'; '.join(notes)}; channels-last {100 * b_ms / ms:.1f}% of its bound; "
                      f"library: none; yardstick conv4d_xla_taps (nine cuDNN convs) "
                      f"{taps_ms:.4f} ms")


def expand_level_attrs(elsize):
    """Registers a thread, static shared memory and spill bytes of B7's
    kernel for ``elsize``-byte values."""
    lib = _build.library("patch_expand", EXPAND_SIGNATURES)
    vals = [ctypes.c_int() for _ in range(3)]
    rc = lib.p2p_expand_level_attrs(elsize, *(ctypes.addressof(v) for v in vals))
    _build.check_launch(rc, "expand_level attributes")
    return [v.value for v in vals]


def check_expand_level(dtype, gen, dev):
    """B7 at phase 2's shapes: M = B*fine_cap, each level of one side (one
    launch per level; times are for the four together)."""
    m = BATCH * FINE_CAP
    rows = [torch.randn((m, 4, t, t * c), generator=gen, device=dev).to(dtype)
            for t, c in LEVELS]
    y0, x0 = (torch.randint(0, W + PSIZE, (m,), generator=gen, device=dev, dtype=torch.int32)
              for _ in range(2))
    got = [expand_level(r, y0, x0, PSIZE) for r in rows]
    want = [expand_level_plain(r, y0, x0, PSIZE) for r in rows]
    # the yardstick: one advanced-indexing gather per level, the indices
    # made beforehand (not timed)
    mi = torch.arange(m, device=dev)[:, None, None]
    gathers = []
    for r, (t, c) in zip(rows, LEVELS):
        iy = _window_indices(y0, PSIZE, PSIZE // t)[:, :, None]
        ix = _window_indices(x0, PSIZE, PSIZE // t)[:, None, :]
        gathers.append((r.view(m, 2, 2, t, t, c), (mi, iy // t, ix // t, iy % t, ix % t)))
    lib = [r6[idx] for r6, idx in gathers]
    torch.cuda.synchronize()
    for g, w_, l_, (t, c) in zip(got, want, lib, LEVELS):
        if not (torch.equal(g, w_) and torch.equal(l_, w_)):
            fail(f"expand_level {dtype} (t={t}, C={c}): not bit-identical")
    ms = time_ms(lambda: [expand_level(r, y0, x0, PSIZE) for r in rows])
    plain_ms = time_ms(lambda: [expand_level_plain(r, y0, x0, PSIZE) for r in rows], iters=5)
    library_ms = time_ms(lambda: [r6[idx] for r6, idx in gathers], iters=5)
    per_level = [time_ms(lambda r=r: expand_level(r, y0, x0, PSIZE)) for r in rows]
    # the device's own time per level: a launch-sized level's event time
    # is the host's enqueue
    per_level_dev = [device_ms(lambda r=r: expand_level(r, y0, x0, PSIZE)) for r in rows]
    per_level_dev = [sum(v for k, v in d.items() if "expand_level_kernel" in k)
                     for d in per_level_dev]
    rows_bytes = window_bytes(LEVELS, (y0, x0), PSIZE, rows[0].element_size())
    b_ms, b_by = bound(rows_bytes + nbytes(y0, x0, *got), 0, torch.float32)
    elsize = rows[0].element_size()
    plans = [level_plan(PSIZE, t, c, elsize, r.data_ptr() % 16 == 0)
             for r, (t, c) in zip(rows, LEVELS)]
    regs, smem, local = expand_level_attrs(elsize)
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms,
                shape=f"M={m} one side, levels {LEVELS} {dtype}, per level ms "
                      + "/".join(f"{t:.4f}" for t in per_level)
                      + " (device, profiler: " + "/".join(f"{t:.4f}" for t in per_level_dev)
                      + f"), window reads {rows_bytes / 1e6:.1f} MB, {100 * b_ms / ms:.1f}% of "
                      f"its bound; per level " + ", ".join(
                          f"{'16-byte units' if pl.vec else 'flat runs'} x{pl.per_block}"
                          for pl in plans)
                      + f" proposals a block; {regs} registers a thread, {smem} B static + "
                      f"{max(8 * pl.per_block * PSIZE for pl in plans)} B table shared memory "
                      f"a block at most, {local} B spilled")


def backward_routes(kernel, plain, inputs, grads):
    """Gradients with respect to ``inputs`` for the upstream ``grads``,
    through the kernel route and through autograd of the plain version;
    fails unless they are ``torch.equal`` (the same plain code runs in
    both backwards)."""
    out = []
    for fn in (kernel, plain):
        xs = [x.detach().clone().requires_grad_() for x in inputs]
        outs = fn(*xs)
        out.append(torch.autograd.grad(outs if isinstance(outs, tuple) else (outs,), xs, grads))
    torch.cuda.synchronize()
    for a, b in zip(*out):
        if a.dtype != b.dtype or not torch.equal(a, b):
            return False
    return True


def backward_tap_sum(gen, z, bias, bs, h1, w1):
    """B1's backward at z's shape: both routes, and its ms per call."""
    g = torch.randn((z.shape[0], z.shape[2]), generator=gen, device=z.device)
    same = backward_routes(lambda a, b: tap_sum(a, b, bs, h1, w1),
                           lambda a, b: tap_sum_plain(a, b, bs, h1, w1), (z, bias), (g,))
    ms = time_ms(lambda: tap_sum_backward(g, bs, h1, w1, bias.numel(), z.dtype), iters=10)
    return same, ms, f"g {tuple(g.shape)} f32 -> dz {tuple(z.shape)} {z.dtype}, dbias"


def backward_corr_pool(gen, f1, f2):
    """B2's backward at the features' shape."""
    b, h, w, _ = f1.shape
    g = torch.randn((b, h // 2, w // 2, h // 2, w // 2), generator=gen, device=f1.device)
    same = backward_routes(corr_pool, corr_pool_plain, (f1, f2), (g,))
    ms = time_ms(lambda: corr_pool_backward(f1, f2, g), iters=5, warmup=1)
    return same, ms, f"g {tuple(g.shape)} f32 -> 2x {tuple(f1.shape)} {f1.dtype}"


def backward_expand(gen, rows1, rows2, y1, x1, y2, x2, psize, out_dtype):
    """B3's backward at the rows' shapes, with respect to both sides'
    rows."""
    n = len(rows1)
    outs = expand_scale_pair_plain(rows1, rows2, y1, x1, y2, x2, psize, out_dtype)
    grads = tuple(torch.randn(o.shape, generator=gen, device=o.device).to(o.dtype)
                  for o in outs)
    del outs

    def route(fn):
        return lambda *r: fn(r[:n], r[n:], y1, x1, y2, x2, psize, out_dtype)

    same = backward_routes(route(expand_scale_pair), route(expand_scale_pair_plain),
                           (*rows1, *rows2), grads)
    ms = time_ms(lambda: expand_scale_pair_backward(rows1, rows2, y1, x1, y2, x2, psize,
                                                    out_dtype, grads), iters=5, warmup=1)
    return same, ms, (f"M={rows1[0].shape[0]} {len(grads)} patch gradients {out_dtype} -> "
                      f"both sides' rows {rows1[0].dtype}")


def fine_head_inputs(dtype, gen, dev, m):
    """Seeded rows, in-range corners and a full-width head's weights.
    Returns (B5's arguments, a call of the cuDNN-chain yardstick)."""
    rows = [[torch.randn((m, 4, t, t * c), generator=gen, device=dev).to(dtype)
             for t, c in LEVELS] for _ in range(2)]
    corners = [torch.randint(0, 2 * PSIZE, (m,), generator=gen, device=dev, dtype=torch.int32)
               for _ in range(4)]
    cs = [c for _, c in LEVELS]
    cin = 2 * sum(cs)
    k0 = torch.randn((3, 3, cin, F_REG), generator=gen, device=dev) * (2 / (9 * cin)) ** 0.5
    k1 = torch.randn((3, 3, F_REG, F_REG), generator=gen, device=dev) * (2 / (9 * F_REG)) ** 0.5
    bns = [(torch.rand(F_REG, generator=gen, device=dev) + 0.5,
            torch.randn(F_REG, generator=gen, device=dev) * 0.1) for _ in range(2)]
    inv1, inv2, partial0 = head_prolog(rows[0], rows[1], *corners, k0.to(dtype), PSIZE, dtype)
    args = (rows[0][1:], rows[1][1:], *corners, inv1, inv2, partial0,
            segment_weights(k0, cs, dtype), k1.reshape(9, F_REG, F_REG).to(dtype),
            bns[0], bns[1], PSIZE, dtype)
    return args, cudnn_chain(dtype, rows, corners, k0, k1, bns, dev)


def cudnn_chain(dtype, rows, corners, k0, k1, bns, dev):
    """The yardstick the port never calls: cuDNN conv0 -> BN0 -> conv1
    -> BN1 -> ReLU -> max (``FeatRegressNet.pooled``) on B3's expanded
    patches of the same rows, with the same weights (the patches made
    beforehand, not timed)."""
    net = FeatRegressNet(feat_dim=sum(c for _, c in LEVELS), dtype=dtype, device=dev)
    with torch.no_grad():
        net.conv[0].weight.copy_(k0.permute(3, 2, 0, 1))
        net.conv[2].weight.copy_(k1.permute(3, 2, 0, 1))
        for bn, (scale, shift) in ((net.conv[1], bns[0]), (net.conv[3], bns[1])):
            bn.weight.copy_(scale)
            bn.bias.copy_(shift)
            bn.running_mean.zero_()
            bn.running_var.fill_(1 - bn.eps)
    net.eval()
    patches = expand_scale_pair(rows[0], rows[1], *corners, PSIZE, dtype)
    smap = output_slice_map([PSIZE // t for t, _ in LEVELS], [c for _, c in LEVELS], PSIZE)
    return lambda: net.pooled(patches, None, slice_map=smap)


def check_fine_head(dtype, gen, dev):
    """B5 at the change_stride fine stage: M = 2400, F = 512."""
    m = BATCH * FINE_CAP
    args, chain = fine_head_inputs(dtype, gen, dev, m)
    got = fused_fine_head(*args)
    want = fused_fine_head_plain(*args)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    note = ""
    if dtype == torch.float32:
        bad = diff > 2e-4 + 2e-4 * want.abs()
        if bad.any():
            fail(f"fused_fine_head f32: {int(bad.sum())} values beyond rtol/atol 2e-4 "
                 f"(max abs err {err})")
    else:
        ulps = bf16_ulps(got.float(), want.float(), atol=1e-3)
        if ulps.max().item() > 2:
            fail(f"fused_fine_head bf16: {int((ulps > 2).sum())} values beyond two bf16 ulps "
                 f"+ 1e-3")
        note = (f", {int((diff > 0).sum())} of {diff.numel()} values differ, "
                f"{int((ulps > 0).sum())} by more than 1e-3 (max {ulps.max().item():.2f} "
                f"ulps beyond it)")
    ms = time_ms(lambda: fused_fine_head(*args), iters=10)
    plain_ms = time_ms(lambda: fused_fine_head_plain(*args), iters=2, warmup=1)
    with torch.no_grad():
        chain_err = (chain().float() - want.float()).abs().max().item()
        chain_ms = time_ms(chain, iters=10)
    rows1, rows2, y1, x1, y2, x2, inv1, inv2, partial0, w0, wc1, bn0, bn1 = args[:13]
    segs = sum(w.shape[1] for w in w0)
    flops = 2 * m * (PSIZE // 2) ** 2 * F_REG * 9 * (segs + F_REG)
    rows_bytes = window_bytes(LEVELS[1:], (y1, x1, y2, x2), PSIZE, rows1[0].element_size())
    b_ms, b_by = bound(rows_bytes + nbytes(y1, x1, y2, x2, inv1, inv2, partial0, *w0, wc1,
                                           *bn0, *bn1, got), flops, dtype)
    # the wrapper's device time by kernel: conv0 and conv1 launches, the
    # weights' layout copies
    split = device_ms(lambda: fused_fine_head(*args))
    note += ", device ms " + ", ".join(
        f"{'conv1' if '<true>' in k else 'conv0' if '<false>' in k else k[:40]} {v:.4f}"
        for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
    if dtype == torch.bfloat16:
        lib = _build.library("fine_head", FINE_HEAD_SIGNATURES)
        note += f", {lib.p2p_fine_head_bf16_smem()} B shared memory a block"
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None,
                shape=f"M={m} levels {LEVELS[1:]} F={F_REG} {dtype}{note}, "
                      f"{flops / 1e12:.3f} TFLOP, {100 * b_ms / ms:.1f}% of its bound; "
                      f"library: none (no one PyTorch call computes it); yardstick cuDNN "
                      f"chain (FeatRegressNet.pooled on B3's patches) {chain_ms:.4f} ms, "
                      f"max abs diff to the plain version {chain_err:.3g}")


# ------------------------------------------------------------ phase 3/4


def seeded_images(batch, h, w, seed):
    rs = np.random.RandomState(seed)
    return (rs.rand(batch, h, w, 3).astype(np.float32) - 0.45) / 0.25


def load_golden(tag):
    g = np.load(os.path.join(FIXDIR, f"pipeline_golden_{tag}.npz"), allow_pickle=True)
    meta = json.loads(str(g["meta"]))
    sd = seeded_state_dict({k: tuple(s) for k, s in meta["shapes"].items()},
                           seed=meta["seed"])
    return g, meta, sd


def build_model(change_stride, sd, dtype, dev):
    cfg = ModelConfig(change_stride=change_stride, dtype=dtype).resolved()
    cfg.regressor.panc = 1
    model = Patch2Pix(cfg, device=dev)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    return model


def row_key(row):
    return tuple(int(round(float(v))) for v in row)


def assert_match_parity(b, ref_coarse, ref_mid, ref_mid_scores, ref_fine,
                        ref_fine_scores, fine, mid, cm, coord_tol, score_tol):
    """Align by coarse-row identity, then compare the regressed outputs
    (the rule of tests/test_pipeline_e2e_parity.py)."""
    ref_index = {row_key(r): i for i, r in enumerate(ref_coarse)}
    valid = np.where(cm.valid[b])[0]
    mine = {row_key(cm.coords[b, j]): j for j in valid}
    if set(mine) != set(ref_index):
        fail(f"batch {b}: coarse match sets differ (mine {len(mine)}, ref "
             f"{len(ref_index)}, common {len(set(mine) & set(ref_index))})")
    ri = np.asarray([ref_index[k] for k in ref_index])
    mi = np.asarray([mine[k] for k in ref_index])
    errs = {}
    for name, got, ref, tol in (
        ("mid", mid.coords[b][mi], ref_mid[ri], coord_tol),
        ("mid_scores", mid.scores[b][mi], ref_mid_scores[ri], score_tol),
        ("fine", fine.coords[b][mi], ref_fine[ri], coord_tol),
        ("fine_scores", fine.scores[b][mi], ref_fine_scores[ri], score_tol),
    ):
        errs[name] = float(np.abs(got - ref).max())
        if not errs[name] <= tol:
            fail(f"batch {b}: {name} err {errs[name]} > {tol}")
    return len(ri), errs


def to_numpy(matches):
    return type(matches)(*(t.cpu().numpy() for t in matches))


def check_outputs(tag, fine, mid, cm, b, h, w):
    n = cm.coords.shape[1]
    for name, mt in (("fine", fine), ("mid", mid), ("coarse", cm)):
        if mt.coords.shape != (b, n, 4) or mt.scores.shape != (b, n):
            fail(f"{tag}: {name} shapes {mt.coords.shape}, {mt.scores.shape}")
        if not (torch.isfinite(mt.coords).all() and torch.isfinite(mt.scores).all()):
            fail(f"{tag}: {name} has non-finite values")
    lims = torch.tensor([w, h, w, h], dtype=torch.float32, device=fine.coords.device)
    if (fine.coords < 0).any() or (fine.coords > lims).any():
        fail(f"{tag}: fine matches outside the image")
    if (fine.scores < 0).any() or (fine.scores > 1).any():
        fail(f"{tag}: confidences outside [0, 1]")
    return fine.valid.sum(dim=1).tolist()


def profile_main_path(tag, call, iters=3):
    """The top device kernels, the port's kernels wherever they rank,
    and the device busy share over ``iters`` main-path calls
    (torch.profiler)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us, n = kernels.get(ev.name, (0.0, 0))
            kernels[ev.name] = (us + ev.time_range.elapsed_us(), n + 1)
    busy = sum(us for us, _ in kernels.values())
    if not kernels:
        log(f"profile {tag}: the profiler recorded no device time")
        return
    log(f"profile {tag}: device busy {100 * busy / wall_us:.1f}% of "
        f"{wall_us / iters / 1e3:.2f} ms/call wall, {sum(n for _, n in kernels.values()) / iters:.0f}"
        f" device ops/call")
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    for rank, (name, (us, n)) in enumerate(ranked):
        # the top 15, and the port's own kernels wherever they rank
        if rank < 15 or any(k in name for k in PORT_KERNEL_NAMES):
            log(f"  kernel {us / iters / 1e3:8.3f} ms/call x{n // iters:<4d} #{rank + 1:<3d} "
                f"{name[:110]}")


# ------------------------------------------------------------ phase 5/6


class plain_b4:
    """Within the block, the port's conv4d sends B4's layers to the plain
    version (the reference the conv4d path is held against)."""

    def __enter__(self):
        self.saved = conv4d_module.conv4d_small
        conv4d_module.conv4d_small = conv4d_small_plain

    def __exit__(self, *exc):
        conv4d_module.conv4d_small = self.saved


def seeded_ncn(dev, channels=(4, 4, 1), seed=3):
    """A symmetric bf16 NeighConsensus with seeded fan-in-scaled weights."""
    rs = np.random.RandomState(seed)
    ncn = NeighConsensus(kernel_sizes=(3,) * len(channels), channels=channels,
                         dtype=torch.bfloat16, device=dev)
    sd, cin = {}, 1
    for li, cout in enumerate(channels):
        w = rs.randn(3, cout, cin, 3, 3, 3) * (2.0 / (81 * cin)) ** 0.5
        sd[f"conv.{2 * li}.weight"] = torch.from_numpy(w.astype(np.float32))
        sd[f"conv.{2 * li}.bias"] = torch.from_numpy((rs.randn(cout) * 0.05).astype(np.float32))
        cin = cout
    ncn.load_state_dict(sd)
    return ncn


def conv4d_path(dev):
    """Phase 5: NCN (4, 4, 1) on the change_stride volume, bf16. Rule for
    the kernel run against the plain-B4 run (the final layer is float32):
    max abs err <= 2^-4 of max |ref|, and at most 1e-4 of the values off
    by more than 2^-7 of it (a bf16 rounding flip in B4's output moves
    the next layer's bf16 z by one ulp at a few cells)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    ncn = seeded_ncn(dev)
    dims = (BATCH, H // 16, W // 16, H // 16, W // 16)
    corr = torch.rand(dims, generator=gen, device=dev) * 2 - 1
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        got = ncn(corr)
    torch.cuda.synchronize()
    launches = counts()
    expect = {**{k: 0 for k in launches}, "conv4d_small": 2, "tap_sum": 2}
    staged = conv4d_small.channels_last_launches
    if launches != expect or conv4d_small.mma_launches != 2 or staged != 2:
        fail(f"conv4d path launches {launches} ({conv4d_small.mma_launches} through B4's "
             f"tensor-core kernel, {staged} staging channels-last), expected {expect}, "
             f"both B4 launches on the tensor cores staging the fold-in's channels-last "
             f"volume")
    if got.shape != dims or not torch.isfinite(got).all():
        fail(f"conv4d path: output {tuple(got.shape)} or non-finite values")
    with torch.no_grad(), plain_b4():
        want = ncn(corr)
    scale = want.abs().max().item()
    diff = (got - want).abs()
    err = diff.max().item()
    off = int((diff > 2 ** -7 * scale).sum())
    if not err <= 2 ** -4 * scale or off > 1e-4 * diff.numel():
        fail(f"conv4d path: max abs err {err} (max |ref| {scale}), {off} values off "
             f"by more than 2^-7 of it")
    with torch.no_grad():
        ms = time_ms(lambda: ncn(corr), iters=5)
        with plain_b4():
            plain_ms = time_ms(lambda: ncn(corr), iters=2, warmup=1)
    log(f"conv4d path [NCN (4, 4, 1) symmetric bf16 on {dims}]: launches per call "
        f"{launches} (both B4 launches staging channels-last); max abs err to the "
        f"plain-B4 run {err:.3g} (max |ref| {scale:.3g}), "
        f"{off} of {diff.numel()} values off by more than 2^-7 of it; "
        f"{ms:.3f} ms per call (plain B4 {plain_ms:.3f} ms)")

    # one B4 layer's backward through the kernel against the CPU's
    rs = np.random.RandomState(6)
    x, w, b = (rs.randn(*shape).astype(np.float32) * sc for shape, sc in
               (((1, 4, 5, 6, 4, 4), 1.0), ((3, 3, 3, 3, 4, 3), 0.1), ((3,), 1.0)))
    g = torch.from_numpy(rs.randn(1, 4, 5, 6, 4, 3).astype(np.float32))
    grads = []
    for d in ("cpu", dev):
        ts = [torch.from_numpy(a).to(d).requires_grad_() for a in (x, w, b)]
        conv4d_small(*ts).backward(g.to(d))
        grads.append([t.grad.cpu() for t in ts])
    berr = max((a - c).abs().max().item() for a, c in zip(grads[1], grads[0]))
    for a, c, name in zip(grads[1], grads[0], ("dx", "dw", "db")):
        if ((a - c).abs() > 1e-4 + 1e-5 * c.abs()).any():
            fail(f"conv4d_small backward: {name} differs from the CPU's (max {berr})")
    log(f"conv4d_small backward [(1, 4, 5, 6, 4, 4) f32, 4->3]: dx, dw, db against "
        f"the CPU autograd, max abs err {berr:.3g}")

    # one bf16 4->4 layer's backward (plain PyTorch) at the change_stride shape
    x = torch.randn(dims + (4,), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((3, 3, 3, 3, 4, 4), generator=gen, device=dev) / 18
    b = torch.randn((4,), generator=gen, device=dev) * 0.1
    x.requires_grad_()
    w.requires_grad_()
    b.requires_grad_()
    y = conv4d_small(x, w, b, torch.bfloat16)
    g = torch.randn(y.shape, generator=gen, device=dev).to(torch.bfloat16)
    bwd_ms = time_ms(lambda: torch.autograd.grad(y, (x, w, b), g, retain_graph=True),
                     iters=3, warmup=1)
    log(f"conv4d_small backward [{tuple(x.shape)} bf16, 4->4]: plain PyTorch (per-tap "
        f"convs for dx, 81 contractions for dw), {bwd_ms:.4f} ms per call")
    return launches


def fine_head_path(dev):
    """Phase 6: the fine stage of a full-width FeatRegressNet with the
    seeded ``regress_fine`` weights, fused and unfused. Rules: float32
    pooled features within rtol/atol 2e-4 of each other; in bf16, against
    the float32 unfused outputs on the same rows, the fused (M, 5) error
    is at most twice the unfused one's at the median and the 99th
    percentile, and at most four times at the maximum."""
    _, _, sd = load_golden("cs_1024")
    sub = {k[len("regress_fine."):]: torch.from_numpy(np.asarray(v))
           for k, v in sd.items() if k.startswith("regress_fine.")}
    nets = {}
    for dt in (torch.bfloat16, torch.float32):
        nets[dt] = FeatRegressNet(feat_dim=sum(c for _, c in LEVELS), dtype=dt, device=dev)
        nets[dt].load_state_dict(sub)
        nets[dt].eval()
    m = BATCH * FINE_CAP
    rs = np.random.RandomState(7)
    rows = [[torch.from_numpy(rs.standard_normal((m, 4, t, t * c)).astype(np.float32))
             .to(dev, torch.bfloat16) for t, c in LEVELS] for _ in range(2)]
    corners = [torch.from_numpy(rs.randint(0, 2 * PSIZE, (m,)).astype(np.int32)).to(dev)
               for _ in range(4)]
    smap = output_slice_map([PSIZE // t for t, _ in LEVELS], [c for _, c in LEVELS], PSIZE)

    def fused(dt):
        r = [[x.to(dt) for x in side] for side in rows]
        return fused_fine_stage(nets[dt], r[0], r[1], *corners, PSIZE)

    def unfused(dt):
        r = [[x.to(dt) for x in side] for side in rows]
        patches = expand_scale_pair(r[0], r[1], *corners, PSIZE, dt)
        pooled = nets[dt].pooled(patches, None, slice_map=smap)
        return pooled, nets[dt].fc_head(pooled)

    with torch.no_grad():
        torch.cuda.synchronize()
        reset_counts()
        fp, fo = fused(torch.bfloat16)
        torch.cuda.synchronize()
        launches = counts()
        reset_counts()
        up, uo = unfused(torch.bfloat16)
        torch.cuda.synchronize()
        unfused_launches = counts()
        fp32, fo32 = fused(torch.float32)
        up32, uo32 = unfused(torch.float32)
        torch.cuda.synchronize()
    expect = {**{k: 0 for k in launches}, "expand_level": 10, "fused_fine_head": 1}
    expect_u = {**{k: 0 for k in launches}, "expand_scale_pair": 1}
    if launches != expect or unfused_launches != expect_u:
        fail(f"fine-head path launches {launches} / {unfused_launches}, expected "
             f"{expect} / {expect_u}")
    for name, t in (("fused", fo), ("unfused", uo), ("fused f32", fo32)):
        if t.shape != (m, 5) or not torch.isfinite(t).all():
            fail(f"fine-head path: {name} outputs {tuple(t.shape)} or non-finite")
    bad = (fp32 - up32).abs() > 2e-4 + 2e-4 * up32.abs()
    if bad.any():
        fail(f"fine-head path f32: {int(bad.sum())} pooled values beyond rtol/atol 2e-4 "
             f"(max abs err {(fp32 - up32).abs().max().item()})")
    e_f, e_u = (fo.float() - uo32).abs().flatten(), (uo.float() - uo32).abs().flatten()
    stats = {}
    for name, q in (("median", 0.5), ("p99", 0.99), ("max", 1.0)):
        stats[name] = (torch.quantile(e_f, q).item(), torch.quantile(e_u, q).item())
    limits = {"median": 2, "p99": 2, "max": 4}
    for name, (a, b) in stats.items():
        if not a <= limits[name] * b:
            fail(f"fine-head path bf16: fused {name} error {a} > {limits[name]} x unfused {b}")
    # the fused stage's split: prolog (B7 + cuDNN image-level conv0 + the
    # weights' layouts), B5, fc_head
    with torch.no_grad():
        ms_f = time_ms(lambda: fused(torch.bfloat16), iters=5)
        ms_u = time_ms(lambda: unfused(torch.bfloat16), iters=5)
        hargs = head_args(nets[torch.bfloat16], *rows, *corners, PSIZE)
        split = (time_ms(lambda: head_args(nets[torch.bfloat16], *rows, *corners, PSIZE),
                         iters=5),
                 time_ms(lambda: fused_fine_head(*hargs), iters=5),
                 time_ms(lambda: nets[torch.bfloat16].fc_head(fp), iters=5))
        # the prolog's own B7 calls, each held bit for bit and timed
        with capture_inputs(((fine_stage_module, "expand_level"),)) as captured:
            head_args(nets[torch.bfloat16], *rows, *corners, PSIZE)
        if len(captured["expand_level"]) != 10:
            fail(f"fine-head path: the prolog made {len(captured['expand_level'])} B7 calls, "
                 f"expected 10")
        b7_ms, b7_plain_ms = hold_path_calls("fine-head prolog", captured, None,
                                             time_all=True)["expand_level"]
        # one prolog under the profiler: its kernels' device time, B7's part
        prolog_dev = device_ms(lambda: head_args(nets[torch.bfloat16], *rows, *corners, PSIZE))
        b7_dev = sum(v for k, v in prolog_dev.items() if "expand_level_kernel" in k)
    log(f"fine-head path [M={m}, F={F_REG}, bf16]: launches fused {launches}, unfused "
        f"{unfused_launches}; f32 pooled fused vs unfused max abs err "
        f"{(fp32 - up32).abs().max().item():.3g}, (M, 5) {(fo32 - uo32).abs().max().item():.3g}; "
        f"bf16 (M, 5) error to the f32 unfused outputs, fused / unfused: "
        + ", ".join(f"{k} {a:.4g} / {b:.4g}" for k, (a, b) in stats.items())
        + f"; fused - unfused bf16 max {(fo.float() - uo.float()).abs().max().item():.4g}; "
        f"{ms_f:.3f} ms per call fused (prolog {split[0]:.3f} + B5 {split[1]:.3f} + fc_head "
        f"{split[2]:.3f}), {ms_u:.3f} ms unfused (B3 + forward); the prolog's 10 B7 calls, "
        f"each torch.equal to the plain version, {b7_ms:.4f} ms summed (plain "
        f"{b7_plain_ms:.4f}); one prolog's device time (profiler) {sum(prolog_dev.values()):.4f} "
        f"ms, of which B7 x10 {b7_dev:.4f}; its top device kernels: "
        + "; ".join(f"{k[:60]} {v:.4f}" for k, v in
                    sorted(prolog_dev.items(), key=lambda kv: -kv[1])[:6]))
    return launches


# ------------------------------------------------------------ phase 7-9

# the reference training setting: ResNet34 change_stride, 480x320, batch 4
TRAIN_H, TRAIN_W, TRAIN_BATCH, PTMAX = 320, 480, 4, 400
BACKWARDS = (tap_sum_backward, corr_pool_backward, expand_scale_pair_backward)


def backward_calls():
    return {fn.__name__: fn.calls for fn in BACKWARDS}


def calls_since(before):
    return {k: v - before[k] for k, v in backward_calls().items()}


class capture_inputs:
    """Within the block, the port's calls of the kernels at ``sites``
    ((module, wrapper name) pairs; by default B1, B2 and B3 on the
    training paths) go through shims that keep each call's arguments
    (tensors detached) and then call the wrapper, whose launch count rises
    as before. ``as`` gives ``{kernel name: [args of each call]}``."""

    SITES = ((conv4d_module, "tap_sum"), (patch2pix_module, "corr_pool"),
             (patch_gather_module, "expand_scale_pair"))

    def __init__(self, sites=SITES, keep=None):
        self.sites = sites
        self.keep = keep  # keep the first ``keep`` calls of each kernel (all: None)

    def __enter__(self):
        self.saved = [getattr(mod, name) for mod, name in self.sites]
        self.calls = {name: [] for _, name in self.sites}
        for (mod, name), fn in zip(self.sites, self.saved):
            setattr(mod, name, self.shim(fn, self.calls[name], self.keep))
        return self.calls

    @staticmethod
    def shim(fn, calls, keep):
        def detach(a):
            if isinstance(a, torch.Tensor):
                return a.detach()
            return type(a)(x.detach() for x in a) if isinstance(a, (list, tuple)) else a

        def call(*args):
            if keep is None or len(calls) < keep:
                calls.append(tuple(detach(a) for a in args))
            return fn(*args)
        return call

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.sites, self.saved):
            setattr(mod, name, fn)


def hold_expand_level(tag, rows, y0, x0, psize):
    """B7's rule: ``torch.equal`` to the plain version. Returns (out, max
    abs err)."""
    got = expand_level(rows, y0, x0, psize)
    if not torch.equal(got, expand_level_plain(rows, y0, x0, psize)):
        fail(f"{tag}: not bit-identical")
    return got, 0.0


# kernel name -> (wrapper, plain version, forward rule, backward check or
# None where the kernel has no backward)
PATH_HOLDS = {
    "tap_sum": (tap_sum, tap_sum_plain, hold_tap_sum, backward_tap_sum),
    "corr_pool": (corr_pool, corr_pool_plain, hold_corr_pool, backward_corr_pool),
    "expand_scale_pair": (expand_scale_pair, expand_scale_pair_plain, hold_expand,
                          backward_expand),
    "expand_level": (expand_level, expand_level_plain, hold_expand_level, None),
}


def hold_path_calls(tag, captured, gen, time_all=False):
    """Phase 2's checks at a path's own shapes: every captured call held
    against its plain version by phase 2's rule; the first call of each
    kernel (every call with ``time_all``) also timed beside its plain
    version, and the first put through both backward routes
    (``torch.equal``) where the kernel has a backward, its backward timed.
    Frees each call's inputs once held. Returns {kernel name: (summed ms,
    summed plain ms) of the timed calls}."""
    sums = {}
    for name, calls in captured.items():
        kernel, plain, hold, backward = PATH_HOLDS[name]
        sums[name] = (0.0, 0.0)
        for i, args in enumerate(calls):
            err, *note = hold(f"{tag} {name} call {i}", *args)[1:]
            shapes = [tuple(a.shape) if isinstance(a, torch.Tensor) else
                      [tuple(x.shape) for x in a] for a in args[:2]]
            dtype = args[-1] if name == "expand_scale_pair" else args[0].dtype
            msg = (f"{tag} hold {name} call {i} {shapes} {dtype}{''.join(note)}: "
                   f"max_abs_err {err:.3g}")
            if i == 0 or time_all:
                ms = time_ms(lambda: kernel(*args), iters=5)
                plain_ms = time_ms(lambda: plain(*args), iters=3, warmup=1)
                sums[name] = (sums[name][0] + ms, sums[name][1] + plain_ms)
                msg += f"; ms {ms:.4f} plain_ms {plain_ms:.4f}"
            if i == 0 and backward is not None:
                same, bwd_ms, shape = backward(gen, *args)
                if not same:
                    fail(f"{tag} {name} backward: the kernel route's gradients are not "
                         f"torch.equal to the plain route's")
                msg += (f"; backward {shape}: kernel route torch.equal to the plain route, "
                        f"{bwd_ms:.4f} ms per call")
            log(msg)
            calls[i] = args = None
            torch.cuda.empty_cache()
    return sums


def seeded_model(sd, dtype, dev, change_stride=True, panc=8):
    cfg = ModelConfig(change_stride=change_stride, dtype=dtype).resolved()
    cfg.regressor.panc = panc
    model = Patch2Pix(cfg, device=dev)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    return model


def check_updates(tag, model, before, frozen_prefixes, stats_prefixes=("regress_",)):
    """Frozen parameters, and trainable ones the loss does not reach (no
    gradient: layer3 feeds only the arg-max matching, layer4 never runs),
    bit-identical; every parameter with a gradient, and the running
    averages under ``stats_prefixes``, moved. Returns the counts."""
    now = model.state_dict()
    n_same = n_moved = 0
    for k, p in model.named_parameters():
        same = torch.equal(now[k], before[k])
        if k.startswith(frozen_prefixes) or p.grad is None:
            if not same:
                fail(f"{tag}: {k} changed without a gradient")
            n_same += 1
        else:
            if same:
                fail(f"{tag}: trainable parameter {k} did not move")
            n_moved += 1
    stats = [k for k in now if "running" in k and k.startswith(stats_prefixes)]
    for k in stats:
        if torch.equal(now[k], before[k]):
            fail(f"{tag}: running average {k} did not move")
    return n_same, n_moved, len(stats)


def check_finite(tag, metrics):
    for i, met in enumerate(metrics):
        bad = [k for k, v in met.items() if not torch.isfinite(v).all()]
        if bad:
            fail(f"{tag}: step {i} has non-finite metrics {bad}")


def train_batches(dev, n=2, seed=0):
    rs = np.random.RandomState(seed)
    return [{k: torch.from_numpy(v).to(dev)
             for k, v in synthetic_batch(rs, TRAIN_BATCH, TRAIN_H, TRAIN_W).items()}
            for _ in range(n)]


def train_run(tag, dev, sd, dtype, batches, freeze=("extract", "ncn"), warmup=3, timed=10,
              profile=False):
    """Patch2Pix train steps at the reference training setting: warm-up
    steps, one step whose launches and backward calls are counted and
    whose B1 and B3 calls are then held against the plain versions
    (:func:`hold_path_calls`), then ``timed`` steps each waited for (and,
    with ``profile``, 3 more under torch.profiler). Returns a dict:
    ``times`` (ms), ``peak_gb``,
    ``launches``, ``calls``, ``loss`` (the last step's) and
    ``updates`` (:func:`check_updates`, with ``freeze`` frozen)."""
    model = seeded_model(sd, dtype, dev)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, OptimConfig(lr_init=5e-4), freeze=freeze)
    step = make_train_step(model, state.optimizer, ksize=2, ptmax=PTMAX, remat="auto")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    metrics = []

    def one():
        nonlocal state
        state, met = step(state, batches[len(metrics) % len(batches)], gen)
        metrics.append(met)

    for _ in range(warmup):
        one()
    torch.cuda.synchronize()
    reset_counts()
    calls0 = backward_calls()
    with capture_inputs() as captured:
        one()
    torch.cuda.synchronize()
    out = dict(launches={k: v for k, v in counts().items() if v}, calls=calls_since(calls0))
    hold_path_calls(tag, captured, torch.Generator(device=dev).manual_seed(1))
    del captured
    torch.cuda.reset_peak_memory_stats()
    out["times"] = []
    for _ in range(timed):
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        out["times"].append((time.perf_counter() - t0) * 1e3)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if profile:
        profile_main_path(tag, one)
    check_finite(tag, metrics)
    out["loss"] = float(metrics[-1]["loss/pair"])
    out["updates"] = check_updates(tag, model, before, tuple(f"{p}." for p in freeze))
    return out


def train_path(dev, sd):
    """Phase 7: the Patch2Pix train step, bf16 then f32 (TF32 off), 3
    warm-up and 10 timed steps each, then one step with ``freeze=()``."""
    batches = train_batches(dev)
    remat = resolve_remat("auto", TRAIN_BATCH, PTMAX, 8)
    medians = {}
    for dtype in ("bfloat16", "float32"):
        tag = f"train [{dtype}]"
        r = train_run(tag, dev, sd, dtype, batches, profile=True)
        if not (r["launches"].get("tap_sum", 0) > 0
                and r["launches"].get("expand_scale_pair", 0) > 0):
            fail(f"{tag}: B1 and B3 must launch in a step: {r['launches']}")
        times = r["times"]
        medians[dtype] = float(np.median(times))
        n_same, n_moved, n_stats = r["updates"]
        log(f"{tag} [ResNet34 change_stride {TRAIN_W}x{TRAIN_H} B={TRAIN_BATCH} "
            f"ptmax={PTMAX} panc=8 ksize 2, Adam 5e-4, freeze extract+ncn, remat auto = "
            f"{remat}]: ms/step median {float(np.median(times)):.2f} (min {min(times):.2f}, "
            f"max {max(times):.2f}) over {len(times)} steps; "
            f"{TRAIN_BATCH * len(times) / (sum(times) / 1e3):.2f} training pairs/s; peak "
            f"device memory {r['peak_gb']:.2f} GB; launches per step {r['launches']}; "
            f"backward calls per step {r['calls']}; last loss {r['loss']:.5g}; {n_same} "
            f"frozen tensors bit-identical, {n_moved} trained tensors and {n_stats} running "
            f"averages moved")
        torch.cuda.empty_cache()

    # one step with nothing frozen: the backbone needs the patch rows'
    # gradient, so B3's backward runs
    tag = "train [bfloat16, freeze=()]"
    r = train_run(tag, dev, sd, "bfloat16", batches, freeze=(), warmup=1, timed=1)
    if r["calls"]["expand_scale_pair_backward"] == 0:
        fail(f"{tag}: B3's backward did not run: {r['calls']}")
    n_same, n_moved, _ = r["updates"]
    log(f"{tag}: ms/step {r['times'][0]:.2f} (after one warm-up step); peak device memory "
        f"{r['peak_gb']:.2f} GB; launches per step {r['launches']}; backward calls per step "
        f"{r['calls']}; {n_moved} tensors moved, {n_same} without a gradient (the NCN, "
        f"layer3, layer4) bit-identical")
    torch.cuda.empty_cache()
    return medians


def train_golden(dev):
    """Phase 8: the f32 training forward (panc 8 anchors, both stages over
    every coarse row) against ``pipeline_golden_train_panc8.npz``,
    composed as ``tests/test_pipeline_e2e_parity.py`` does: anchors
    within 1e-3, coords 0.05 px, scores 5e-3."""
    g, meta, sd = load_golden("train_panc8")
    model = seeded_model(sd, "float32", dev, meta["change_stride"], meta["panc"])
    r = model.config.regressor
    ims = [torch.from_numpy(seeded_images(meta["batch"], meta["h"], meta["w"],
                                          meta["im_seed"] + i)).to(dev) for i in (0, 1)]
    reset_counts()
    with torch.no_grad():
        feats1, feats2 = model.extract_pyramid_pair(*ims)
        corr, delta4d = model.coarse_corr(feats1[-1], feats2[-1], 2)
        cm = model.coarse_matches(corr, delta4d, 2, mutual=True, ncn_thres=0.0)
        anchors = shift_to_anchors(cm.coords, r.pshift, r.panc)
        tiles1, tiles2 = model._shared_tiles(feats1, feats2)
        midm, midp = model.fine_match(feats1, feats2, anchors, "mid", tiles1=tiles1,
                                      tiles2=tiles2)
        finem, finep = model.fine_match(feats1, feats2, midm, "fine", tiles1=tiles1,
                                        tiles2=tiles2)
    torch.cuda.synchronize()
    launches = {k: v for k, v in counts().items() if v}
    if launches.get("expand_scale_pair", 0) != 2:
        fail(f"train golden: B3 must run in both stages: {launches}")
    errs = {}
    for name, got, tol in (("coarse", anchors, 1e-3), ("mid", midm, 0.05),
                           ("mid_scores", midp, 5e-3), ("fine", finem, 0.05),
                           ("fine_scores", finep, 5e-3)):
        errs[name] = float(np.abs(got[0].cpu().numpy() - g[f"{name}_0"]).max())
        if not errs[name] <= tol:
            fail(f"train golden: {name} err {errs[name]} > {tol}")
    log(f"golden train_panc8 [{meta['h']}x{meta['w']} f32, M={anchors.shape[1]}]: max errs "
        + " ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f"; launches {launches}")


def ncn_pretrain_path(dev, sd):
    """Phase 9: NCN pretraining at 1024x768, change_stride, ksize 2, bf16,
    one (src, pos, neg) triplet: 2 warm-up and 5 timed steps (B1 and B2
    forward, B1's backward; only the NCN moves), then one more step whose
    B1 and B2 calls are held against the plain versions."""
    rs = np.random.RandomState(4)
    pos = synthetic_batch(rs, 1, H, W)
    neg = synthetic_batch(rs, 1, H, W)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             (("im_src", pos["im1"]), ("im_pos", pos["im2"]), ("im_neg", neg["im1"]))}
    model = seeded_model(sd, "bfloat16", dev)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    step, init = make_ncn_pretrain_step(model, lr=5e-4, ksize=2)
    opt = init()
    metrics = [step(opt, batch) for _ in range(2)]
    torch.cuda.synchronize()
    reset_counts()
    calls0 = backward_calls()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        metrics.append(step(opt, batch))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: v / 5 for k, v in counts().items() if v}
    calls = {k: v / 5 for k, v in calls_since(calls0).items()}
    if not (launches.get("tap_sum", 0) > 0 and launches.get("corr_pool", 0) > 0
            and calls["tap_sum_backward"] > 0):
        fail(f"ncn pretrain: B1 and B2 must launch and B1's backward run: {launches}, {calls}")
    with capture_inputs() as captured:
        metrics.append(step(opt, batch))
    torch.cuda.synchronize()
    check_finite("ncn pretrain", metrics)
    # only the NCN moves
    check_updates("ncn pretrain", model, before, ("extract.", "regress_"), stats_prefixes=())
    del model, before, opt
    torch.cuda.empty_cache()
    log(f"ncn pretrain [change_stride {W}x{H} ksize 2 bf16, one triplet, Adam 5e-4, "
        f"backbone frozen]: ms/step median {float(np.median(times)):.2f} (min "
        f"{min(times):.2f}, max {max(times):.2f}) over 5 steps; peak device memory "
        f"{peak_gb:.2f} GB; launches per step {launches}; backward calls per step {calls}; "
        f"loss {float(metrics[0]['loss/nc']):.5g} -> {float(metrics[-1]['loss/nc']):.5g}")
    hold_path_calls("ncn pretrain", captured, torch.Generator(device=dev).manual_seed(2))


# ------------------------------------------------------------ phase 10

CLI_DIR = os.path.join(ROOT, "build", "chip_smoke_cli")
CLI_PAIRS, CLI_STEPS = 12, 3


class record_metrics:
    """Within the block, every metrics dict the CLI's ``MetricsWriter``
    queues is also kept (``as`` gives the list), so that a non-finite
    loss, which the writer's means drop, still fails the phase."""

    def __enter__(self):
        self.saved = logging_module.MetricsWriter.append
        self.kept = []
        saved, kept = self.saved, self.kept

        def append(writer, metrics):
            kept.append(dict(metrics))
            saved(writer, metrics)
        logging_module.MetricsWriter.append = append
        return kept

    def __exit__(self, *exc):
        logging_module.MetricsWriter.append = self.saved


class time_cli_epochs:
    """Within the block, each epoch of ``train.cli.main`` is split (``as``
    gives the list, one dict per epoch): ``wait_ms``, host time from the
    epoch's ``prefetch_to_device`` to its first step (the first batch's
    decode and copy); ``step_ms``, device time from each step's start to
    the next one's (CUDA events on the step's stream, so a step the
    loader held back shows its gap); ``flush_ms``, host time of the
    epoch's ``MetricsWriter.flush`` (the drain, which waits for the
    epoch's queued device work)."""

    def __enter__(self):
        self.saved = (train_cli.prefetch_to_device, train_cli.make_train_step,
                      logging_module.MetricsWriter.flush)
        prefetch, make_step, flush = self.saved
        epochs = self.epochs = []

        def timed_prefetch(*args, **kw):
            epochs.append({"t0": time.perf_counter(), "events": []})
            return prefetch(*args, **kw)

        def timed_make_step(*args, **kw):
            step = make_step(*args, **kw)

            def timed_step(state, batch, **kw):
                epoch = epochs[-1]
                if not epoch["events"]:
                    epoch["wait_ms"] = (time.perf_counter() - epoch["t0"]) * 1e3
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                out = step(state, batch, **kw)
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                epoch["events"].append((start, end))
                return out
            return timed_step

        def timed_flush(writer, *args, **kw):
            t0 = time.perf_counter()
            out = flush(writer, *args, **kw)
            epochs[-1]["flush_ms"] = (time.perf_counter() - t0) * 1e3
            return out

        train_cli.prefetch_to_device = timed_prefetch
        train_cli.make_train_step = timed_make_step
        logging_module.MetricsWriter.flush = timed_flush
        return epochs

    def __exit__(self, *exc):
        (train_cli.prefetch_to_device, train_cli.make_train_step,
         logging_module.MetricsWriter.flush) = self.saved
        torch.cuda.synchronize()
        for epoch in self.epochs:
            ev = epoch.pop("events")
            ends = [s for s, _ in ev[1:]] + [ev[-1][1]]
            epoch["step_ms"] = [s.elapsed_time(e) for (s, _), e in zip(ev, ends)]
            del epoch["t0"]


def split_line(epochs):
    """One epoch split of :class:`time_cli_epochs` as text."""
    return "; ".join(
        f"epoch {i + 1}: first-batch wait {e['wait_ms']:.2f} ms, device ms per step "
        + " ".join(f"{t:.2f}" for t in e["step_ms"]) + f", flush {e['flush_ms']:.2f} ms"
        for i, e in enumerate(epochs))


def cli_argv(fixture, out_dir, epochs, *extra):
    data_root, pair_root, npy, _ = fixture
    return ["--data_root", data_root, "--pair_root", pair_root, "--match_npy", npy,
            "--out_dir", out_dir, "--change_stride", "--batch", str(TRAIN_BATCH), "--ptmax",
            str(PTMAX), "--ksize", "2", "--dtype", "bfloat16", "--no_eval", "--epochs",
            str(epochs), "--steps_per_epoch", str(CLI_STEPS), *extra]


def epoch_seconds(run_dir):
    """{epoch: seconds} from the CLI's log (its ``>Epoch:N time:Xs`` lines)."""
    with open(os.path.join(run_dir, "log.txt")) as f:
        return {int(m.group(1)): float(m.group(2))
                for m in re.finditer(r">Epoch:(\d+) time:([0-9.]+)s", f.read())}


def checkpoint_model(run_dir, tag="last"):
    return torch.load(os.path.join(run_dir, f"{tag}.pt"), map_location="cpu",
                      weights_only=True)


def cli_path(dev, sd, train_ms):
    """Phase 10: the training entry point (module docstring)."""
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    fixture = write_megadepth_fixture(os.path.join(CLI_DIR, "fixture"), CLI_PAIRS, TRAIN_H,
                                      TRAIN_W, seed=0)
    pth = os.path.join(CLI_DIR, "seeded.pth")
    pre = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    torch.save({"state_dict": pre}, pth)
    out = os.path.join(CLI_DIR, "out")

    # 2 epochs x 3 steps, B1-B3 counted from zero, their first calls kept
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with capture_inputs(keep=1) as captured, record_metrics() as metrics, \
            time_cli_epochs() as split:
        run = train_cli.main(cli_argv(fixture, out, 2, "--pretrain", pth))
    torch.cuda.synchronize()
    peak_gb = logging_module.get_device_mem()[f"cuda:{dev.index or 0}"]["peak_bytes_in_use"]
    launches = {k: v for k, v in counts().items() if v}
    if not all(launches.get(k, 0) > 0 for k in ("tap_sum", "corr_pool", "expand_scale_pair")):
        fail(f"cli: B1, B2 and B3 must launch under the CLI: {launches}")
    hold_path_calls("cli", captured, torch.Generator(device=dev).manual_seed(3))
    del captured

    # a third epoch from the checkpoint
    with record_metrics() as more:
        if train_cli.main(cli_argv(fixture, out, 3, "--pretrain", pth, "--resume")) != run:
            fail("cli: --resume wrote another run directory")
    check_finite("cli", metrics + more)
    meta = read_meta(run)
    steps = {tag: checkpoint_model(run, tag)["step"] for tag in ("ep2", "last")}
    if meta["epoch"] != 2 or steps != {"ep2": 2 * CLI_STEPS, "last": 3 * CLI_STEPS}:
        fail(f"cli: resumed run at epoch {meta['epoch']}, steps {steps}")
    last = checkpoint_model(run)["model"]
    frozen = [k for k in pre if k.startswith(("extract.", "ncn."))]
    changed = [k for k in frozen if not torch.equal(last[k], pre[k])]
    trained = [k for k in pre if k.startswith("regress_") and "num_batches" not in k]
    unmoved = [k for k in trained if torch.equal(last[k], pre[k])]
    if changed or unmoved:
        fail(f"cli: frozen tensors changed {changed}; regressor tensors unmoved {unmoved}")
    ms_step = {e: t * 1e3 / CLI_STEPS for e, t in epoch_seconds(run).items()}
    steady = [t for e in split for t in e["step_ms"][1:]]
    log(f"cli [train.cli.main, ResNet34 change_stride {TRAIN_W}x{TRAIN_H} B={TRAIN_BATCH} "
        f"ptmax={PTMAX} panc=8 ksize 2 bf16, --pretrain, {CLI_PAIRS} PNG pairs, "
        f"{CLI_STEPS} steps/epoch]: epochs 1-2, then --resume epoch 3: ms/step (epoch time / "
        f"steps, loader, prefetch, logging and the per-epoch drain included) "
        + ", ".join(f"epoch {e} {v:.2f}" for e, v in sorted(ms_step.items()))
        + f"; split of epochs 1-2: {split_line(split)}; steps 2-{CLI_STEPS} mean "
        f"{sum(steady) / len(steady):.2f} device ms/step"
        + f"; phase 7's synchronised bf16 step {train_ms:.2f} ms; peak device memory "
        f"{peak_gb:.2f} GB (epochs 1-2); launches in epochs 1-2 {launches}; meta epoch "
        f"{meta['epoch']}, steps {steps}; {len(frozen)} frozen tensors bit-identical to the "
        f".pth, {len(trained)} regressor tensors (running averages included) moved; losses "
        f"finite over {len(metrics + more)} steps")

    # checkpoint bytes, save and restore
    cfg = model_config_from_json(json.dumps(meta["model_config"]))
    model = Patch2Pix(cfg, device=dev)
    state = create_train_state(model, OptimConfig(), freeze=("extract", "ncn"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = load_ckpt(run, state)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    timing_dir = os.path.join(CLI_DIR, "timing")
    t0 = time.perf_counter()
    save_ckpt(timing_dir, state, cfg, meta["epoch"])
    save_ms = (time.perf_counter() - t0) * 1e3
    ckpt_bytes = os.path.getsize(os.path.join(timing_dir, "last.pt"))

    # the matcher from the run directory
    matcher = init_patch2pix_matcher(run)
    got = matcher.model.state_dict()
    bad = [k for k, v in state.model.state_dict().items() if not torch.equal(got[k], v)]
    if bad or matcher.model.config.regressor.panc != 1:
        fail(f"cli: the matcher's weights differ from load_ckpt's: {bad}")
    del model, state
    png = os.path.join(fixture[0], "MegaDepth_undistort", "0000")
    png1, png2 = (os.path.join(png, f"pair000_{i}.png") for i in (1, 2))
    fm, fs, cm = estimate_matches(matcher.model, png1, png2, device=dev)
    if not (len(fm) > 0 and fm.shape[1:] == (4,) and np.isfinite(fm).all()
            and np.isfinite(fs).all()):
        fail(f"cli: estimate_matches from the run directory gave {fm.shape}")
    if not all(np.array_equal(a, b) for a, b in zip((fm, fs, cm),
                                                     matcher.estimate_matches(png1, png2))):
        fail("cli: estimate_matches(model, ...) differs from the matcher's estimate_matches")
    del matcher
    torch.cuda.empty_cache()
    log(f"cli checkpoint [{cfg.dtype}]: last.pt {ckpt_bytes} bytes; save_ckpt {save_ms:.1f} "
        f"ms, load_ckpt {restore_ms:.1f} ms; init_patch2pix_matcher(run dir) weights "
        f"torch.equal to load_ckpt's; estimate_matches(model, png1, png2) on a fixture pair: "
        f"{len(fm)} matches, equal to the matcher's method")

    # feat_comb post + backbone_train_bn, from a post-shaped seeded .pth
    cfg_post = ModelConfig(change_stride=True, dtype="bfloat16").resolved()
    cfg_post.regressor.feat_comb = "post"
    shapes = {k: tuple(v.shape) for k, v in Patch2Pix(cfg_post, device=dev).state_dict().items()}
    pre_post = {k: torch.from_numpy(np.asarray(v))
                for k, v in seeded_state_dict(shapes, seed=0).items()}
    pth_post = os.path.join(CLI_DIR, "seeded_post.pth")
    torch.save({"state_dict": pre_post}, pth_post)
    torch.cuda.synchronize()
    reset_counts()
    with record_metrics() as post_metrics:
        run_post = train_cli.main(cli_argv(fixture, os.path.join(CLI_DIR, "out_post"), 1,
                                           "--pretrain", pth_post, "--feat_comb", "post",
                                           "--backbone_train_bn", "--steps_per_epoch", "2"))
    torch.cuda.synchronize()
    post_launches = {k: v for k, v in counts().items() if v}
    if not all(post_launches.get(k, 0) > 0
               for k in ("tap_sum", "corr_pool", "expand_scale_pair")):
        fail(f"cli post + backbone_train_bn: B1-B3 must launch: {post_launches}")
    check_finite("cli post + backbone_train_bn", post_metrics)
    last = checkpoint_model(run_post)["model"]
    backbone = [k for k in pre_post if k.startswith("extract.") and ".layer4." not in k
                and "num_batches" not in k]
    wrong = [k for k in backbone if torch.equal(last[k], pre_post[k]) == ("running" in k)]
    if wrong:
        fail(f"cli post + backbone_train_bn: backbone running averages must move and its "
             f"weights stay: {wrong}")
    post_ms = epoch_seconds(run_post)[1] * 1e3 / 2
    log(f"cli [--feat_comb post --backbone_train_bn, otherwise as above, 1 epoch x 2 steps]: "
        f"ms/step {post_ms:.2f} (epoch time / steps); launches {post_launches}; "
        f"{sum('running' in k for k in backbone)} backbone running averages moved, "
        f"{sum('running' not in k for k in backbone)} backbone weights bit-identical")

    # one epoch with the per-epoch immatch validation, on 2 fixture pairs at 1024x768
    write_val_dense_fixture(os.path.join(fixture[0], "immatch_benchmark", "val_dense"), 2, H,
                            W, seed=1)
    argv = cli_argv(fixture, os.path.join(CLI_DIR, "out_eval"), 1, "--pretrain", pth,
                    "--steps_per_epoch", "2")
    argv.remove("--no_eval")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    run_eval = train_cli.main(argv)
    eval_s = time.perf_counter() - t0
    eval_launches = {k: v for k, v in counts().items() if v}
    with open(os.path.join(run_eval, "log.txt")) as f:
        text = f.read()
    pairs = re.search(r"Pairs 2 match_failed=0 geo_failed=0 .* time:([0-9.]+)s", text)
    if ("Failed to eval immatch" in text or "Pose err: qt_mean=" not in text or pairs is None
            or not os.path.exists(os.path.join(run_eval, "immatch_best.pt"))):
        fail("cli with validation: no 'Pose err:' line, a failed pair, 'Failed to eval "
             "immatch', or no immatch_best checkpoint:\n" + text[-2000:])
    log(f"cli with the per-epoch validation [1 epoch x 2 steps as above, then the immatch "
        f"protocol on 2 pairs at {W}x{H}]: {eval_s:.1f} s in all, the protocol "
        f"{float(pairs.group(1)):.2f} s; no failed pair, no 'Failed to eval immatch', "
        f"immatch_best written (best_vals {read_meta(run_eval, 'immatch_best')['best_vals']}); "
        f"launches {eval_launches}")
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    return launches


# ------------------------------------------------------------ phase 11/12

IMMATCH_GOLDEN = os.path.join(FIXDIR, "immatch_golden_vgg_1024.npz")
TIE_REL = 1e-4  # a golden row may differ where its top-2 margin is below this x max |volume|


def in_grid(grid, h, w):
    """Grid rows (x, y, x, y) inside an h x w feature grid."""
    lims = torch.tensor([w, h, w, h], device=grid.device)
    return bool(((grid >= 0) & (grid < lims)).all())


def outside_inference(captured):
    """Captured calls of an inference-mode run with every tensor cloned
    outside it, so the backward checks can take their gradients."""
    def clone(a):
        if isinstance(a, torch.Tensor):
            return a.clone()
        return type(a)(x.clone() for x in a) if isinstance(a, (list, tuple)) else a
    return {k: [tuple(clone(a) for a in args) for args in calls] for k, calls in captured.items()}


def immatch_model(meta, sd, dtype, dev, reloc=0):
    model = ImMatchNet(meta["feature_extraction_cnn"], ncons_kernel_sizes=meta["ncons_kernel_sizes"],
                       ncons_channels=meta["ncons_channels"], relocalization_k_size=reloc,
                       dtype=dtype, device=dev)
    load_ncnet_checkpoint(model, sd)
    return model


def immatch_path(dev):
    """Phase 11: ImMatchNet, the reference's default (VGG16 to pool4, NCN
    (3, 3, 3)/(10, 10, 1) symmetric, normalised features), seeded weights
    (the golden's ``meta``) and images, 1024x768, B = 1. bf16: forward +
    ``corr_to_matches`` (mutual) timed, B1's launches per call (2) and
    its first call held against its plain version, the profiler's table;
    relocalisation k = 2 (``maxpool4d``, ``corr_to_matches`` with the
    offsets, equal to the pre-pool volume's relocation, and
    ``corr_to_matches_topk(topk=2)``, grids inside the pre-pool grid).
    float32: ``immatch_golden_vgg_1024.npz``, grids identical but at rows
    whose top-2 margin is below ``TIE_REL`` of max |volume| (a score
    tie), scores within 5e-3."""
    g = np.load(IMMATCH_GOLDEN, allow_pickle=True)
    meta = json.loads(str(g["meta"]))
    sd = seeded_state_dict({k: tuple(v) for k, v in meta["shapes"].items()}, seed=meta["seed"])
    h, w, b = meta["h"], meta["w"], meta["batch"]
    ima, imb = (torch.from_numpy(seeded_images(b, h, w, s)).to(dev) for s in meta["im_seeds"])
    h1, w1 = h // 16, w // 16
    model = immatch_model(meta, sd, torch.bfloat16, dev)

    @torch.inference_mode()
    def call():
        corr, _ = model(ima, imb)
        return corr_to_matches(corr)

    for _ in range(2):
        call()
    torch.cuda.synchronize()
    reset_counts()
    with capture_inputs(((conv4d_module, "tap_sum"),), keep=1) as captured:
        grid, scores, mutual = call()
        torch.cuda.synchronize()
    launches = counts()
    expect = {**{k: 0 for k in launches}, "tap_sum": 2}
    if launches != expect:
        fail(f"immatch: launches per call {launches}, expected {expect}")
    n = 2 * h1 * w1
    if (grid.shape != (b, n, 4) or not in_grid(grid, h1, w1) or not torch.isfinite(scores).all()
            or (scores < 0).any() or (scores > 1).any()):
        fail(f"immatch: grid {tuple(grid.shape)} or scores outside their range")
    hold_path_calls("immatch", outside_inference(captured),
                    torch.Generator(device=dev).manual_seed(3))
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for _ in range(10):
        call()
    torch.cuda.synchronize()
    pairs_s = b * 10 / (time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"immatch [VGG16 pool4, NCN (3, 3, 3)/(10, 10, 1), {w}x{h} bf16 B={b}]: forward + "
        f"corr_to_matches latency median {np.median(times):.2f} ms/call of 10 (min "
        f"{min(times):.2f}, max {max(times):.2f}); {pairs_s:.2f} pairs/s over 10 calls back to "
        f"back; peak device memory {peak_gb:.2f} GB; launches per call {launches}; "
        f"{int(mutual.sum())} mutual rows")
    profile_main_path("immatch bf16", call)

    # relocalisation k = 2
    model.relocalization_k_size = 2
    with torch.inference_mode():
        corr, delta = model(ima, imb)
        pre = feat_correlation(model.features(ima), model.features(imb))
        grid2, scores2, _ = corr_to_matches(corr, delta, ksize=2)
        grid_pre, _, _ = corr_to_matches(corr, pre, ksize=2)
        gk, sk = corr_to_matches_topk(corr, delta, topk=2, ksize=2)
        reloc_ms = time_ms(lambda: model(ima, imb), iters=5)
    nb2 = (h1 // 2) * (w1 // 2)
    anchors = torch.arange(nb2, device=dev)
    inside = (in_grid(grid2, h1, w1) and in_grid(gk, h1, w1)
              and torch.equal(grid2[0, :nb2, 3] // 2, anchors // (w1 // 2))
              and torch.equal(grid2[0, :nb2, 2] // 2, anchors % (w1 // 2)))
    if (corr.shape != (b, h1 // 2, w1 // 2, h1 // 2, w1 // 2) or not inside
            or not torch.equal(grid2, grid_pre) or gk.shape != (b, 2 * nb2, 4)
            or not torch.isfinite(sk).all()):
        fail("immatch relocalisation: grids outside the pre-pool grid, off their pooled "
             "cell, or unequal to the pre-pool volume's relocation")
    log(f"immatch relocalisation k=2: pooled volume {tuple(corr.shape)}; corr_to_matches with "
        f"the offsets equal to the pre-pool volume's relocation, rows inside their pooled "
        f"cells; topk=2 grid {tuple(gk.shape)}; forward {reloc_ms:.2f} ms/call")
    del model, corr, delta, pre
    torch.cuda.empty_cache()

    # float32 golden
    model = immatch_model(meta, sd, torch.float32, dev)
    before = tap_sum.launches
    with torch.inference_mode():
        corr, _ = model(ima, imb)
        grid, scores, mutual = (t.cpu().numpy() for t in corr_to_matches(corr))
    if tap_sum.launches - before != 2:
        fail("immatch golden: B1 did not launch twice")
    diff = (grid != g["grid"]).any(axis=-1)
    ties = g["margin"] <= TIE_REL * meta["corr_max"]
    if (diff & ~ties).any():
        fail(f"immatch golden: {int((diff & ~ties).sum())} rows differ away from score ties")
    serr = float(np.abs(scores - g["scores"])[~diff].max())
    if not serr <= 5e-3:
        fail(f"immatch golden: scores err {serr} > 5e-3")
    mut_diff = int((mutual != g["mutual"]).sum())
    if mut_diff and not diff.any():
        fail(f"immatch golden: {mut_diff} mutual flags differ with every grid row equal")
    log(f"golden immatch_vgg_1024 [{w}x{h} f32]: {int(diff.sum())} of {diff.size} rows differ "
        f"(all at score ties: {int(ties.sum())} rows have a top-2 margin below "
        f"{TIE_REL * meta['corr_max']:.3g}); scores max err {serr:.3g} (rel "
        f"{float((np.abs(scores - g['scores']) / g['scores'])[~diff].max()):.3g}); "
        f"{mut_diff} mutual flags differ")
    del model
    torch.cuda.empty_cache()
    return launches


def resnet101_coarse_path(dev):
    """Phase 12: the NCNet-only coarse matcher with ResNet101,
    ``Patch2Pix(backbone="ResNet101", change_stride=True, regressor=None)``,
    ``predict_coarse`` at 1024x768, B = 2, ksize 2, mutual, seeded
    weights and images: bf16 launches B2 at C = 1024 once and B1 twice a
    call (each first call held as in phase 2), timed; then the same
    model in float32. Rules: phase 4's output checks (shapes, finite
    values, matches inside the images, scores in [0, 1]); then the same
    bf16 features through both models' coarse stages (B2 + NCN, bf16
    against f32): the volumes differ by at most ``eps`` <= 2^-4 of max
    |volume| (the bf16 NCN stores its 16-channel volume and its fold-out
    taps in bf16), and every direction-1 row whose f32 top-2 margin
    exceeds 2 ``eps`` picks the same cell in bf16. The end-to-end match
    sets (the backbone in bf16 too) are compared and printed: with
    seeded weights on noise images most rows' top-2 margins lie far
    below bf16's rounding, so they may pick another cell."""
    cfg = dict(backbone="ResNet101", change_stride=True, regressor=None)
    models = {dt: Patch2Pix(ModelConfig(**cfg, dtype=dt).resolved(), device=dev)
              for dt in ("bfloat16", "float32")}
    shapes = {k: tuple(v.shape) for k, v in models["float32"].state_dict().items()}
    sd = {k: torch.from_numpy(v) for k, v in seeded_state_dict(shapes, seed=0).items()}
    for model in models.values():
        model.load_state_dict(sd)
    ima, imb = (torch.from_numpy(seeded_images(BATCH, H, W, s)).to(dev) for s in (31, 32))
    model = models["bfloat16"]

    def call():
        return model.predict_coarse(ima, imb, ksize=2, mutual=True)

    for _ in range(2):
        call()
    torch.cuda.synchronize()
    reset_counts()
    sites = ((conv4d_module, "tap_sum"), (patch2pix_module, "corr_pool"))
    with capture_inputs(sites, keep=1) as captured:
        cm = call()
        torch.cuda.synchronize()
    launches = counts()
    expect = {**{k: 0 for k in launches}, "tap_sum": 2, "corr_pool": 1}
    f1 = captured["corr_pool"][0][0]
    if launches != expect or f1.shape[-1] != 1024 or f1.dtype != torch.bfloat16:
        fail(f"resnet101 coarse: launches {launches} (expected {expect}), B2 on "
             f"{tuple(f1.shape)} {f1.dtype} (expected 1024 bf16 channels)")
    check_outputs("resnet101 coarse", cm, cm, cm, BATCH, H, W)
    hold_path_calls("resnet101 coarse", outside_inference(captured),
                    torch.Generator(device=dev).manual_seed(4))
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with torch.inference_mode():
        fa, fb = model.extract(ima), model.extract(imb)
        c16, _ = model.coarse_corr(fa, fb, 2)
        c32, _ = models["float32"].coarse_corr(fa.float(), fb.float(), 2)
        eps = float((c16 - c32).abs().max())
        scale = float(c32.abs().max())
        nb = c32.shape[3] * c32.shape[4]
        top = c32.reshape(BATCH, -1, nb).topk(2, dim=1)
        decided = (top.values[:, 0] - top.values[:, 1]) > 2 * eps
        same = top.indices[:, 0] == c16.reshape(BATCH, -1, nb).argmax(dim=1)
    if not eps <= 2 ** -4 * scale or not bool(same[decided].all()):
        fail(f"resnet101 coarse: bf16 volume off by {eps} (max |volume| {scale}), or "
             f"{int((decided & ~same).sum())} rows decided in f32 by more than 2 eps differ")
    cm32 = models["float32"].predict_coarse(ima, imb, ksize=2, mutual=True)
    agree = []
    for i in range(BATCH):
        want = {row_key(r) for r in cm32.coords[i][cm32.valid[i]].cpu().numpy()}
        got = {row_key(r) for r in cm.coords[i][cm.valid[i]].cpu().numpy()}
        agree.append((len(want & got), len(want), len(got)))
    log(f"resnet101 coarse [change_stride {W}x{H} bf16 B={BATCH} ksize 2, mutual]: latency "
        f"median {np.median(times):.2f} ms/call of 10 (min {min(times):.2f}, max "
        f"{max(times):.2f}); peak device memory {peak_gb:.2f} GB; launches per call "
        f"{launches} (B2 on {tuple(f1.shape)} bf16); the coarse stage on the same bf16 "
        f"features, bf16 against f32: max volume err {eps:.4g} ({eps / scale:.4g} of max "
        f"|volume|), {int(decided.sum())} of {decided.numel()} rows decided by more than "
        f"2 eps, all equal; {int(same.sum())} rows equal in all; end to end (common, f32, "
        f"bf16) valid mutual matches per pair {agree}")
    profile_main_path("resnet101 coarse bf16", call)
    del models, model
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phase 13

EVAL_DIR = os.path.join(ROOT, "build", "chip_smoke_eval")
# (a)'s scene: fine_cap's match set at B=1, 0.3 px noise, a quarter outliers
N_CORR, NOISE_PX, OUTLIERS = 1200, 0.3, 0.25
RANSACS = {  # name: (function, sample size, hypotheses (JAX's defaults), bound on R
    # and t from the truth with the card's generator, deg)
    "ransac_essential_5pt": (ransac_essential_5pt, 5, 256, (0.5, 0.5)),
    # one linear 8-point refit of the best minimal hypothesis' inliers, no
    # Gauss-Newton: its t does not reach 0.5 deg at this scene's noise and
    # baseline
    "ransac_essential": (ransac_essential, 8, 512, (0.5, 2.0)),
    "ransac_pnp": (ransac_pnp, 6, 256, (0.5, 0.5)),
}


def rot_deg(Ra, Rb):
    """Angle (deg) of Ra^T Rb, by atan2 (accurate at small angles)."""
    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    s = np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]]) / 2
    return float(np.degrees(np.arctan2(s, (np.trace(M) - 1) / 2)))


def dir_deg(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.degrees(np.arctan2(np.linalg.norm(np.cross(a, b)), np.dot(a, b))))


def device_ops(fn):
    """(device ms, device ops) of one call of fn, from torch.profiler."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    return sum(ev.time_range.elapsed_us() for ev in evs) / 1e3, len(evs)


def ransac_scene(seed):
    """(a)'s scene: the pose and intrinsics of a ``make_posed_pair`` at
    1024x768, N_CORR correspondences of 3D points at depths 1.5 to 3 in
    view 1 (off the pair's plane: plane-only matches fit two essential
    matrices equally well and leave the 8-point refit and the DLT
    degenerate), NOISE_PX px of noise, the first OUTLIERS of view 2's
    points replaced by uniform pixels. Normalized coordinates, float32."""
    rs = np.random.RandomState(seed)
    *_, K, R, t = make_posed_pair(rs, H, W)
    t = -t  # the images' motion (write_val_dense_fixture's convention)
    Kinv = np.linalg.inv(K)
    uv = rs.uniform((0, 0), (W, H), (4 * N_CORR, 2))
    X = rs.uniform(1.5, 3.0, (4 * N_CORR, 1)) * (np.c_[uv, np.ones(4 * N_CORR)] @ Kinv.T)
    xc = X @ R.T + t
    x2 = (xc[:, :2] / xc[:, 2:]) @ K[:2, :2].T + K[:2, 2]
    keep = np.flatnonzero((xc[:, 2] > 0) & (x2[:, 0] >= 0) & (x2[:, 0] < W) & (x2[:, 1] >= 0)
                          & (x2[:, 1] < H))[:N_CORR]
    x1 = uv[keep] + rs.normal(0, NOISE_PX, (N_CORR, 2))
    x2 = x2[keep] + rs.normal(0, NOISE_PX, (N_CORR, 2))
    n_out = int(OUTLIERS * N_CORR)
    x2[:n_out] = rs.uniform((0, 0), (W, H), (n_out, 2))
    norm = lambda x: torch.from_numpy(((x - K[:2, 2]) / K[0, 0]).astype(np.float32))
    return {"p1": norm(x1), "p2": norm(x2), "X": torch.from_numpy(X[keep].astype(np.float32)),
            "R": R, "t": t, "thres": float((1.0 / K[0, 0]) ** 2)}


def ransac_path(dev):
    """Phase 13 (a): the three RANSACs on the card against the CPU on the
    same sample ids, then with the card's own generator against the true
    pose (``RANSACS``' bounds); host and device ms per call."""
    scene = ransac_scene(13)
    valid = torch.ones(N_CORR, dtype=torch.bool)
    for i, (name, (fn, k, n, (r_max, t_max))) in enumerate(RANSACS.items()):
        a, b = (scene["X"], scene["p2"]) if name == "ransac_pnp" else (scene["p1"], scene["p2"])
        ids = draw_sample_ids(torch.Generator().manual_seed(i), valid, n, k)
        want = fn(None, a, b, n, scene["thres"], ids=ids)
        a, b = a.to(dev), b.to(dev)
        got = fn(None, a, b, n, scene["thres"], ids=ids.to(dev))
        differ = int((got.inliers.cpu() != want.inliers).sum())
        r_err, t_err = rot_deg(got.R.cpu(), want.R), dir_deg(got.t.cpu(), want.t)
        if differ > N_CORR // 200 or r_err > 0.05 or t_err > 0.1:
            fail(f"{name}: the card's result on the CPU's sample ids differs: {differ} inlier "
                 f"rows, R {r_err:.4g} deg, t {t_err:.4g} deg")
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        own = fn(gen, a, b, n, scene["thres"])
        r_true, t_true = rot_deg(own.R.cpu(), scene["R"]), dir_deg(own.t.cpu(), scene["t"])
        if not (r_true < r_max and t_true < t_max):
            fail(f"{name} with the card's generator: R {r_true:.4g} deg, t {t_true:.4g} deg "
                 f"from the true pose")
        times = []
        for _ in range(11):
            t0 = time.perf_counter()
            fn(gen, a, b, n, scene["thres"])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        dev_ms, ops = device_ops(lambda: fn(gen, a, b, n, scene["thres"]))
        log(f"eval {name} [N={N_CORR}, {n} samples of {k}, {OUTLIERS:.0%} outliers, "
            f"{NOISE_PX} px]: card vs CPU on the same ids: {differ} inlier rows differ, R "
            f"{r_err:.2e} deg, t {t_err:.2e} deg; card's generator: {int(own.num_inliers)} "
            f"inliers, R {r_true:.4f} deg and t {t_true:.4f} deg from the truth; host ms per "
            f"call median {np.median(times[1:]):.2f} of 10 (min {min(times[1:]):.2f}, max "
            f"{max(times[1:]):.2f}); device {dev_ms:.3f} ms in {ops} device ops per call")


class time_geometry:
    """Within the block, ``eval_immatch_val_sets``' relative-pose calls are
    timed (host clock; each ends in a device-to-host copy); ``as`` gives
    the list of ms."""

    def __enter__(self):
        self.saved = immatch_module.eval_matches_relapose
        times = self.times = []

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = self.saved(*args, **kw)
            times.append((time.perf_counter() - t0) * 1e3)
            return out
        immatch_module.eval_matches_relapose = timed
        return times

    def __exit__(self, *exc):
        immatch_module.eval_matches_relapose = self.saved


def timed_matcher(matcher, times):
    def call(p1, p2):
        t0 = time.perf_counter()
        out = matcher(p1, p2)  # numpy out: the card's work is done
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    return call


def hpatches_sequence(root, seed=1):
    """(c)'s sequence: a reference view and five warps of it by
    ``make_pair``'s plane homographies, as ``{root}/v_synthetic/{1..6}.png``
    and ``H_1_{2..6}``."""
    from PIL import Image

    seq = os.path.join(root, "v_synthetic")
    os.makedirs(seq, exist_ok=True)
    rs = np.random.RandomState(seed)
    ref = make_pair(rs, H, W)[0]
    for k in range(1, 7):
        im = ref
        if k > 1:
            Hk = make_pair(rs, H, W)[3].astype(np.float64)
            im = warp_homography(ref, Hk)
            np.savetxt(os.path.join(seq, f"H_1_{k}"), Hk)
        u8 = np.clip(np.round(im * 255), 0, 255).astype(np.uint8)
        Image.fromarray(u8).save(os.path.join(seq, f"{k}.png"))


def eval_path(dev, sd):
    """Phase 13: (a) the RANSACs, (b) the immatch protocol on a
    PhotoTourism-layout fixture with the oracle and with the Matcher, (c)
    HPatches. Returns B1-B3's launches in (b) and (c)."""
    t_phase = time.perf_counter()
    ransac_path(dev)
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    root = os.path.join(EVAL_DIR, "val_dense")
    scenes = write_val_dense_fixture(root, 4, H, W, seed=0)
    quiet = []

    qt, rates, res = eval_immatch_val_sets(oracle_matcher(scenes, n=N_CORR, noise=0.2),
                                           data_root=root, log=quiet.append, device=dev)
    if res.match_failed or res.geo_failed or len(res.qt) != 4 or not (
            max(res.qt) < 1.0 and rates[0] == 100.0):
        fail(f"eval oracle: qt {res.qt}, pass rates {rates}, failed "
             f"{res.match_failed + res.geo_failed}")
    log(f"eval immatch oracle [4 scenes x 1 pair {W}x{H}, {N_CORR} off-plane matches, 0.2 "
        f"px]: qt per pair " + " ".join(f"{q:.4f}" for q in res.qt)
        + f" deg, pass rate at 1 deg {rates[0]:.0f}%")

    model = build_model(True, sd, "bfloat16", dev)
    matcher = Matcher(model, ksize=2, io_thres=0.5, imsize=1024, eval_type="fine")
    reset_counts()
    for run in (1, 2):
        match_ms = []
        quiet.clear()
        with time_geometry() as geo_ms:
            t0 = time.perf_counter()
            qt, rates, res = eval_immatch_val_sets(timed_matcher(matcher, match_ms),
                                                   data_root=root, log=quiet.append)
            wall = (time.perf_counter() - t0) * 1e3
        if res.match_failed or res.geo_failed or len(res.qt) != 4:
            fail(f"eval Matcher run {run}: failed pairs {res.match_failed + res.geo_failed}")
        log(f"eval immatch Matcher run {run} [ResNet34 change_stride, seeded, bf16, ksize 2, "
            f"io_thres 0.5, imsize 1024]: no failed pair; matches per pair {res.num_matches}; "
            f"qt per pair " + " ".join(f"{q:.2f}" for q in res.qt) + " deg (seeded weights: "
            f"no bound); ms per pair: matching " + " ".join(f"{t:.2f}" for t in match_ms)
            + ", geometry " + " ".join(f"{t:.2f}" for t in geo_ms)
            + f"; protocol {wall / 4:.2f} ms per pair; its log: {quiet[-1]}")
    launches = {k: v for k, v in counts().items() if v}
    if not all(launches.get(k, 0) > 0 for k in ("tap_sum", "corr_pool", "expand_scale_pair")):
        fail(f"eval: B1-B3 must launch under the protocol's Matcher: {launches}")
    log(f"eval immatch Matcher launches over 2 x 4 pairs: {launches}")

    hp_root = os.path.join(EVAL_DIR, "hpatches")
    hpatches_sequence(hp_root)
    quiet.clear()
    before = counts()
    hp = eval_hpatches(matcher, hp_root, log=quiet.append)
    if hp.failed or len(hp.errors["v"]) != 5:
        fail(f"eval hpatches: failed {hp.failed}, pairs {len(hp.errors['v'])}")
    hp_launches = {k: v - before[k] for k, v in counts().items() if v - before[k]}
    log(f"eval hpatches [1 sequence, 5 warps, {W}x{H}, the same Matcher]: no failed pair; "
        f"matches per pair {hp.num_matches}; MMA@1..10 "
        + " ".join(f"{v:.3f}" for v in hp.mma()) + f" (seeded weights); launches "
        f"{hp_launches}")
    del matcher, model
    torch.cuda.empty_cache()
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    log(f"eval phase: {time.perf_counter() - t_phase:.1f} s")
    return counts()


# ------------------------------------------------------------ phase 14

SFM_DIR = os.path.join(ROOT, "build", "chip_smoke_sfm")
# tools/bench_ba.py's first two scales (cameras, points, observations a
# point); its third, (1000, 200000, 5), is left to the demo's --ba_scales
BA_SCALES = ((200, 20000, 9), (500, 100000, 6))


class counting:
    """Within the block each named function of ``module`` counts its calls
    (``.calls``) and keeps its results (``.results``)."""

    def __init__(self, module, *names):
        self.module, self.names = module, names

    def __enter__(self):
        self.calls = {n: 0 for n in self.names}
        self.results = {n: [] for n in self.names}
        self.saved = {n: getattr(self.module, n) for n in self.names}
        for n in self.names:
            def wrapped(*args, _n=n, **kw):
                self.calls[_n] += 1
                out = self.saved[_n](*args, **kw)
                self.results[_n].append(out)
                return out
            setattr(self.module, n, wrapped)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)


def hold_ba_step(tag, got, want):
    """Phase 14's rules for one LM step against another (those of
    ``tests/test_sfm_dist.py::test_dist_ba_first_iteration_exact_parity``):
    old cost rtol 1e-5, new cost rtol 1e-3, R and t atol 1e-5. ``got`` and
    ``want`` are (Rs, ts, new cost, old cost)."""
    (gR, gt, gc, go), (wR, wt, wc, wo) = [
        [np.asarray(torch.as_tensor(x).cpu(), np.float64) for x in v] for v in (got, want)]
    errs = {"old cost rel": float(abs(go - wo) / abs(wo)), "new cost rel": float(abs(gc - wc) / abs(wc)),
            "R": float(np.abs(gR - wR).max()), "t": float(np.abs(gt - wt).max())}
    if not (errs["old cost rel"] <= 1e-5 and errs["new cost rel"] <= 1e-3 and errs["R"] <= 1e-5
            and errs["t"] <= 1e-5):
        fail(f"{tag}: {errs}")
    return errs


def ba_iteration_profile(prob, top=8):
    """(device ms, [(kernel, ms, calls)] of the ``top`` kernels) of one LM
    iteration, from torch.profiler."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        lm_iterations(prob, 1)
        torch.cuda.synchronize()
    per = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = per.get(ev.name, (0.0, 0))
            per[ev.name] = (ms + ev.time_range.elapsed_us() / 1e3, n + 1)
    rows = sorted(((k, ms, n) for k, (ms, n) in per.items()), key=lambda r: -r[1])
    return sum(ms for _, ms, _ in rows), rows[:top]


def ba_path(dev):
    """Phase 14 (a) and (b): one ``ba_step`` on the card against the CPU at
    ``tools/bench_ba.py``'s (200, 20000, 9) scene, ms per LM iteration at
    ``BA_SCALES``; then the point-sharded BA at world size 1 over NCCL."""
    log(f"sfm: TF32 off (torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32})")
    c0, p0, o0 = BA_SCALES[0]
    Rs, ts, X, ci, pi, uv = make_ba_scene(c0, p0, o0)
    args = (Rs, ts, perturb_points(X), ci, pi, uv)
    card = build_problem(*args, device=dev)
    new_g, cn_g, co_g = ba_module.ba_step(card, 1e-3, 1e9, False)
    again, cn_a, _ = ba_module.ba_step(card, 1e-3, 1e9, False)
    if not all(torch.equal(a, b) for a, b in ((new_g.Rs, again.Rs), (new_g.ts, again.ts),
                                                (new_g.X, again.X), (cn_g, cn_a))):
        fail("sfm ba_step: a second step from the same problem differs from the first")
    new_c, cn_c, co_c = ba_module.ba_step(build_problem(*args, device="cpu"), 1e-3, 1e9, False)
    errs = hold_ba_step("sfm ba_step card vs CPU", (new_g.Rs, new_g.ts, cn_g, co_g),
                        (new_c.Rs, new_c.ts, cn_c, co_c))
    log(f"sfm ba_step [{c0} cams, {p0} pts, {len(ci)} obs, lambda 1e-3, no Huber]: card vs CPU "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; cost {float(co_g):.6g} -> {float(cn_g):.6g}; a second step repeats it bit for bit")

    for c, p, o in BA_SCALES:
        if (c, p, o) != BA_SCALES[0]:
            Rs_, ts_, X_, ci_, pi_, uv_ = make_ba_scene(c, p, o)
            prob = build_problem(Rs_, ts_, perturb_points(X_), ci_, pi_, uv_, device=dev)
        else:
            prob, ci_ = card, ci
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = lm_iteration_ms(prob)
        peak = torch.cuda.max_memory_allocated() / 1e9
        dev_ms, rows = ba_iteration_profile(prob)
        t_ops = 2 * (6 * c) ** 2 * (3 * p) / PEAK_FLOPS[torch.float32] * 1e3
        bt_bytes = 3 * p * 6 * c * 4
        t_bytes = bt_bytes / HBM_BPS * 1e3
        bound_ms, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
        log(f"sfm LM iteration [{c} cams, {p} pts, {len(ci_)} obs, f32]: {ms:.3f} ms per "
            f"iteration (marginal, k = 6 - 2, best of 3); bound {bound_ms:.3f} ms ({by}: Bt^T Bt "
            f"{2 * (6 * c) ** 2 * (3 * p) / 1e12:.3f} TFLOP at f32 67 TFLOP/s, Bt {bt_bytes / 1e9:.3f} "
            f"GB at 3.35 TB/s; {bound_ms / ms:.1%} of it); peak device memory {peak:.2f} GB; "
            f"one iteration {dev_ms:.3f} device ms, top kernels: "
            + "; ".join(f"{k[:70]} {m:.3f} ms x{n}" for k, m, n in rows))
        del prob
        torch.cuda.empty_cache()

    # (b) the point-sharded solver at world size 1 over NCCL
    sp = shard_problem(*args, n_shards=1)
    stats = {}
    with process_group(1, 0, "nccl") as group:
        step = make_dist_ba_step(c0, use_huber=False, group=group)
        nR, nt, nX, nc, oc = step(local_problem(sp, 0, dev), 1e-3, 1e9)
        step_errs = hold_ba_step("sfm dist step vs ba_step", (nR, nt, nc, oc),
                                 (new_g.Rs, new_g.ts, cn_g, co_g))
        t0 = time.perf_counter()
        _, _, X_d, c_dist = run_dist_ba(sp, group, max_iters=10, debug_checks=True,
                                        device=dev, stats=stats)
        t_dist = time.perf_counter() - t0
    cost0 = float(cost(card))
    t0 = time.perf_counter()
    _, c_single = run_ba(card, max_iters=10, device=dev)
    t_single = time.perf_counter() - t0
    rel = abs(c_dist - c_single) / max(c_single, 1e-12)
    if not (c_dist < cost0 * 1e-2 and rel < 0.5 and np.isfinite(X_d).all()):
        fail(f"sfm run_dist_ba: cost {cost0:.6g} -> {c_dist:.6g}, run_ba {c_single:.6g}")
    log(f"sfm dist BA [NCCL, world size 1, {c0} cams]: first step vs ba_step "
        + ", ".join(f"{k} {v:.3g}" for k, v in step_errs.items())
        + f"; run_dist_ba(max_iters 10, debug_checks) cost {cost0:.6g} -> {c_dist:.6g} in "
        f"{stats['iterations']} iterations, {stats['host_syncs']} stop-flag reads (host "
        f"synchronisations), {t_dist:.2f} s; run_ba {c_single:.6g} in {t_single:.2f} s "
        f"(relative difference {rel:.3g}); no divergence raised")


def sfm_demo_path(cams=50, pts=5000):
    """Phase 14 (c): the scale demo at its defaults (``cams``, ``pts``)
    through its ``main``, ``--mesh 1`` on the card."""
    shutil.rmtree(SFM_DIR, ignore_errors=True)
    with counting(incremental_module, "ransac_essential", "ransac_pnp", "run_ba") as inc, \
            counting(ba_module, "ba_step") as steps, \
            counting(native_module, "build_tracks_native") as nat, \
            counting(scale_demo, "make_scale_scene", "run_dist_ba_ranks") as demo:
        summary = scale_demo.main(["--cams", str(cams), "--pts", str(pts), "--mesh", "1",
                                   "--out", SFM_DIR])
    Rs_gt, ts_gt = demo.results["make_scale_scene"][0][:2]
    radius = float(np.linalg.norm([-R.T @ t for R, t in zip(Rs_gt, ts_gt)], axis=1).mean())
    _, ims, points = read_model(os.path.join(SFM_DIR, "colmap"), ext=".bin")
    dstats = demo.results["run_dist_ba_ranks"][0][4]
    ate = {k: summary[k] / radius for k in ("ate_incremental", "ate_after_dist_ba")}
    if not (summary["points"] > 0.6 * pts and max(ate.values()) < 0.01
            and nat.calls["build_tracks_native"] == 1 and len(ims) == cams
            and len(points) == summary["points"]):
        fail(f"sfm demo: {summary}; ATE / radius {ate}; native track builds "
             f"{nat.calls['build_tracks_native']}; COLMAP read back {len(ims)} images, "
             f"{len(points)} points")
    log(f"sfm demo [{cams} cams, {pts} pts, 0.4 px, 5% outliers, pair gap 5, ba_every 10, mesh 1, "
        f"{summary['device']}, {summary['power_limit']}]: {summary['points']} points, ATE "
        f"{100 * ate['ate_incremental']:.4f}% of the radius after the incremental run, "
        f"{100 * ate['ate_after_dist_ba']:.4f}% after dist BA; native track builder "
        f"(C++) used; COLMAP export read back: {len(ims)} images, {len(points)} points; "
        f"{summary['s_per_image']} s/image (incremental {summary['t_incremental_s']} s, "
        f"tracks {summary['t_tracks_s']} s, dist BA {summary['t_dist_ba_s']} s); stage "
        f"attribution {summary['stage_attribution']}; calls: RANSAC "
        f"{inc.calls['ransac_essential']}, PnP {inc.calls['ransac_pnp']}, BA "
        f"{inc.calls['run_ba']} ({steps.calls['ba_step']} run_ba iterations); dist BA "
        f"{dstats['iterations']} iterations, {dstats['host_syncs']} host synchronisations "
        f"({dstats['host_syncs'] / max(dstats['iterations'], 1):.2f} per iteration)")
    shutil.rmtree(SFM_DIR, ignore_errors=True)


def sfm_path(dev):
    """Phase 14: the SfM backend (no kernel on its path)."""
    t_phase = time.perf_counter()
    ba_path(dev)
    torch.cuda.empty_cache()
    sfm_demo_path()
    torch.cuda.empty_cache()
    log(f"sfm phase: {time.perf_counter() - t_phase:.1f} s")


def main():
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # phase 1: build
    secs, reports = _build.build()
    log(f"kernel build: {secs:.1f} s ({len(reports)} sources compiled)")
    for name, rep in reports.items():
        for line in rep.splitlines():
            # every kernel's registers and spills; the entry names of the wgmma
            # kernels and of patch_expand's B3 and B7 too
            if ("registers" in line or "spill" in line
                    or (name in ("corr_pool", "fine_head", "patch_expand")
                        and "Compiling entry" in line)):
                log(f"  {name}: {line.strip()}")

    # phase 2: kernels against their plain versions
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    checks = {tap_sum: check_tap_sum, corr_pool: check_corr_pool,
              expand_scale_pair: check_expand, conv4d_small: check_conv4d_small,
              fused_fine_head: check_fine_head, expand_level: check_expand_level}
    backward_checks = {
        tap_sum: lambda dt: backward_tap_sum(gen, *tap_sum_inputs(dt, gen, dev)),
        corr_pool: lambda dt: backward_corr_pool(gen, *corr_pool_inputs(dt, gen, dev, H // 8,
                                                                         W // 8)),
        expand_scale_pair: lambda dt: backward_expand(gen, *expand_inputs(dt, gen, dev))}
    results = {}
    for fn, check in checks.items():
        name = KERNELS[fn][0]
        for dtype in (torch.bfloat16, torch.float32):
            r = check(dtype, gen, dev)
            lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            log(f"kernel {name} [{str(dtype)[6:]}] {r['shape']}: max_abs_err "
                f"{r['max_abs_err']:.3g} ms {r['ms']:.4f} plain_ms "
                f"{r['plain_ms']:.4f} library_ms {lib} bound_ms "
                f"{r['bound_ms']:.4f} ({r['bound_by']})")
            if dtype == torch.bfloat16:
                results[fn] = r
            if fn in backward_checks:
                same, ms, shape = backward_checks[fn](dtype)
                if not same:
                    fail(f"{name} backward [{str(dtype)[6:]}]: the kernel route's gradients "
                         f"are not torch.equal to the plain route's")
                log(f"backward {name} [{str(dtype)[6:]}] {shape}: kernel route torch.equal "
                    f"to the plain route; {ms:.4f} ms per call")
            torch.cuda.empty_cache()

    # phase 3: golden parity, f32, TF32 off
    reset_counts()
    for tag in ("s16_1024", "cs_1024"):
        g, meta, sd = load_golden(tag)
        model = build_model(meta["change_stride"], sd, "float32", dev)
        im1 = torch.from_numpy(seeded_images(meta["batch"], meta["h"], meta["w"],
                                             meta["im_seed"])).to(dev)
        im2 = torch.from_numpy(seeded_images(meta["batch"], meta["h"], meta["w"],
                                             meta["im_seed"] + 1)).to(dev)
        fine, mid, cm = (to_numpy(x) for x in model.predict_fine(im1, im2, ksize=2))
        for b in range(meta["batch"]):
            n, errs = assert_match_parity(
                b, g[f"coarse_{b}"], g[f"mid_{b}"], g[f"mid_scores_{b}"],
                g[f"fine_{b}"], g[f"fine_scores_{b}"], fine, mid, cm,
                coord_tol=0.05, score_tol=5e-3)
            log(f"golden {tag} [{meta['h']}x{meta['w']} f32] batch {b}: {n} "
                f"matches, max errs " + " ".join(f"{k} {v:.3g}" for k, v in errs.items()))
        del model
    golden_counts = {k: counts()[k] for k in ("tap_sum", "corr_pool", "expand_scale_pair")}
    log(f"golden launches: {golden_counts}")
    if min(golden_counts.values()) == 0:
        fail(f"a kernel was not launched by the golden runs: {golden_counts}")

    # phase 4: the main path, bf16, 1024x768
    _, _, sd = load_golden("cs_1024")
    ims = [torch.from_numpy(seeded_images(BATCH, H, W, seed)).to(dev) for seed in (1, 2)]
    models = {cs: build_model(cs, sd, "bfloat16", dev) for cs in (True, False)}
    torch.cuda.synchronize()
    reset_counts()
    per_call = {}
    for cs, model in models.items():
        tag = "change_stride (upsample 8)" if cs else "upsample 16"
        matcher = Matcher(model, ksize=2, fine_cap=FINE_CAP)
        fm, fs, cmat = matcher.match_arrays(ims[0][0].cpu().numpy(), ims[1][0].cpu().numpy())
        if not (np.isfinite(fm).all() and np.isfinite(fs).all()) or fm.shape[1:] != (4,):
            fail(f"{tag}: Matcher returned bad matches {fm.shape}")
        log(f"main {tag}: Matcher.match_arrays -> {len(fm)} matches")

        def call():
            return model.predict_fine(ims[0], ims[1], ksize=2, fine_cap=FINE_CAP)

        before = counts()
        fine, mid, cm = call()
        torch.cuda.synchronize()
        per_call[tag] = {k: v - before[k] for k, v in counts().items()}
        n_valid = check_outputs(tag, fine, mid, cm, BATCH, H, W)
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # latency: each call waited for; throughput: calls back to back,
        # so the host enqueues a call while the card runs the previous one
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        pairs_s = BATCH * 10 / (time.perf_counter() - t0)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"main {tag} [{H}x{W} bf16 B={BATCH} fine_cap={FINE_CAP}]: "
            f"{pairs_s:.2f} pairs/s over 10 calls back to back; latency median "
            f"{np.median(times):.2f} ms/call of 10 (min {min(times):.2f}, max "
            f"{max(times):.2f}); peak device memory {peak_gb:.2f} GB; valid "
            f"matches per pair {n_valid}; launches per call {per_call[tag]}")
    main_counts = {k: counts()[k] for k in ("tap_sum", "corr_pool", "expand_scale_pair")}
    log(f"main-path launches: {main_counts}")
    if min(main_counts.values()) == 0:
        fail(f"a kernel was not launched on the main path: {main_counts}")
    # B4, B5 and B7 are off predict_fine: zero launches there
    off_path = {"conv4d_small": 0, "fused_fine_head": 0, "expand_level": 0}
    expect = {"change_stride (upsample 8)": {"tap_sum": 2, "corr_pool": 1,
                                             "expand_scale_pair": 2, **off_path},
              "upsample 16": {"tap_sum": 2, "corr_pool": 1,
                              "expand_scale_pair": 1, **off_path}}
    if per_call != expect:
        fail(f"launches per call {per_call}, expected {expect}")
    for cs, model in models.items():
        profile_main_path(
            "change_stride (upsample 8)" if cs else "upsample 16",
            lambda: model.predict_fine(ims[0], ims[1], ksize=2, fine_cap=FINE_CAP))

    del models
    torch.cuda.empty_cache()

    # phase 5: the conv4d path; phase 6: the fine-head path
    path_counts = {**main_counts}
    path_counts["conv4d_small"] = conv4d_path(dev)["conv4d_small"]
    torch.cuda.empty_cache()
    fine_counts = fine_head_path(dev)
    path_counts.update({k: fine_counts[k] for k in ("fused_fine_head", "expand_level")})
    torch.cuda.empty_cache()

    # phase 7: training; phase 8: the training forward's golden; phase 9:
    # NCN pretraining; phase 10: the training entry point
    train_ms = train_path(dev, sd)
    train_golden(dev)
    ncn_pretrain_path(dev, sd)
    cli_path(dev, sd, train_ms["bfloat16"])

    # phase 11: ImMatchNet; phase 12: the ResNet101 NCNet-only coarse matcher
    for path in (immatch_path, resnet101_coarse_path):
        for k, v in path(dev).items():
            if k in ("tap_sum", "corr_pool"):
                path_counts[k] += v

    # phase 13: evaluation (the RANSACs, immatch, HPatches)
    for k, v in eval_path(dev, sd).items():
        if k in ("tap_sum", "corr_pool", "expand_scale_pair"):
            path_counts[k] += v

    # phase 14: the SfM backend (BA, dist BA at world size 1, the scale demo)
    sfm_path(dev)

    # phase 15: report
    line = {"kernels": [
        dict(name=KERNELS[fn][0], route="cuda", source=KERNELS[fn][1],
             replaces=KERNELS[fn][2], launches=path_counts[KERNELS[fn][0]],
             max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
             bound_ms=r["bound_ms"], bound_by=r["bound_by"],
             library_ms=r["library_ms"])
        for fn, r in results.items()
    ]}
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
