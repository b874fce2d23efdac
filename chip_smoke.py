#!/usr/bin/env python3
"""Drive the PyTorch port (``patch2pix_tpu_torch``) on CUDA cards.

    python3 chip_smoke.py              # phases 1-17 on one card
    python3 chip_smoke.py --cards 4    # phase 1, then phase 18 on 4 cards
    python3 chip_smoke.py --cards 2    # the same on 2 cards (two hosts of one)

Phases, each fatal on failure:

  1. print the card's name and power limit, build the six CUDA sources
     (one ``nvcc`` per source, in parallel) and print the build time,
     conv4d's (the slowest source) apart;
  2. for each kernel (B1 tap_sum, B2 corr_pool, B3 expand_scale_pair, B4
     conv4d_small, B5 fused_fine_head, B7 expand_level), at the shapes of
     its path (change_stride, 1024x768, B=2: the NCN volume, M = 2400
     proposals, F = 512; B2 also at upsample 16 and at the ResNet101
     change_stride layer3, (2, 96, 128, 1024), which bf16 runs through the
     streamed kernel), in bf16 and in float32:
     hold the kernel against its plain PyTorch version on the card, time
     kernel, plain version and library yardstick, and compute the bound
     from the bytes and operations this run's inputs need (B3, B4, B5 and
     B7 also print their share of the bound, B4 and B7 their registers,
     shared memory and spills; B2 prints each case's kernel device ms by
     the profiler beside the CUDA-event ms, and for the streamed kernel its
     share of the bound, the L2 -> SM bytes its design predicts, its
     registers and spills and its cluster shape, and holds it at the card
     tests' shapes too; B4 is held and timed on the
     channels-last volume the NCN's fold-in leaves and on an NCHW view,
     and prints its bf16 kernel's registers and shared memory for each
     staging and, as a yardstick the port never calls for these
     channels, ``conv4d_xla_taps``; B4's float32 kernel (3xTF32 on
     ``mma.sync`` m16n8k8) prints its ms on both layouts and its device
     ms by the profiler, its share of the 3xTF32 bound and of the f32
     SIMT bound, its registers, shared memory (the dynamic part held to
     ``ops.conv4d_small.tf32_smem_bytes``) and spills for each staging,
     and its max abs error under the 1e-4 rule); B4's Cin-1 kernel (the
     NCN's bf16 first layer) at 1 -> 16 on the change_stride volume and
     1 -> 10 on ImMatchNet's, held to its plain version (one bf16 ulp +
     1e-5), its device ms beside its bytes bound and the fold-in's ms
     on the same inputs, its registers, shared memory and spills; B4's
     C -> C kernel (the NCN's bf16 middle layer) at 16 -> 16 on NCNet
     InLoc's volume (1, 75, 100, 75, 100) and 10 -> 10 on ImMatchNet's,
     held the same way with both directions' filters, its device ms
     beside its bound, the plain version's ms and, as the yardstick, the
     nine-conv loop it replaces, its registers, shared memory and spills;
     B5's float32 kernel (3xTF32 on ``wgmma``)
     prints its two launches' device ms, its share of the 3xTF32 bound
     and of the f32 SIMT bound, its registers, spills and shared memory
     a block (held to ``ops.fine_stage.smem_bytes``), its max abs and
     relative error under the 2e-4 rule, and the cuDNN chain beside it;
     for B1-B3, the gradients through the
     kernel route must be ``torch.equal`` to autograd's through the plain
     version, and their named backward is timed;
  3. golden parity in float32 with TF32 off: rebuild the seeded weights
     and reproduce ``tests/fixtures/pipeline_golden_{s16,cs}_1024.npz``
     (identical coarse set, coords 0.05 px, scores 5e-3) — every kernel's
     launch count must rise;
  4. the main path in bf16 at 1024x768: ``Matcher.match_arrays`` on one
     pair, then ``Patch2Pix.predict_fine`` at B=2, fine_cap 1200, for
     change_stride and upsample 16: output checks, kernel launches per
     call (B4 twice: the NCN's first layer on its Cin-1 kernel), pairs/s
     over 10 calls back to back, the median latency of 10
     calls each waited for, peak device memory; then, per stride, the
     top device kernels (and the port's own wherever they rank) and the
     device busy share over 3 calls under torch.profiler (after the
     launch counts are read);
  5. the conv4d path: a symmetric NeighConsensus with channels (4, 4, 1)
     in bf16 on the change_stride volume — B4 four times (the 1 -> 4
     layer twice on its Cin-1 kernel, the 4 -> 4 layer twice on its
     tensor-core kernel, staging channels-last) and B1 twice per call,
     output held against the
     same NCN with B4's plain version; then the same NCN in float32
     (TF32 off for cuDNN's fold-in and fold-out): B4 twice on its 3xTF32
     kernel, staging the fold-in's channels-last volume, B1 twice,
     output within 1e-5 of max |ref| of the plain-B4 run, timed beside
     it with B4's device ms; then one B4 layer's backward
     through the kernel against the CPU's, and one bf16 4->4 layer's
     backward timed at the change_stride shape;
  6. the fine-head path (the port's ``tools/try_fine_stage.py``): a
     full-width fine FeatRegressNet, M = 2400 seeded rows, (M, 5)
     outputs fused (prolog with B7, B5, fc_head) and unfused (B3,
     ``forward``) in bf16 and in float32 (each fused run launching B5
     once and B7 ten times), held to the rules of ``fine_head_path``,
     both timed in both types; then the ten B7
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
     B1 twice a call and its first call held as in phase 2, B4's Cin-1
     kernel twice a call (the NCN's first layer), its C -> C kernel twice
     (the 10 -> 10 middle layer); relocalisation
     k = 2 (``maxpool4d``, both extractions, grids in the pre-pool grid);
     then float32 against ``tests/fixtures/immatch_golden_vgg_1024.npz``;
  12. the NCNet-only coarse matcher with ResNet101 (``Patch2Pix``,
     change_stride, no regressor), ``predict_coarse`` at 1024x768, B = 2,
     ksize 2, bf16: B2 on 1024 bf16 channels once, B1 twice and B4's
     Cin-1 kernel twice a call, B1's and B2's first calls held as in
     phase 2, timed, its match set held to the
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
  15. the sharded paths at world size 1 over NCCL from a ``file://``
     store (``parallel.mesh.process_group``), each part's seconds
     printed: (a) ``BatchedMatcher`` (seeded ResNet34, imsize 1024, both
     strides) on 10 seeded PNG pairs, 8 at 1024x768 and 2 at 640x480 (two
     buckets; change_stride's per_chip_batch 4 pads the second): in f32
     each pair equals ``Matcher.estimate_matches`` by the goldens' rules
     (the same coarse row set, coords 0.05 px, scores 5e-3); in bf16 the
     pairs/s at per_chip_batch 1, 2 and 4 beside phase 4's; B1-B3
     launches counted from zero, each first call held as in phase 2, and
     no collective recorded while matching; (b) one train step over the
     mesh (phase 7's setting) from the seeded state and a fixed proposal
     draw against ``make_train_step``'s without a mesh, under cuDNN's
     deterministic algorithms: parameters and running averages
     ``torch.equal`` (in f32, or within rtol 1e-5 / atol 1e-6), the same
     metrics (rtol 1e-5), and beside them the control, the step without
     a mesh run twice, with the deterministic and the default
     algorithms; ms per step beside phase 7's, bf16 and f32; the
     collectives of a step (all-reduces only) with the gradient buffer's
     bytes; B1 and B3 launch, each first call held as in phase 7; (c) the
     h1-sharded coarse matcher on phase 4's change_stride features
     (2, 96, 128, 256), bf16 and f32: coords and valid flags equal
     ``coarse_matches``', scores rtol 2e-5 / atol 1e-6; B2 and B1 launch
     and are held; ms per call beside the single-device coarse stage;
  16. the JAX-only tools' twins and a ``gather="block"`` run directory
     (under ``build/chip_smoke_tools/``, removed afterwards), each part's
     seconds printed: (a) ``python -m
     patch2pix_tpu_torch.evaluation.demo_matching`` through its ``main``
     at ``--imsize 1024`` with random bf16 weights on 3 PNG pairs of
     ``make_pair`` scenes at 1024x768, ``--no_plot`` (this machine has no
     matplotlib): matches and seconds per pair, B1-B3 launched; (b)
     ``python -m patch2pix_tpu_torch.data.prep_megadepth_pairs`` on a
     synthetic ``scene_info`` (``write_scene_info``): its pair count;
     (c) a run directory whose meta says ``gather="block"`` (the JAX
     package's TPU gather switch, which routes nothing in the port),
     written by ``save_ckpt`` from the seeded weights, through
     ``restore_for_eval``: ``predict_fine`` (change_stride, 1024x768,
     fine_cap 1200, f32) equal to the ``"auto"`` model's bit for bit;
     (d) ``python -m patch2pix_tpu_torch.train.synth_demo`` at its
     defaults (300 steps, ``--no_plot``): finite losses and
     loss/epi_fine's last 25 steps under 0.7 of its first 25's, ms per
     step, the held-out Sampson error at the start and the end, the pairs
     skipped in the last 6 steps beside the JAX tool's committed run's;
     then tests/test_train_convergence.py's workload
     (``train.convergence``: f32, 96x128, one fixed batch, 24 steps,
     cuDNN's deterministic algorithms) with finite losses, no pair
     skipped in the last 6 steps, loss/epi_fine under 0.7 and
     loss/epi_mid under 0.9 on 6-step windows, its pair-loss ratio
     printed; ~90 s;
  17. one JSON line of per-kernel numbers (B1's and B2's launches summed
     over phases 4, 11, 12, 13, 15 and 16, B3's over 4, 13, 15 and 16),
     then the result line.

  18. (``--cards N`` alone, after phase 1; it exits non-zero where fewer
     than N cards are visible, and ``--cards 1`` rehearses it at world
     size 1 on one card) the multi-card paths, one NCCL rank a card
     spawned from a ``file://`` store, every process group with a
     5-minute timeout (``MULTI_TIMEOUT``), so that a hang fails the run;
     each rank prints its current card and name, two ranks on one card
     fail; the world-size-1 references run on rank 0, card 0, while the
     other ranks wait; a failed check on any rank ends the phase at once
     (the rank aborts its group and exits 1, the parent ends the others);
     each part prints its seconds: (a) the sharded train
     step at phase 7's setting: one f32 step at one pair a rank (cuDNN
     deterministic, ``debug_checks``) against ``make_train_step`` without
     a mesh on the same global batch by the CPU tests' rule (metrics and
     running averages rtol 1e-5, parameters by Adam's bound, frozen
     tensors bit-identical, summed gradients within 1e-4 of the largest
     or, where larger, within the card's own spread: how far the same
     single-device step with cuDNN off lies from it, in this run),
     its collectives (all-reduces only), B1 and B3 launched on every rank
     and held on rank 0; then bf16 ms/step at 4 pairs a rank beside world
     size 1 at batch 4 and the weak-scaling efficiency; (b)
     ``BatchedMatcher`` on 32 PNG pairs (28 at 1024x768, 4 at 640x480),
     both strides: in f32 every pair equals ``Matcher.estimate_matches``
     on card 0 by the goldens' rules, nothing recorded but the results'
     final ``all_gather_object``; bf16 pairs/s at per_chip_batch 1, 2, 4
     beside world size 1 and the scaling efficiency; B1-B3 launched on
     every rank and held on rank 0; (c) the h1-sharded coarse matcher on
     phase 4's change_stride features (card 0's, broadcast), bf16 and f32:
     coords and valid flags equal ``coarse_matches``', scores rtol 2e-5 /
     atol 1e-6, its collectives per call, B2 and B1 launched on every rank
     and held on rank 0, ms per call beside ``coarse_matches``; (d) the
     point-sharded BA on phase 14's (500, 100000, 6) problem: the first
     step against ``ba_step`` on card 0 by phase 14's rules,
     ``run_dist_ba(max_iters=10, debug_checks=True)`` below 1e-2 of the
     initial cost and within 0.5 relative of ``run_ba``'s, ms and
     collectives per LM iteration (k = 6 minus k = 2) beside a group of
     rank 0 alone; then the scale demo with ``--mesh N`` at its defaults
     by phase 14's rules; (e) the training CLI with ``--mesh N`` (phase
     10's fixture and setting, 1 epoch of 1 step, the validation on):
     ``Mesh:`` in the log, ``last.pt`` and ``immatch_best``, no failed
     validation pair, frozen tensors bit-identical to the ``.pth``, every
     tensor and epoch loss finite; (g1) and (g2) the multi-host entry
     points, the N cards split into two hosts of N / 2 by
     ``CUDA_VISIBLE_DEVICES`` (``--cards 2``: hosts of one card; at
     ``--cards 1`` they print that and run nothing), every process of
     theirs ended at ``MULTI_TIMEOUT`` or as soon as one of them fails,
     a free port picked by binding to port 0 (once more on another where
     it was taken), each rank printing its host, global rank, card
     (``cuda:i`` of its visible cards and the physical index) and
     launches, and no two ranks on one card: (g1) the training CLI under
     a two-node ``torchrun`` (two ``python -m torch.distributed.run
     --nnodes 2 --nproc-per-node N/2 --node-rank k`` launchers, static
     rendezvous at 127.0.0.1, each in a working directory of its own;
     each rank runs ``train.cli.main`` with (e)'s argv and ``--no_eval``
     as ``python -m patch2pix_tpu_torch.train.cli`` would, through
     ``chip_smoke.py --cli-rank``, which adds phase 18's group timeout and
     the rank's report): ``Mesh: N-rank data parallel`` in the log, node
     0's rank 0 alone writing the run directory, B1 and B3 launched on
     every rank, ``last.pt`` held to (e)'s by
     ``tests/test_torch_train_cli.py::test_cli_mesh2_equals_mesh1``'s rule
     (metrics rtol 1e-5, gradients from Adam's first moment within 1e-4
     of the largest, Adam's bound, running averages rtol 1e-5, frozen
     tensors bit-identical), and whether every tensor is ``torch.equal``
     to (e)'s; (g2) ``initialize_multihost("127.0.0.1:P", N, rank)`` and
     ``make_mesh(N)`` in N processes (``chip_smoke.py --tcp-rank``; no
     ``LOCAL_RANK``, so each rank takes its rank modulo its host's cards):
     ``BatchedMatcher`` in f32 on 8 of (b)'s pairs (4 at 1024x768, 4 at
     640x480) at per_chip_batch 1, both strides, by (b)'s rules, B1-B3
     launched on every rank;
     (f) ``parallel.dryrun.dryrun_multichip(N)``
     and its ``[dryrun]`` lines, each rank on its own card. It ends with
     the result line, ``count`` the cards driven.

Each path's launches are counted from zero just before it runs: phase 4
for B1-B3, phase 5 for B4, phase 6 for B5 and B7, phase 10 for B1-B3
under the CLI, phases 11 and 12 for B1 and B2, phase 13 for B1-B3
under the protocols' Matcher, phase 15 for B1-B3 on each sharded path,
phase 16 for B1-B3 under the demo, both models of (c), the synthetic
training demo and the convergence workload.

Needs one CUDA card (N with ``--cards N``), ``nvcc`` and the repository
checkout; imports no JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import importlib
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from patch2pix_tpu_torch.config import ModelConfig, OptimConfig, model_config_from_json
from patch2pix_tpu_torch.data.synthetic import (
    make_pair,
    make_posed_pair,
    oracle_matcher,
    synthetic_batch,
    warp_homography,
    write_megadepth_fixture,
    write_scene_info,
    write_val_dense_fixture,
)
from patch2pix_tpu_torch.data import prep_megadepth_pairs
from patch2pix_tpu_torch.evaluation import demo_matching
from patch2pix_tpu_torch.evaluation import immatch as immatch_module
from patch2pix_tpu_torch.evaluation.hpatches import eval_hpatches
from patch2pix_tpu_torch.evaluation.immatch import eval_immatch_val_sets
from patch2pix_tpu_torch.evaluation.batched import BatchedMatcher
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
from patch2pix_tpu_torch.ops import fine_stage as fine_stage_module
from patch2pix_tpu_torch.ops import patch_gather as patch_gather_module
from patch2pix_tpu_torch.ops.conv4d_mid import _SIGNATURES as CONV4D_MID_SIGNATURES
from patch2pix_tpu_torch.ops.conv4d_mid import conv4d_mid
from patch2pix_tpu_torch.ops.conv4d_small import _SIGNATURES as CONV4D_SIGNATURES
from patch2pix_tpu_torch.ops.conv4d_small import (
    banded_filter,
    conv4d_small,
    conv4d_small_plain,
    mma_fragments,
    staging_mode,
    tf32_smem_bytes,
)
from patch2pix_tpu_torch.ops.corr_pool import STREAM_CLUSTER, kernel_instance
from patch2pix_tpu_torch.ops.corr_pool import _round_up
from patch2pix_tpu_torch.ops.corr_pool import layout as corr_pool_layout
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
    smem_bytes,
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
from patch2pix_tpu_torch.parallel import volume_sharding as volume_sharding_module
from patch2pix_tpu_torch.parallel.comm_stats import format_comm_table, record_collectives
from patch2pix_tpu_torch.parallel.dryrun import dryrun_multichip
from patch2pix_tpu_torch.parallel.mesh import (
    abort_process_group,
    initialize_multihost,
    make_mesh,
    process_group,
    shard_batch,
    spawned_rank,
)
from patch2pix_tpu_torch.parallel.volume_sharding import make_sharded_coarse_matcher
from patch2pix_tpu_torch.data.colmap_model import read_model
from patch2pix_tpu_torch.sfm import ba as ba_module
from patch2pix_tpu_torch.sfm import incremental as incremental_module
from patch2pix_tpu_torch.sfm import scale_demo
from patch2pix_tpu_torch.sfm.ba import build_problem, cost, run_ba
from patch2pix_tpu_torch.sfm.dist_ba import (
    local_problem,
    make_dist_ba_step,
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
from patch2pix_tpu_torch.train import synth_demo
from patch2pix_tpu_torch.train import create_train_state, make_ncn_pretrain_step, make_train_step
from patch2pix_tpu_torch.train.checkpoint import load_ckpt, read_meta, restore_for_eval, save_ckpt
from patch2pix_tpu_torch.train.convergence import RULES, run_convergence
from patch2pix_tpu_torch.train.step import resolve_remat
from patch2pix_tpu_torch.utils import logging as logging_module
from patch2pix_tpu_torch.utils.torch_import import load_ncnet_checkpoint
from tests.ref_loader import seeded_state_dict

# the module (``ops.conv4d`` is the function, as in the JAX package)
conv4d_module = importlib.import_module("patch2pix_tpu_torch.ops.conv4d")

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXDIR = os.path.join(ROOT, "tests", "fixtures")

# published H100 SXM peaks (dense): HBM bytes/s, bf16 tensor-core and
# f32 (non-tensor) FLOP/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# the dense TF32 tensor-core peak: B4's and B5's float32 kernels run three
# TF32 products for each float32 one (3xTF32)
TF32_FLOPS = 495e12

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
PORT_KERNEL_NAMES = ("tap_sum_kernel", "corr_pool_bf16_kernel", "corr_pool_stream_kernel",
                     "corr_pool_f32_kernel",
                     "expand_kernel", "expand_level_kernel", "conv4d_small_tf32_kernel",
                     "conv4d_small_mma_kernel", "conv4d_cin1_kernel", "conv4d_mid_kernel",
                     "fine_head_bf16_kernel",
                     "fine_head_tf32x3_kernel")

# phase 1's ptxas reports, {source: text}, for the kernels built in this run
PTXAS = {}

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
    conv4d_small.tf32_launches = 0
    conv4d_small.channels_last_launches = 0
    conv4d_small.cin1_launches = 0


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
    rows1, rows2, chans, k_major = corr_pool_layout(dtype, c)
    layout_ms = time_ms(lambda: (cell_parity_rows(f1, rows1, chans, k_major),
                                 cell_parity_rows(f2, rows2, chans, k_major)))
    # the kernel alone, by the profiler: mean device ms of 10 calls
    calls = device_ms(lambda: [corr_pool(f1, f2) for _ in range(10)])
    kernel_ms = sum(v for k, v in calls.items() if "corr_pool_" in k) / 10
    flops = 2 * BATCH * (h * w) * (h * w) * c
    b_ms, b_by = bound(nbytes(f1, f2, got), flops, dtype)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, kernel_ms=kernel_ms,
                rows=(_round_up(h * w, rows1), _round_up(h * w, rows2), _round_up(c, chans)),
                shape=f"2x {tuple(f1.shape)} {dtype} -> {tuple(got.shape)} f32, "
                      f"library = {label}, of ms the layout copies {layout_ms:.4f}")


def ptxas_entry(report, kernel):
    """(registers, spill store bytes, spill load bytes) that ``ptxas -v``
    reported for the entry function whose name holds ``kernel``, or None
    where the report has no such entry (a library built earlier)."""
    lines = report.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and kernel in line:
            regs = spills = None
            for nxt in lines[i + 1:]:
                if "Compiling entry" in nxt:
                    break
                if m := re.search(r"Used (\d+) registers", nxt):
                    regs = int(m.group(1))
                if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", nxt):
                    spills = (int(m.group(1)), int(m.group(2)))
            return regs, *(spills or (None, None))
    return None


def log_corr_pool_stream(u, c):
    """The streamed kernel's readings at (BATCH, h, w, c): device ms and
    share of the bound, the operand bytes its design moves from L2 (per
    cluster item the 256 panel rows once, multicast, and two image-2
    tiles; against the replaced design's 256 + 64 rows per 64-row image-2
    tile) and into the SMs (each CTA receives the whole panel), its
    registers and spills and its launch shape."""
    rp1, rp2, cp = u["rows"]
    pair = corr_pool_layout(torch.bfloat16, c)[1]
    items = BATCH * (rp1 // 256) * (rp2 // pair)
    design = items * (256 + pair) * cp * 2
    into_sms = items * STREAM_CLUSTER * (256 + pair // STREAM_CLUSTER) * cp * 2
    before = BATCH * (rp1 // 256) * (rp2 // 64) * 320 * cp * 2
    ptx = ptxas_entry(PTXAS.get("corr_pool", ""), "corr_pool_stream_kernel")
    regs = ("not in this run's build" if ptx is None
            else f"{ptx[0]} registers, spill stores {ptx[1]} B, spill loads {ptx[2]} B")
    log(f"corr_pool streamed kernel: device ms {u['kernel_ms']:.4f} (profiler, mean of 10 "
        f"calls; CUDA events {u['ms']:.4f} ms a wrapper call with its layout copies), "
        f"{u['bound_ms'] / u['kernel_ms']:.1%} of the bound {u['bound_ms']:.4f} "
        f"({u['bound_by']}); operand bytes the design predicts from L2 {design / 1e9:.3f} GB "
        f"({design / u['kernel_ms'] / 1e9:.3f} TB/s at this time; the replaced design "
        f"{before / 1e9:.3f} GB), into the SMs {into_sms / 1e9:.3f} GB "
        f"({into_sms / u['kernel_ms'] / 1e9:.3f} TB/s); ptxas {regs}; cluster "
        f"({STREAM_CLUSTER}, 1, 1), persistent (as many clusters as are resident at once, "
        f"at most one an item), over {items} items of 256 x {pair} raw rows")


# the streamed kernel's shapes in tests/test_torch_card.py: (b, h1, w1,
# h2, w2, c), ragged against its tiles, 9 K blocks, one panel against an
# odd count of image-2 tiles, B = 3
STREAM_CARD_SHAPES = ((2, 18, 26, 22, 30, 512), (1, 10, 14, 6, 70, 448),
                      (2, 24, 32, 24, 32, 1024), (2, 18, 26, 22, 30, 576),
                      (2, 12, 20, 20, 22, 1024), (3, 14, 18, 10, 26, 512))


def check_corr_pool(dtype, gen, dev):
    """B2 at the cs main-path shape, layer3 (B, 96, 128, 256), timed first
    (a profiler session before it would slow the host's launches of its
    short calls below the card's pace); then the upsample-16 shape (B,
    48, 64, 256), which runs it too, and the ResNet101 change_stride
    layer3 (B, 96, 128, 1024) of phase 12's path (bf16 through the
    streamed kernel) are checked and their numbers logged, the streamed
    kernel's readings too; in bf16 the streamed kernel is then held at
    the card tests' shapes."""
    main = corr_pool_case(dtype, gen, dev, H // 8, W // 8)
    log(f"corr_pool {kernel_instance(dtype, 256)} kernel at C = 256: device ms "
        f"{main['kernel_ms']:.4f} (profiler, mean of 10 calls)")
    for tag, h, w, c in (("upsample 16", H // 16, W // 16, 256),
                         ("ResNet101 change_stride", H // 8, W // 8, 1024)):
        u = corr_pool_case(dtype, gen, dev, h, w, c)
        log(f"kernel corr_pool [{str(dtype)[6:]}] {tag}, {u['shape']}: max_abs_err "
            f"{u['max_abs_err']:.3g} ms {u['ms']:.4f} device_ms {u['kernel_ms']:.4f} plain_ms "
            f"{u['plain_ms']:.4f} library_ms {u['library_ms']:.4f} bound_ms "
            f"{u['bound_ms']:.4f} ({u['bound_by']})")
        if kernel_instance(dtype, c) == "streamed":
            log_corr_pool_stream(u, c)
        torch.cuda.empty_cache()
    if dtype == torch.bfloat16:
        errs = []
        for b, h1, w1, h2, w2, c in STREAM_CARD_SHAPES:
            f1, f2 = (l2_normalize(torch.randn(shape, generator=gen, device=dev)).to(dtype)
                      for shape in ((b, h1, w1, c), (b, h2, w2, c)))
            errs.append(hold_corr_pool(f"corr_pool streamed {(b, h1, w1, h2, w2, c)}", f1, f2)[1])
        log(f"corr_pool streamed kernel at the card tests' shapes {STREAM_CARD_SHAPES}: max abs "
            f"err " + " ".join(f"{e:.3g}" for e in errs) + " (<= 1e-4 each)")
    return main


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


def conv4d_small_attrs(cin, cout, out_dtype, mode, dtype=torch.bfloat16):
    """Registers a thread, static shared memory and spill bytes a block of
    B4's kernel for ``dtype`` input (bf16: m16n8k16; float32: 3xTF32
    m16n8k8, whose dynamic shared memory comes fourth) with staging
    ``mode`` (0: any strides, 1: channels-last Cin 4)."""
    lib = _build.library("conv4d", CONV4D_SIGNATURES)
    bf16 = dtype == torch.bfloat16
    vals = [ctypes.c_int() for _ in range(3 if bf16 else 4)]
    entry = lib.p2p_conv4d_small_mma_attrs if bf16 else lib.p2p_conv4d_small_tf32_attrs
    rc = entry(cin, cout, int(out_dtype == torch.bfloat16), mode,
               *(ctypes.addressof(v) for v in vals))
    _build.check_launch(rc, "conv4d_small attributes")
    regs, smem, *dyn, local = [v.value for v in vals]
    return (regs, smem, local) if bf16 else (regs, smem, local, dyn[0])


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
    64, 4); bf16 in and out (the NCN's intermediate; the m16n8k16
    kernel), or float32 (the 3xTF32 m16n8k8 kernel). Held and timed on
    two layouts of the same values: the contiguous channels-last volume,
    which the NCN's fold-in leaves (the conv4d path's input, phase 5; its
    time is the kernel's number), and the NCHW-per-cell view."""
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
        tf0 = conv4d_small.tf32_launches
        got = conv4d_small(xin, w, b, dtype)
        if (conv4d_small.mma_launches - mma0 != mma
                or conv4d_small.tf32_launches - tf0 != 1 - mma
                or conv4d_small.channels_last_launches - cl0 != mode):
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
        else:
            regs, smem, local, dyn = conv4d_small_attrs(cin, cout, dtype, mode, dtype)
            if dyn != tf32_smem_bytes(cin, cout):
                fail(f"conv4d_small f32: the kernel launches with {dyn} B of dynamic shared "
                     f"memory, the plan in ops/conv4d_small.py {tf32_smem_bytes(cin, cout)}")
            dev_ms = sum(v for k, v in device_ms(lambda: conv4d_small(xin, w, b, dtype)).items()
                         if "conv4d_small_tf32_kernel" in k)
            ptx = ptxas_entry(PTXAS.get("conv4d", ""),
                              f"conv4d_small_tf32_kernelIfLi{cin}ELi{cout}ELi{mode}E")
            spills = ("spills not in this run's build" if ptx is None
                      else f"spill stores {ptx[1]} B, spill loads {ptx[2]} B")
            note += (f" (device {dev_ms:.4f} ms; {errs[-1] / 1e-4:.3g} of the 1e-4 rule; "
                     f"staging mode {mode}: {regs} registers a thread, {dyn} B dynamic + "
                     f"{smem} B static shared memory a block, {local} B local, {spills})")
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
    if not mma:
        # 3xTF32: bound by three TF32 products a float32 one (or the
        # bytes); the SIMT kernel it replaced, by the f32 pipes
        simt_ms = b_ms
        b_ms, b_by = max((nbytes(x, w, b, want) / HBM_BPS * 1e3, "bytes"),
                         (3 * flops / TF32_FLOPS * 1e3, "operations"))
        notes.append(f"3xTF32 on mma.sync m16n8k8: channels-last "
                     f"{100 * simt_ms / ms:.1f}% of the f32 SIMT bound {simt_ms:.4f} ms, "
                     f"NCHW {100 * b_ms / times[1]:.1f}% of the 3xTF32 bound")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None,
                shape=f"x {tuple(x.shape)} {dtype} -> 4 channels {want.dtype}; "
                      f"{'; '.join(notes)}; channels-last {100 * b_ms / ms:.1f}% of its bound; "
                      f"library: none; yardstick conv4d_xla_taps (nine cuDNN convs) "
                      f"{taps_ms:.4f} ms")


def check_conv4d_cin1(gen, dev):
    """B4's Cin-1 kernel, the NCN's bf16 first layer, at the cells'
    volumes: 1 -> 16 on (2, 48, 64, 48, 64) (Patch2Pix change_stride) and
    1 -> 10 on (1, 48, 64, 48, 64) (ImMatchNet), bf16 in and out, staged
    16 bytes at a time. Held against its plain version (one bf16 ulp +
    1e-5); device ms by the profiler beside the bytes bound (the input
    read once, the output written once); the fold-in's ms on the same
    inputs (the route it replaces); the plain version's ms; registers,
    shared memory and spills."""
    lib = _build.library("conv4d", CONV4D_SIGNATURES)
    for bs, cout in ((BATCH, 16), (1, 10)):
        dims = (bs, H // 16, W // 16, H // 16, W // 16)
        x = (torch.rand(dims + (1,), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
        w = torch.randn((3, 3, 3, 3, 1, cout), generator=gen, device=dev) * (2 / 81) ** 0.5
        b = torch.randn((cout,), generator=gen, device=dev) * 0.05
        want = conv4d_small_plain(x, w, b, torch.bfloat16)
        c0 = conv4d_small.cin1_launches
        got = conv4d_small(x, w, b, torch.bfloat16)
        if conv4d_small.cin1_launches != c0 + 1 or staging_mode(x) != 2:
            fail(f"conv4d_small 1->{cout}: the Cin-1 kernel did not run, staging 16 bytes at "
                 f"a time")
        torch.cuda.synchronize()
        ulps = bf16_ulps(got.float(), want.float(), atol=1e-5)
        if ulps.max().item() > 1:
            fail(f"conv4d_small 1->{cout}: {int((ulps > 1).sum())} values beyond one bf16 "
                 f"ulp + 1e-5")
        ms = time_ms(lambda: conv4d_small(x, w, b, torch.bfloat16))
        dev_ms = sum(v for k, v in device_ms(lambda: conv4d_small(x, w, b, torch.bfloat16))
                     .items() if "conv4d_cin1_kernel" in k)
        plain_ms = time_ms(lambda: conv4d_small_plain(x, w, b, torch.bfloat16), iters=2, warmup=1)
        wb = w.to(torch.bfloat16)
        fold_ms = time_ms(lambda: conv4d_module.conv4d_fold_in(x, wb, b, torch.bfloat16))
        b_ms, b_by = bound(nbytes(x, w, b, want), 2 * x.numel() * 81 * cout, torch.bfloat16)
        vals = [ctypes.c_int() for _ in range(3)]
        _build.check_launch(lib.p2p_conv4d_cin1_attrs(cout, 1, 2, *(ctypes.addressof(v)
                                                                    for v in vals)),
                            "conv4d_small Cin-1 attributes")
        regs, smem, local = (v.value for v in vals)
        ptx = ptxas_entry(PTXAS.get("conv4d", ""),
                          f"conv4d_cin1_kernelI13__nv_bfloat16Li{cout}ELi2E")
        spills = ("spills not in this run's build" if ptx is None
                  else f"spill stores {ptx[1]} B, spill loads {ptx[2]} B")
        log(f"kernel conv4d_small Cin 1 [bfloat16] x {tuple(x.shape)} -> {cout} channels "
            f"bf16, channels-last: max ulps {ulps.max().item():.2f}; ms {ms:.4f} (device "
            f"{dev_ms:.4f}) bound_ms {b_ms:.4f} ({b_by}), {100 * b_ms / dev_ms:.1f}% of it "
            f"by device ms; plain_ms {plain_ms:.4f}; the fold-in it replaces {fold_ms:.4f} ms; "
            f"{regs} registers a "
            f"thread, {smem} B shared memory a block, {local} B local, {spills}")


def check_conv4d_mid(gen, dev):
    """B4's C -> C kernel, the NCN's bf16 middle layer, at the cells'
    volumes: 16 -> 16 on (1, 75, 100, 75, 100) (NCNet InLoc at 3200x2400)
    and 10 -> 10 on (1, 48, 64, 48, 64) (ImMatchNet at 1024x768), bf16 in
    and out, channels-last, both symmetric directions' filters. Held
    against its plain version (one bf16 ulp + 1e-5); device ms by the
    profiler beside its bound (operations at the bf16 peak or the input
    read once and the output written once, the larger); the plain
    version's ms; the nine-conv loop's ms on the same inputs (the route
    it replaces, which the port no longer calls for these layers on the
    card: the yardstick); registers, shared memory and spills."""
    lib = _build.library("conv4d_mid", CONV4D_MID_SIGNATURES)
    bf16 = torch.bfloat16
    for dims, c in (((1, 75, 100, 75, 100), 16), ((1, H // 16, W // 16, H // 16, W // 16), 10)):
        # the NCN's middle input is a ReLU's output
        x = torch.rand(dims + (c,), generator=gen, device=dev).to(bf16)
        w = torch.randn((3, 3, 3, 3, c, c), generator=gen, device=dev) / (81 * c) ** 0.5
        b = torch.randn((c,), generator=gen, device=dev) * 0.1
        worst = 0.0
        for wt in (w, w.permute(2, 3, 0, 1, 4, 5)):
            want = conv4d_small_plain(x, wt, b, bf16)
            n0 = conv4d_mid.launches
            got = conv4d_mid(x, wt, b, bf16)
            if conv4d_mid.launches != n0 + 1:
                fail(f"conv4d_mid {c}->{c}: the kernel did not run")
            torch.cuda.synchronize()
            ulps = bf16_ulps(got.float(), want.float(), atol=1e-5)
            worst = max(worst, ulps.max().item())
            if worst > 1:
                fail(f"conv4d_mid {c}->{c}: {int((ulps > 1).sum())} values beyond one bf16 ulp "
                     f"+ 1e-5")
            del got
        ms = time_ms(lambda: conv4d_mid(x, w, b, bf16), iters=10)
        dev_ms = sum(v for k, v in device_ms(lambda: conv4d_mid(x, w, b, bf16)).items()
                     if "conv4d_mid_kernel" in k)
        plain_ms = time_ms(lambda: conv4d_small_plain(x, w, b, bf16), iters=1, warmup=1)
        wb = w.to(bf16)
        loop_ms = time_ms(lambda: conv4d_module.conv4d_xla_taps(x, wb, b, bf16), iters=3,
                          warmup=1)
        b_ms, b_by = bound(nbytes(x, want), 2 * x.numel() * 81 * c, bf16)
        vals = [ctypes.c_int() for _ in range(3)]
        _build.check_launch(lib.p2p_conv4d_mid_attrs(c, 1, *(ctypes.addressof(v)
                                                             for v in vals)),
                            "conv4d_mid attributes")
        regs, smem, local = (v.value for v in vals)
        ptx = ptxas_entry(PTXAS.get("conv4d_mid", ""), f"conv4d_mid_kernelILi{c}E13__nv_bfloat16")
        spills = ("spills not in this run's build" if ptx is None
                  else f"spill stores {ptx[1]} B, spill loads {ptx[2]} B")
        log(f"kernel conv4d_mid [bfloat16] x {tuple(x.shape)} -> {c} channels bf16, "
            f"channels-last: max ulps {worst:.2f}; ms {ms:.4f} (device {dev_ms:.4f}) bound_ms "
            f"{b_ms:.4f} ({b_by}), {100 * b_ms / dev_ms:.1f}% of it by device ms; plain_ms "
            f"{plain_ms:.4f}; yardstick, the nine-conv loop it replaces {loop_ms:.4f} ms; "
            f"{regs} registers a thread, {smem} B dynamic shared memory a block, {local} B "
            f"local, {spills}")
        del x, want
        torch.cuda.empty_cache()


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
    """B2's backward at the features' shapes (an h1 slice of feat1 on a
    sharded path)."""
    b, h1, w1, _ = f1.shape
    _, h2, w2, _ = f2.shape
    g = torch.randn((b, h1 // 2, w1 // 2, h2 // 2, w2 // 2), generator=gen, device=f1.device)
    same = backward_routes(corr_pool, corr_pool_plain, (f1, f2), (g,))
    ms = time_ms(lambda: corr_pool_backward(f1, f2, g), iters=5, warmup=1)
    shapes = (f"2x {tuple(f1.shape)}" if f1.shape == f2.shape
              else f"{tuple(f1.shape)} and {tuple(f2.shape)}")
    return same, ms, f"g {tuple(g.shape)} f32 -> {shapes} {f1.dtype}"


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
    io_bytes = rows_bytes + nbytes(y1, x1, y2, x2, inv1, inv2, partial0, *w0, wc1, *bn0, *bn1,
                                   got)
    b_ms, b_by = bound(io_bytes, flops, dtype)
    # the wrapper's device time by kernel: conv0 and conv1 launches, the
    # weights' layout copies (and in float32 their TF32 split)
    split = device_ms(lambda: fused_fine_head(*args))
    note += ", device ms " + ", ".join(
        f"{'conv1' if '<true>' in k else 'conv0' if '<false>' in k else k[:40]} {v:.4f}"
        for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
    lib = _build.library("fine_head", FINE_HEAD_SIGNATURES)
    if dtype == torch.bfloat16:
        note += f", {lib.p2p_fine_head_bf16_smem()} B shared memory a block"
    else:
        # 3xTF32: bound by three TF32 products a float32 one (or the
        # bytes); the SIMT kernel it replaced, by the f32 pipes
        simt_ms = b_ms
        b_ms, b_by = max((io_bytes / HBM_BPS * 1e3, "bytes"),
                         (3 * flops / TF32_FLOPS * 1e3, "operations"))
        kernel_ms = sum(v for k, v in split.items() if "fine_head_tf32x3_kernel" in k)
        smem = lib.p2p_fine_head_smem()
        if smem != smem_bytes(torch.float32):
            fail(f"fused_fine_head f32: the kernel asks for {smem} B of shared memory, the "
                 f"plan in ops/fine_stage.py {smem_bytes(torch.float32)}")
        ptx = [ptxas_entry(PTXAS.get("fine_head", ""), f"fine_head_tf32x3_kernelILb{i}")
               for i in (0, 1)]
        regs = ("registers not in this run's build" if None in ptx else "; ".join(
            f"{name} {p[0]} registers, spill stores {p[1]} B, spill loads {p[2]} B"
            for name, p in zip(("conv0", "conv1"), ptx)))
        big = want.abs() >= 1e-2
        rel = (diff[big] / want.abs()[big]).max().item()
        rule = (diff / (2e-4 + 2e-4 * want.abs())).max().item()
        note += (f"; 3xTF32 on wgmma: the two launches' device ms {kernel_ms:.4f}, "
                 f"{100 * b_ms / ms:.1f}% of the 3xTF32 bound {b_ms:.4f} ms by CUDA events "
                 f"({100 * b_ms / kernel_ms:.1f}% by device ms), "
                 f"{100 * simt_ms / ms:.1f}% of the f32 SIMT bound {simt_ms:.4f} ms; "
                 f"{smem} B shared memory a block; {regs}; max rel err {rel:.3g} (|ref| >= "
                 f"1e-2), {rule:.3g} of the rtol/atol 2e-4 rule")
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


def seeded_ncn(dev, channels=(4, 4, 1), seed=3, dtype=torch.bfloat16):
    """A symmetric NeighConsensus in ``dtype`` with seeded fan-in-scaled
    weights."""
    rs = np.random.RandomState(seed)
    ncn = NeighConsensus(kernel_sizes=(3,) * len(channels), channels=channels,
                         dtype=dtype, device=dev)
    sd, cin = {}, 1
    for li, cout in enumerate(channels):
        w = rs.randn(3, cout, cin, 3, 3, 3) * (2.0 / (81 * cin)) ** 0.5
        sd[f"conv.{2 * li}.weight"] = torch.from_numpy(w.astype(np.float32))
        sd[f"conv.{2 * li}.bias"] = torch.from_numpy((rs.randn(cout) * 0.05).astype(np.float32))
        cin = cout
    ncn.load_state_dict(sd)
    return ncn


def conv4d_path(dev):
    """Phase 5: NCN (4, 4, 1) on the change_stride volume, bf16: B4 four
    times a call, the 1->4 first layer on its Cin-1 kernel and the 4->4
    layer on its tensor-core kernel staging the first layer's
    channels-last volume, once per branch each. Rule for
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
    expect = {**{k: 0 for k in launches}, "conv4d_small": 4, "tap_sum": 2}
    staged, cin1 = conv4d_small.channels_last_launches, conv4d_small.cin1_launches
    if launches != expect or conv4d_small.mma_launches != 2 or staged != 2 or cin1 != 2:
        fail(f"conv4d path launches {launches} ({cin1} through B4's Cin-1 kernel, "
             f"{conv4d_small.mma_launches} through its 4->4 tensor-core kernel, {staged} "
             f"staging channels-last), expected {expect}, the first layer twice on the Cin-1 "
             f"kernel, the 4->4 layer twice on the tensor cores staging channels-last")
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
        f"{launches} (B4: the first layer twice on its Cin-1 kernel, the 4->4 layer twice "
        f"staging channels-last); max abs err to the "
        f"plain-B4 run {err:.3g} (max |ref| {scale:.3g}), "
        f"{off} of {diff.numel()} values off by more than 2^-7 of it; "
        f"{ms:.3f} ms per call (plain B4 {plain_ms:.3f} ms)")
    conv4d_path_f32(dev, corr)

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


def conv4d_path_f32(dev, corr):
    """Phase 5 in float32 (TF32 off for cuDNN's fold-in and fold-out): the
    same NCN (4, 4, 1) on the same volume; B4 twice on its 3xTF32 kernel,
    staging the fold-in's channels-last volume, and B1 twice. Rule, as
    ``tests/test_torch_conv4d_small.py::test_ncn_441_matches_jax`` on the
    CPU: max abs err to the plain-B4 run <= 1e-5 of max |ref|."""
    ncn = seeded_ncn(dev, dtype=torch.float32)
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        got = ncn(corr)
    torch.cuda.synchronize()
    launches = counts()
    expect = {**{k: 0 for k in launches}, "conv4d_small": 2, "tap_sum": 2}
    tf32, staged = conv4d_small.tf32_launches, conv4d_small.channels_last_launches
    if launches != expect or tf32 != 2 or staged != 2:
        fail(f"conv4d path f32: launches {launches} ({tf32} through B4's 3xTF32 kernel, "
             f"{staged} staging channels-last), expected {expect}, both B4 launches on the "
             f"3xTF32 kernel staging the fold-in's channels-last volume")
    if got.shape != corr.shape or got.dtype != torch.float32 or not torch.isfinite(got).all():
        fail(f"conv4d path f32: output {tuple(got.shape)} {got.dtype} or non-finite values")
    with torch.no_grad(), plain_b4():
        want = ncn(corr)
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    if not err <= 1e-5 * scale:
        fail(f"conv4d path f32: max abs err {err} > 1e-5 of max |ref| {scale}")
    with torch.no_grad():
        ms = time_ms(lambda: ncn(corr), iters=5)
        b4_ms = sum(v for k, v in device_ms(lambda: ncn(corr)).items()
                    if "conv4d_small_tf32_kernel" in k)
        with plain_b4():
            plain_ms = time_ms(lambda: ncn(corr), iters=2, warmup=1)
    log(f"conv4d path [NCN (4, 4, 1) symmetric f32, TF32 off, on {tuple(corr.shape)}]: "
        f"launches per call {launches} (both B4 launches on the 3xTF32 kernel staging "
        f"channels-last); max abs err to the plain-B4 run {err:.3g} (max |ref| {scale:.3g}, "
        f"{err / scale:.3g} of it; rule 1e-5); {ms:.3f} ms per call, B4 {b4_ms:.4f} device "
        f"ms of it (plain B4 {plain_ms:.3f} ms)")


def fine_head_path(dev):
    """Phase 6: the fine stage of a full-width FeatRegressNet with the
    seeded ``regress_fine`` weights, fused and unfused, in bf16 and in
    float32 (TF32 off: B5's 3xTF32 kernel against cuDNN's float32
    convolutions). Rules: float32 pooled features within rtol/atol 2e-4
    of each other, and the float32 (M, 5) outputs within rtol/atol 2e-3:
    both runs share fc_head, so the outputs differ only by what the
    pooled difference becomes through its three layers, which may widen
    it (the run prints by how much: max |out diff| / max |pooled diff|),
    but not tenfold; in bf16, against the float32
    unfused outputs on the same rows, the fused (M, 5) error is at most
    twice the unfused one's at the median and the 99th percentile, and
    at most four times at the maximum."""
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
        reset_counts()
        fp32, fo32 = fused(torch.float32)
        torch.cuda.synchronize()
        launches32 = counts()
        up32, uo32 = unfused(torch.float32)
        torch.cuda.synchronize()
    expect = {**{k: 0 for k in launches}, "expand_level": 10, "fused_fine_head": 1}
    expect_u = {**{k: 0 for k in launches}, "expand_scale_pair": 1}
    if launches != expect or launches32 != expect or unfused_launches != expect_u:
        fail(f"fine-head path launches {launches} (f32 {launches32}) / {unfused_launches}, "
             f"expected {expect} / {expect_u}")
    for name, t in (("fused", fo), ("unfused", uo), ("fused f32", fo32)):
        if t.shape != (m, 5) or not torch.isfinite(t).all():
            fail(f"fine-head path: {name} outputs {tuple(t.shape)} or non-finite")
    bad = (fp32 - up32).abs() > 2e-4 + 2e-4 * up32.abs()
    if bad.any():
        fail(f"fine-head path f32: {int(bad.sum())} pooled values beyond rtol/atol 2e-4 "
             f"(max abs err {(fp32 - up32).abs().max().item()})")
    pooled_err = (fp32 - up32).abs().max().item()
    out_err = (fo32 - uo32).abs().max().item()
    bad = (fo32 - uo32).abs() > 2e-3 + 2e-3 * uo32.abs()
    if bad.any():
        fail(f"fine-head path f32: {int(bad.sum())} (M, 5) values beyond rtol/atol 2e-3 "
             f"(max abs err {out_err})")
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
        ms_f32 = time_ms(lambda: fused(torch.float32), iters=5)
        ms_u32 = time_ms(lambda: unfused(torch.float32), iters=5)
        rows32 = [[x.float() for x in side] for side in rows]
        hargs32 = head_args(nets[torch.float32], *rows32, *corners, PSIZE)
        split32 = (time_ms(lambda: head_args(nets[torch.float32], *rows32, *corners, PSIZE),
                           iters=5),
                   time_ms(lambda: fused_fine_head(*hargs32), iters=5),
                   time_ms(lambda: nets[torch.float32].fc_head(fp32), iters=5))
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
    log(f"fine-head path [M={m}, F={F_REG}, f32, TF32 off]: launches fused {launches32}; "
        f"pooled fused vs unfused max abs err {pooled_err:.3g}, (M, 5) {out_err:.3g} "
        f"(fc_head widens it {out_err / max(pooled_err, 1e-30):.3g}x; max |out| "
        f"{uo32.abs().max().item():.3g}); "
        f"{ms_f32:.3f} ms per call fused (prolog {split32[0]:.3f} + B5 {split32[1]:.3f} + "
        f"fc_head {split32[2]:.3f}), {ms_u32:.3f} ms unfused (B3 + forward)")
    log(f"fine-head path [M={m}, F={F_REG}, bf16]: launches fused {launches}, unfused "
        f"{unfused_launches}; "
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


def cli_argv(fixture, out_dir, epochs, *extra, steps=CLI_STEPS):
    data_root, pair_root, npy, _ = fixture
    return ["--data_root", data_root, "--pair_root", pair_root, "--match_npy", npy,
            "--out_dir", out_dir, "--change_stride", "--batch", str(TRAIN_BATCH), "--ptmax",
            str(PTMAX), "--ksize", "2", "--dtype", "bfloat16", "--no_eval", "--epochs",
            str(epochs), "--steps_per_epoch", str(steps), *extra]


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
    ``corr_to_matches`` (mutual) timed, B1's and B4's launches per call
    (2 each; B4 the first layer on its Cin-1 kernel) and B1's first call
    held against its plain version, the profiler's table;
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
    mid0 = conv4d_mid.launches
    with capture_inputs(((conv4d_module, "tap_sum"),), keep=1) as captured:
        grid, scores, mutual = call()
        torch.cuda.synchronize()
    launches = counts()
    expect = {**{k: 0 for k in launches}, "tap_sum": 2, "conv4d_small": 2}
    if launches != expect or conv4d_small.cin1_launches != 2:
        fail(f"immatch: launches per call {launches} ({conv4d_small.cin1_launches} of B4's "
             f"on its Cin-1 kernel), expected {expect}, both B4 launches the NCN's first layer")
    if conv4d_mid.launches != mid0 + 2:
        fail(f"immatch: {conv4d_mid.launches - mid0} launches of B4's C -> C kernel a call, "
             f"expected 2 (the NCN's 10 -> 10 layer, both directions)")
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
    weights and images: bf16 launches B2 at C = 1024 once, B1 twice and
    B4's Cin-1 kernel twice a call (B1's and B2's first calls held as in
    phase 2), timed; then the same
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
    expect = {**{k: 0 for k in launches}, "tap_sum": 2, "corr_pool": 1, "conv4d_small": 2}
    f1 = captured["corr_pool"][0][0]
    if (launches != expect or conv4d_small.cin1_launches != 2 or f1.shape[-1] != 1024
            or f1.dtype != torch.bfloat16):
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


def sfm_demo_path(cams=50, pts=5000, mesh=1, group_timeout=None):
    """Phase 14 (c), and phase 18 (d) with ``mesh`` 4: the scale demo at
    its defaults (``cams``, ``pts``) through its ``main``, ``--mesh
    mesh`` on the card(s); ``group_timeout``: its process group's."""
    shutil.rmtree(SFM_DIR, ignore_errors=True)
    with counting(incremental_module, "ransac_essential", "ransac_pnp",
                  "run_ba") as inc, \
            counting(ba_module, "ba_step") as steps, \
            counting(native_module, "build_tracks_native") as nat, \
            counting(scale_demo, "make_scale_scene", "run_dist_ba_ranks") as demo:
        summary = scale_demo.main(["--cams", str(cams), "--pts", str(pts), "--mesh",
                                   str(mesh), "--out", SFM_DIR], group_timeout=group_timeout)
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
    log(f"sfm demo [{cams} cams, {pts} pts, 0.4 px, 5% outliers, pair gap 5, ba_every 10, "
        f"mesh {mesh}, {summary['device']}, {summary['power_limit']}]: {summary['points']} "
        f"points, ATE "
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


# ------------------------------------------------------------ phase 15

BATCHED_DIR = os.path.join(ROOT, "build", "chip_smoke_batched")
# (a)'s pairs: 8 at the main path's size and 2 smaller (a second bucket)
BATCHED_PAIRS = ((W, H, 8), (640, 480, 2))


def write_batched_pairs(root, sizes=BATCHED_PAIRS):
    """Seeded noise PNG pairs, as ``sizes`` ((w, h, count) each) says."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    pairs, seed = [], 100
    for w, h, n in sizes:
        for _ in range(n):
            paths = []
            for _ in range(2):
                im = seeded_images(1, h, w, seed)[0]
                seed += 1
                paths.append(os.path.join(root, f"{seed}.png"))
                Image.fromarray(np.clip((im * 0.25 + 0.45) * 255, 0, 255).astype(np.uint8)
                                ).save(paths[-1])
            pairs.append(tuple(paths))
    return pairs


def hold_pair_parity(tag, got, want):
    """The goldens' rules on one pair's (matches, scores, coarse): the
    same coarse row set, matches within 0.05 px and scores within 5e-3.
    Returns (rows, max coord err, max score err)."""
    order = [np.lexsort(np.asarray(o[2]).T[::-1]) for o in (got, want)]
    g, w = ([np.asarray(a)[i] for a in o] for o, i in zip((got, want), order))
    if len(g[0]) != len(w[0]) or not np.array_equal(g[2], w[2]):
        fail(f"{tag}: coarse row sets differ ({len(g[0])} vs {len(w[0])} rows)")
    ce = float(np.abs(g[0] - w[0]).max()) if len(g[0]) else 0.0
    se = float(np.abs(g[1] - w[1]).max()) if len(g[0]) else 0.0
    if ce > 0.05 or se > 5e-3:
        fail(f"{tag}: coords err {ce:.3g} px, scores err {se:.3g}")
    return len(g[0]), ce, se


def batched_path(dev, sd, mesh, main_pairs_s):
    """Phase 15 (a): ``BatchedMatcher`` on 10 PNG pairs in two buckets."""
    pairs = write_batched_pairs(BATCHED_DIR)
    kw = dict(ksize=2, io_thres=0.25, imsize=1024, fine_cap=FINE_CAP)
    total = {}
    for cs in (True, False):
        tag = "change_stride" if cs else "upsample 16"
        model = build_model(cs, sd, "float32", dev)
        bm = BatchedMatcher(model, mesh=mesh, **kw)
        with record_collectives() as comm:
            out = bm.match_pairs(pairs)
        if comm:
            fail(f"batched {tag}: collectives recorded while matching: {comm}")
        matcher = Matcher(model, **kw)
        errs = [hold_pair_parity(f"batched {tag} f32 pair {i}", got,
                                 matcher.estimate_matches(*pair))
                for i, (got, pair) in enumerate(zip(out, pairs))]
        log(f"batched {tag} [f32, TF32 off, imsize 1024, per_chip_batch "
            f"{bm.per_chip_batch}, {len(pairs)} pairs in buckets of "
            + " and ".join(f"{n} ({w}x{h})" for w, h, n in BATCHED_PAIRS) + "]: "
            f"every pair equals Matcher.estimate_matches (rows " + " ".join(
                str(e[0]) for e in errs) + f"; max coord err {max(e[1] for e in errs):.3g} "
            f"px, max score err {max(e[2] for e in errs):.3g}); collectives: none")
        del model, bm, matcher
        torch.cuda.empty_cache()

        model = build_model(cs, sd, "bfloat16", dev)
        rates = {}
        for pcb in (1, 2, 4):
            bm = BatchedMatcher(model, mesh=mesh, per_chip_batch=pcb, **kw)
            bm.match_pairs(pairs[:1])  # warm up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bm.match_pairs(pairs)
            rates[pcb] = len(pairs) / (time.perf_counter() - t0)
        reset_counts()
        with capture_inputs(keep=1) as captured, record_collectives() as comm:
            BatchedMatcher(model, mesh=mesh, **kw).match_pairs(pairs)
        launches = {k: v for k, v in counts().items() if v}
        if comm or not all(launches.get(k, 0) > 0
                           for k in ("tap_sum", "corr_pool", "expand_scale_pair")):
            fail(f"batched {tag} bf16: launches {launches}, collectives {comm}")
        hold_path_calls(f"batched {tag} bf16", outside_inference(captured),
                        torch.Generator(device=dev).manual_seed(5))
        log(f"batched {tag} [bf16]: pairs/s over the {len(pairs)} pairs (PNG decode and resize "
            f"included) at per_chip_batch 1 / 2 / 4: " + " / ".join(
                f"{rates[k]:.2f}" for k in (1, 2, 4)) + f"; phase 4's predict_fine at B=2 "
            f"{main_pairs_s[cs]:.2f} pairs/s; launches over the pairs {launches}; "
            f"collectives: none")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del model
        torch.cuda.empty_cache()
    shutil.rmtree(BATCHED_DIR, ignore_errors=True)
    return total


def state_gap(got, want):
    """Max abs difference over matching tensors of two dicts (0.0 when
    every one is torch.equal)."""
    return max(float((got[k].float() - v.float()).abs().max()) for k, v in want.items())


def sharded_train_path(dev, sd, mesh, train_ms):
    """Phase 15 (b): one step over the mesh against ``make_train_step``
    without one, from a copy of the same state and rand, then ms per
    step, f32 then bf16. The control is ``make_train_step`` twice
    without a mesh: how far the step differs from itself, with cuDNN's
    default algorithms (some f32 backward ones are not deterministic) and
    with its deterministic ones, under which the comparison runs."""
    batches = train_batches(dev, n=1)
    cells = (TRAIN_H // 8 // 2) * (TRAIN_W // 8 // 2)
    rand = torch.rand((TRAIN_BATCH, 2 * cells), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(7))
    kw = dict(ksize=2, ptmax=PTMAX, remat="auto")
    total = {}
    for dtype in ("float32", "bfloat16"):
        tag = f"sharded train [{dtype}]"
        runs = {}
        for name in ("default", "default control", "single", "control", "sharded"):
            torch.backends.cudnn.deterministic = not name.startswith("default")
            model = seeded_model(sd, dtype, dev)
            state = create_train_state(model, OptimConfig(lr_init=5e-4))
            step = (make_train_step(model, state.optimizer, mesh=mesh, debug_checks=True, **kw)
                    if name == "sharded" else make_train_step(model, state.optimizer, **kw))
            batch = shard_batch(batches[0], mesh) if name == "sharded" else batches[0]
            reset_counts()
            with capture_inputs(keep=1) as captured, record_collectives() as comm:
                state, met = step(state, batch, rand=rand)
                torch.cuda.synchronize()
            torch.backends.cudnn.deterministic = False
            runs[name] = ({k: v.detach().clone() for k, v in model.state_dict().items()},
                          {k: float(v) for k, v in met.items()}, comm,
                          {k: v for k, v in counts().items() if v},
                          {k: p.grad.clone() for k, p in model.named_parameters()
                           if p.grad is not None})
            if name == "sharded":
                launches = runs[name][3]
                if not (launches.get("tap_sum", 0) > 0
                        and launches.get("expand_scale_pair", 0) > 0):
                    fail(f"{tag}: B1 and B3 must launch in a step: {launches}")
                hold_path_calls(tag, captured, torch.Generator(device=dev).manual_seed(6))
                n_grad = sum(p.numel() for p in model.parameters() if p.requires_grad)
                # timed with cuDNN's default algorithms, as phase 7 is
                times = []
                for _ in range(6):
                    t0 = time.perf_counter()
                    state, _ = step(state, batch, rand=rand)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                ms = float(np.median(times[1:]))
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
            del captured, model, state, step
            torch.cuda.empty_cache()
        (sd_s, met_s, comm, _, g_s), (sd_1, met_1, _, _, g_1) = runs["sharded"], runs["single"]
        sd_c, g_c = runs["control"][0], runs["control"][4]
        (sd_d, g_d), (sd_dc, g_dc) = ((runs[k][0], runs[k][4])
                                      for k in ("default", "default control"))
        if set(comm) != {"all-reduce"}:
            fail(f"{tag}: collectives other than all-reduce: {comm}")
        if met_s.keys() != met_1.keys() or any(
                abs(met_s[k] - v) > 1e-6 + 1e-5 * abs(v) for k, v in met_1.items()):
            fail(f"{tag}: metrics differ from make_train_step's: {met_s} vs {met_1}")
        if g_s.keys() != g_1.keys():
            fail(f"{tag}: other parameters have gradients")
        equal = all(torch.equal(sd_s[k], v) for k, v in sd_1.items())
        # parameters and running averages: torch.equal, or in f32 within
        # rtol 1e-5 / atol 1e-6
        close = all(torch.allclose(sd_s[k].float(), v.float(), rtol=1e-5, atol=1e-6)
                    for k, v in sd_1.items())
        control = (f"the control, make_train_step twice: state max abs diff "
                   f"{state_gap(sd_c, sd_1):.3g}, gradients {state_gap(g_c, g_1):.3g}; with "
                   f"cuDNN's default algorithms {state_gap(sd_dc, sd_d):.3g} and "
                   f"{state_gap(g_dc, g_d):.3g}")
        if not (equal or dtype == "float32" and close):
            fail(f"{tag}: against make_train_step without a mesh: state max abs diff "
                 f"{state_gap(sd_s, sd_1):.3g}, gradients {state_gap(g_s, g_1):.3g}; "
                 + control)
        log(f"{tag} [ResNet34 change_stride {TRAIN_W}x{TRAIN_H} B={TRAIN_BATCH} ptmax={PTMAX} "
            f"panc 8, world size 1 over NCCL]: one step over the mesh against make_train_step "
            f"without one, from the same state and rand, cuDNN deterministic: parameters and "
            f"running averages "
            + ("torch.equal" if equal else
               f"within rtol 1e-5 / atol 1e-6 (max abs diff {state_gap(sd_s, sd_1):.3g}, "
               f"gradients {state_gap(g_s, g_1):.3g})")
            + f"; {control}; metrics equal within rtol 1e-5; ms/step median {ms:.2f} of 5 "
            f"(phase 7's make_train_step {train_ms[dtype]:.2f}); collectives per step: "
            + ", ".join(f"{k} x{v['count']} {v['bytes']} bytes" for k, v in comm.items())
            + f", of which the gradient buffer {4 * n_grad} bytes ({n_grad} trainable "
            f"values); launches per step {runs['sharded'][3]}")
    return total


def sharded_coarse_path(dev, sd, mesh, ims):
    """Phase 15 (c): the h1-sharded coarse matcher on phase 4's
    change_stride features, bf16 and f32."""
    total = {}
    for dtype in ("bfloat16", "float32"):
        model = build_model(True, sd, dtype, dev)
        with torch.inference_mode():
            f1, f2 = (f[-1] for f in model.extract_pyramid_pair(ims[0], ims[1]))
        fn = make_sharded_coarse_matcher(model, mesh, ksize=2)

        def single():
            with torch.inference_mode():
                return model.coarse_matches(*model.coarse_corr(f1, f2, 2), 2)

        want = single()
        reset_counts()
        with capture_inputs(sites=((conv4d_module, "tap_sum"),
                                   (volume_sharding_module, "corr_pool")),
                            keep=1) as captured, record_collectives() as comm:
            got = fn(f1, f2)
            torch.cuda.synchronize()
        launches = {k: v for k, v in counts().items() if v}
        tag = f"sharded coarse [{dtype}]"
        if not (launches.get("tap_sum", 0) > 0 and launches.get("corr_pool", 0) > 0):
            fail(f"{tag}: B1 and B2 must launch: {launches}")
        hold_path_calls(tag, outside_inference(captured),
                        torch.Generator(device=dev).manual_seed(8))
        if not (torch.equal(got.coords, want.coords) and torch.equal(got.valid, want.valid)):
            fail(f"{tag}: coords or valid flags differ from coarse_matches'")
        serr = float((got.scores - want.scores).abs().max())
        if not torch.allclose(got.scores, want.scores, rtol=2e-5, atol=1e-6):
            fail(f"{tag}: scores differ from coarse_matches' by {serr:.3g}")
        ms, single_ms = time_ms(lambda: fn(f1, f2), iters=5), time_ms(single, iters=5)
        log(f"{tag} [features {tuple(f1.shape)}, ksize 2, world size 1 over NCCL]: coords "
            f"and valid flags equal coarse_matches', scores max err {serr:.3g}; "
            f"{ms:.3f} ms per call (single-device coarse stage {single_ms:.3f}); "
            f"launches per call {launches}; per call {format_comm_table(comm)}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del model, f1, f2, fn
        torch.cuda.empty_cache()
    return total


def parallel_path(dev, sd, main_pairs_s, train_ms, ims):
    """Phase 15: the sharded paths at world size 1 over NCCL. Returns
    B1-B3's launches summed over (a)-(c)."""
    t_phase = time.perf_counter()
    total = {}
    with process_group(1, 0, "nccl") as group:
        mesh = make_mesh(group=group, device=dev)
        for part in (lambda: batched_path(dev, sd, mesh, main_pairs_s),
                     lambda: sharded_train_path(dev, sd, mesh, train_ms),
                     lambda: sharded_coarse_path(dev, sd, mesh, ims)):
            t0 = time.perf_counter()
            for k, v in part().items():
                total[k] = total.get(k, 0) + v
            log(f"parallel part: {time.perf_counter() - t0:.1f} s")
    log(f"parallel phase: {time.perf_counter() - t_phase:.1f} s")
    return total


# ------------------------------------------------------------ phase 16


TOOLS_DIR = os.path.join(ROOT, "build", "chip_smoke_tools")
DEMO_PAIRS = 3
# tests/test_train_convergence.py's rules as the demo holds them: losses
# finite, no pair skipped in the last 6 steps, loss/epi_fine's
# last-window mean under 0.7 of its first's (windows of 25 steps on the
# demo, of 6 on the test's own workload)
SYNTH_WINDOW, EPI_FINE_RATIO, NO_SKIP_STEPS = 25, 0.7, 6
CONVERGENCE_RULES = RULES
# the JAX tool's committed run at the demo's defaults
# (artifacts/synth_train/losses.csv): pairs skipped in its last 6 steps
JAX_DEMO_LAST_SKIPPED = [1, 3, 3, 3, 0, 1]


def demo_twin(dev):
    """(a) ``python -m patch2pix_tpu_torch.evaluation.demo_matching`` at
    --imsize 1024 with random bf16 weights on 3 PNG pairs of
    ``make_pair`` scenes (1024x768). Returns the launches."""
    from PIL import Image

    pairs = os.path.join(TOOLS_DIR, "pairs")
    rs = np.random.RandomState(16)
    for i in range(DEMO_PAIRS):
        os.makedirs(os.path.join(pairs, f"pair_{i}"))
        for j, im in enumerate(make_pair(rs, H, W)[:2]):
            u8 = np.clip(np.round(im * 255), 0, 255).astype(np.uint8)
            Image.fromarray(u8).save(os.path.join(pairs, f"pair_{i}", f"{j + 1}.png"))
    reset_counts()
    # the card machine has no matplotlib: the PNGs are held by the CPU test
    done = demo_matching.main(["--pairs", pairs, "--out", os.path.join(TOOLS_DIR, "demo"),
                               "--imsize", "1024", "--no_plot"])
    torch.cuda.synchronize()
    launches = {k: v for k, v in counts().items() if v}
    if len(done) != DEMO_PAIRS or any(n == 0 for _, n, _ in done):
        fail(f"demo: matches per pair {done}")
    want = {"tap_sum": 2 * DEMO_PAIRS, "corr_pool": DEMO_PAIRS, "expand_scale_pair": DEMO_PAIRS}
    if any(launches.get(k, 0) < v for k, v in want.items()):
        fail(f"demo: launches {launches}, expected at least {want}")
    log(f"tools (a) demo_matching [--imsize 1024, bf16, random weights, --no_plot: no "
        f"matplotlib on this machine] on {DEMO_PAIRS} PNG pairs of {W}x{H}: " + "; ".join(
            f"{name} {n} matches {secs:.3f} s" for name, n, secs in done)
        + f" (the first pair includes first use); launches {launches}")
    return launches


def prep_twin():
    """(b) ``python -m patch2pix_tpu_torch.data.prep_megadepth_pairs`` on a
    synthetic ``scene_info`` (``write_scene_info``, as the JAX package's
    tests/test_tools.py writes it)."""
    base = os.path.join(TOOLS_DIR, "MegaDepth_undistort")
    write_scene_info(os.path.join(base, "scene_info"), n_ims=8, n_pts=400)
    t0 = time.perf_counter()
    out = prep_megadepth_pairs.main(["--base_dir", base, "--save_dir",
                                     os.path.join(TOOLS_DIR, "pairs_npy"),
                                     "--min_overlap_ratio", "0.3", "--exclude_tag", ""])
    secs = time.perf_counter() - t0
    scenes = np.load(out, allow_pickle=True).item()
    n = sum(len(v["pairs"]) for v in scenes.values())
    if n == 0:
        fail("prep_megadepth_pairs: no pair kept")
    log(f"tools (b) prep_megadepth_pairs [8 cameras, 400 points, overlap >= 0.3]: {n} pairs "
        f"in {len(scenes)} scene(s), {secs:.3f} s")


def block_route(dev, sd):
    """(c) a run directory whose meta says ``gather="block"`` (the JAX
    package's TPU gather switch, which routes nothing in the port),
    written by ``save_ckpt`` from the seeded weights: ``restore_for_eval``
    keeps the value, and ``predict_fine`` at 1024x768, change_stride,
    fine_cap 1200, f32 with TF32 off, equals the ``"auto"`` model's bit
    for bit under cuDNN's deterministic algorithms. Returns the launches."""
    run_dir = os.path.join(TOOLS_DIR, "block_run")
    cfg = ModelConfig(change_stride=True, gather="block").resolved()
    model = Patch2Pix(cfg, device=dev)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    save_ckpt(run_dir, create_train_state(model, OptimConfig()), cfg, epoch=0)
    del model
    ims = [torch.from_numpy(seeded_images(BATCH, H, W, seed)).to(dev) for seed in (31, 32)]
    block = restore_for_eval(run_dir, device=dev, dtype="float32")
    auto = build_model(True, sd, "float32", dev)
    if block.config.gather != "block":
        fail(f"restore_for_eval gave gather={block.config.gather!r}")
    before = counts()
    torch.backends.cudnn.deterministic = True
    try:
        outs = [m.predict_fine(ims[0], ims[1], ksize=2, fine_cap=FINE_CAP)
                for m in (auto, block)]
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    launches = {k: v - before[k] for k, v in counts().items() if v - before[k]}
    for name, a, b in zip(("fine", "mid", "coarse"), *outs):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            fail(f"the gather='block' run directory's {name} matches differ from 'auto'")
    n = int(outs[0][2].valid.sum())
    log(f"tools (c) gather='block' run directory [cs {W}x{H} f32, TF32 off, fine_cap "
        f"{FINE_CAP}]: restored with gather='block'; predict_fine equal to 'auto' bit for "
        f"bit ({n} coarse matches); launches {launches}")
    del block, auto
    return launches


def synth_twin(dev):
    """(d) ``python -m patch2pix_tpu_torch.train.synth_demo`` at its
    defaults: finite losses and loss/epi_fine's last 25 steps under 0.7
    of its first 25's. Pairs still skipped in the last 6 steps are
    printed beside the JAX tool's run, which skips some too at these
    defaults (the random-init frozen backbone leaves some of the 64 pool
    pairs with no coarse match inside the epipolar gate); the no-skip
    rule is held on the test's own workload, :func:`convergence_rules`.
    Returns the launches."""
    reset_counts()
    summary, rows = synth_demo.main(["--out", os.path.join(TOOLS_DIR, "synth"), "--no_plot"])
    torch.cuda.synchronize()
    launches = {k: v for k, v in counts().items() if v}
    if not all(np.isfinite(r["loss_pair"]) for r in rows):
        fail("synth demo: a loss is not finite")
    epi = [r["loss_epi_fine"] for r in rows]
    head, tail = np.mean(epi[:SYNTH_WINDOW]), np.mean(epi[-SYNTH_WINDOW:])
    if not tail < EPI_FINE_RATIO * head:
        fail(f"synth demo: loss/epi_fine over the last {SYNTH_WINDOW} steps {tail:.4g} is "
             f"not under {EPI_FINE_RATIO} of the first {SYNTH_WINDOW}'s {head:.4g}")
    if not (launches.get("tap_sum", 0) and launches.get("expand_scale_pair", 0)):
        fail(f"synth demo: B1 and B3 must launch: {launches}")
    skipped = [int(r["skipped"]) for r in rows[-NO_SKIP_STEPS:]]
    log(f"tools (d) synth_demo [defaults: ResNet34 upsample 16, bf16, {summary['steps']} "
        f"steps, batch 4, 480x320, ptmax 400, panc 8, Adam 5e-4; --no_plot]: "
        f"{summary['ms_per_step_avg']} ms/step (first chunk excluded); loss/epi_fine "
        f"{head:.4g} -> {tail:.4g} (ratio {tail / head:.3f}, rule < {EPI_FINE_RATIO}); "
        f"loss/pair {summary['loss_pair_first25']:.4g} -> {summary['loss_pair_last25']:.4g}; "
        f"held-out fine Sampson {summary['val_sampson_init']:.3f} px at the start, "
        f"{summary['val_sampson_last']:.3f} at the end (coarse {summary['val_coarse_init']:.3f}"
        f" -> {summary['val_coarse_last']:.3f}); pairs skipped in the last {NO_SKIP_STEPS} "
        f"steps {skipped} (the JAX tool's run: {JAX_DEMO_LAST_SKIPPED}); launches {launches}")
    return launches


def convergence_rules(dev):
    """(d) tests/test_train_convergence.py's workload on the card
    (``train.convergence.run_convergence``: f32, upsample 16, 96x128, one
    fixed batch, 24 steps, cuDNN's deterministic algorithms, the
    proposals drawn on the card). Holds finite losses, no pair skipped in
    the last 6 steps, loss/epi_fine under 0.7 and loss/epi_mid under 0.9
    of the first 6 steps'; prints the loss/pair ratio beside the JAX
    test's bound 0.5, which the port misses on the CPU as well (PERF.md
    §7). Returns the launches."""
    reset_counts()
    out = run_convergence(dev)
    torch.cuda.synchronize()
    launches = {k: v for k, v in counts().items() if v}
    ratios, skipped = out["ratios"], out["skipped_last"]
    if not all(np.isfinite(h["loss/pair"]) for h in out["hist"]):
        fail("convergence: a loss is not finite")
    if any(skipped):
        fail(f"convergence: pairs still skipped in the last {NO_SKIP_STEPS} steps: {skipped}")
    for key in ("loss/epi_fine", "loss/epi_mid"):
        if not ratios[key] < CONVERGENCE_RULES[key]:
            fail(f"convergence: {key} last/first 6 steps {ratios[key]:.3f}, "
                 f"rule < {CONVERGENCE_RULES[key]}")
    log(f"tools (d) tests/test_train_convergence.py's workload [f32, upsample 16, 96x128, "
        f"batch 2, ptmax 48, Adam 2e-3, 24 steps, cudnn.deterministic, draws on the card]: "
        f"skipped in the last {NO_SKIP_STEPS} steps {skipped}; last/first 6 steps "
        f"loss/epi_fine {ratios['loss/epi_fine']:.3f} (rule < 0.7), loss/epi_mid "
        f"{ratios['loss/epi_mid']:.3f} (rule < 0.9); not held: loss/pair "
        f"{ratios['loss/pair']:.3f} (the JAX test's bound 0.5); {out['seconds']:.1f} s; "
        f"launches {launches}")
    return launches


def tools_path(dev, sd):
    """Phase 16: the JAX-only tools' twins and a ``gather="block"`` run
    directory (module docstring). Returns B1-B3's launches."""
    t_phase = time.perf_counter()
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    total = {}
    try:
        for part in (lambda: demo_twin(dev), prep_twin, lambda: block_route(dev, sd),
                     lambda: synth_twin(dev), lambda: convergence_rules(dev)):
            t0 = time.perf_counter()
            for k, v in (part() or {}).items():
                total[k] = total.get(k, 0) + v
            log(f"tools part: {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    log(f"tools phase: {time.perf_counter() - t_phase:.1f} s")
    return total


# ------------------------------------------------------------ phase 18

MULTI_DIR = os.path.join(ROOT, "build", "chip_smoke_multi")
# (b)'s pairs: 28 at the main path's size and 4 at 640x480 (two buckets)
MULTI_PAIRS = ((W, H, 28), (640, 480, 4))
# how long a rank of phase 18 waits in a collective: a hang fails the call
MULTI_TIMEOUT = timedelta(minutes=5)
# JAX's dryrun train step (the default model at 64x64; MULTICHIP_r05.json, a TPU run)
JAX_DRYRUN_STEP = "all-reduce x18 40478.2 KiB"


def solo(rank, fn):
    """``fn()`` on rank 0 alone (a world-size-1 reference on card 0, or
    rank 0's checks) while the other ranks wait at a barrier; its result
    on rank 0, None on the others. A check that fails in ``fn`` ends rank
    0 (``spawned_rank``: exit code 1), its group aborted, and the parent
    then ends the waiting ranks: the phase fails at once."""
    out = fn() if rank == 0 else None
    dist.barrier()
    return out


def rank_launches(tag, need):
    """Every rank's launches since ``reset_counts``, gathered; fails
    unless each rank launched each kernel of ``need``."""
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, {k: v for k, v in counts().items() if v})
    if not all(c.get(k, 0) > 0 for c in every for k in need):
        fail(f"{tag}: {need} must launch on every rank; launches per rank {every}")
    return every


def gather_only(tag, comm, n):
    """``BatchedMatcher``'s rule: nothing recorded while matching, so a
    run records only the results' final ``all_gather_object`` (nothing
    at all on one rank)."""
    want = {"all-gather"} if n > 1 else set()
    if set(comm) != want or (n > 1 and comm["all-gather"]["count"] != 1):
        fail(f"{tag}: collectives {comm}; only the final all_gather_object expected")


def adam_step_excess(got, want, g, wg, lr=5e-4, eps=1e-8):
    """``tests/test_torch_train.py``'s ``assert_adam_step_close``: by how
    much parameters after one Adam step from gradient ``g`` differ from
    those after one from ``wg`` beyond what the two gradients can make
    them differ (<= 0 holds)."""
    same = torch.sign(g) == torch.sign(wg)
    gmin = torch.minimum(g.abs(), wg.abs())
    bound = torch.where(same, lr * eps * (g - wg).abs() / (gmin + eps) ** 2,
                        torch.full_like(g, 2 * lr))
    return float(((got - want).abs() - 1.01 * bound - 1e-6).max())


def hold_train_step(tag, model, metrics, want, before, control=None):
    """``tests/test_torch_train_sharded.py``'s rule for a sharded step
    against the single-device one (``want``: its state, gradients and
    metrics): metrics rtol 1e-5 (atol 1e-6), parameters by Adam's bound,
    frozen tensors bit-identical to ``before``, running averages rtol
    1e-5 (atol 1e-6), the summed gradients within 1e-4 of the largest.
    Where ``control`` is given (the single-device step's gradients with
    cuDNN off: another convolution algorithm, the same batch), the
    gradients are held within the larger of 1e-4 and how far
    ``control`` lies from ``want``'s: the pairing of two cuDNN steps,
    whose algorithms may differ with the proposal count. Returns the
    largest errors."""
    wsd, wgrads, wmet = want
    met = {k: float(v) for k, v in metrics.items()}
    if met.keys() != wmet.keys():
        fail(f"{tag}: metrics {sorted(met)} against make_train_step's {sorted(wmet)}")
    off = {k: (met[k], v) for k, v in wmet.items() if abs(met[k] - v) > 1e-6 + 1e-5 * abs(v)}
    grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    if grads.keys() != wgrads.keys() or not all(k.startswith("regress_") for k in grads):
        fail(f"{tag}: gradients of {sorted(grads)} against {sorted(wgrads)}")
    scale = max(float(g.abs().max()) for g in wgrads.values())
    errs = {"metrics rel": max(abs(met[k] - v) / max(abs(v), 1e-30) for k, v in wmet.items()),
            "grad / largest": max(float((grads[k] - wgrads[k]).abs().max())
                                  for k in grads) / scale}
    grad_tol = 1e-4
    if control is not None:
        errs["cuDNN-off control / largest"] = max(
            float((control[k] - wgrads[k]).abs().max()) for k in grads) / scale
        grad_tol = max(grad_tol, errs["cuDNN-off control / largest"])
    now = model.state_dict()
    errs["Adam excess"] = max(adam_step_excess(now[k], wsd[k], grads[k], wgrads[k])
                              for k in grads)
    frozen = [k for k in now if k.startswith(("extract.", "ncn.")) and "running" not in k]
    changed = [k for k in frozen
               if not torch.equal(now[k].cpu(), torch.from_numpy(np.asarray(before[k])))]
    running = [k for k in now if "running" in k]
    errs["running abs"] = max(float((now[k] - wsd[k]).abs().max()) for k in running)
    far = [k for k in running if not torch.allclose(now[k], wsd[k], rtol=1e-5, atol=1e-6)]
    if off or errs["grad / largest"] > grad_tol or errs["Adam excess"] > 0 or changed or far:
        fail(f"{tag}: {errs}; metrics off (sharded, single) {off}; frozen tensors changed "
             f"{changed}; running averages off {far}")
    return errs


def multi_train(rank, n, dev, mesh, sd):
    """Phase 18 (a): the sharded train step at the reference setting."""
    tag = f"multi train [world {n}]"
    kw = dict(ksize=2, ptmax=PTMAX, remat="auto")
    cells = (TRAIN_H // 8 // 2) * (TRAIN_W // 8 // 2)

    def batch_of(pairs, seed):
        rs = np.random.RandomState(seed)
        return {k: torch.from_numpy(v).to(dev)
                for k, v in synthetic_batch(rs, pairs, TRAIN_H, TRAIN_W).items()}

    def draw(pairs):
        return torch.rand((pairs, 2 * cells), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(7))

    def stepper(dtype, mesh_=None, **extra):
        model = seeded_model(sd, dtype, dev)
        state = create_train_state(model, OptimConfig(lr_init=5e-4))
        return model, state, make_train_step(model, state.optimizer, mesh=mesh_, **kw, **extra)

    # f32 parity at one pair a rank, cuDNN's deterministic algorithms
    batch, rand = batch_of(n, 0), draw(n)
    torch.backends.cudnn.deterministic = True

    def single(cudnn=True):
        torch.backends.cudnn.enabled = cudnn
        try:
            model, state, step = stepper("float32")
            _, met = step(state, batch, rand=rand)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.enabled = True
        return ({k: v.detach().clone() for k, v in model.state_dict().items()},
                {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None},
                {k: float(v) for k, v in met.items()})

    want = solo(rank, single)
    want_off = solo(rank, lambda: single(cudnn=False))
    model, state, step = stepper("float32", mesh, debug_checks=True)
    reset_counts()
    with capture_inputs(keep=1) as captured, record_collectives() as comm:
        state, met = step(state, shard_batch(batch, mesh), rand=rand)
        torch.cuda.synchronize()
    every = rank_launches(tag, ("tap_sum", "expand_scale_pair"))
    if set(comm) != {"all-reduce"}:
        fail(f"{tag}: collectives other than all-reduce: {comm}")
    n_grad = sum(p.numel() for p in model.parameters() if p.requires_grad)
    # the witness: the same sharded step with cuDNN off on every rank,
    # held to the single-device cuDNN-off step by the CPU tests' rule
    torch.backends.cudnn.enabled = False
    try:
        model_off, state_off, step_off = stepper("float32", mesh, debug_checks=True)
        _, met_off = step_off(state_off, shard_batch(batch, mesh), rand=rand)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.enabled = True
    torch.backends.cudnn.deterministic = False

    def held():
        if want is None or want_off is None:
            fail(f"{tag}: no single-device reference (its run failed above)")
        errs_off = hold_train_step(f"{tag} cuDNN off", model_off, met_off, want_off, sd)
        errs = hold_train_step(tag, model, met, want, sd, control=want_off[1])
        hold_path_calls(tag, captured, torch.Generator(device=dev).manual_seed(6))
        return errs, errs_off

    errs, errs_off = solo(rank, held) or ({}, {})
    del model, state, step, captured, want, want_off, model_off, state_off, step_off
    torch.cuda.empty_cache()

    # bf16 ms/step: 4 pairs a rank against world size 1 at batch 4
    def ms_per_step(mesh_, pairs):
        model, state, step = stepper("bfloat16", mesh_)
        big, rand_ = batch_of(pairs, 1), draw(pairs)
        b = big if mesh_ is None else shard_batch(big, mesh_)
        times = []
        for _ in range(6):
            t0 = time.perf_counter()
            state, _ = step(state, b, rand=rand_)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times[1:]))

    ms_n = ms_per_step(mesh, TRAIN_BATCH * n)
    ms_1 = solo(rank, lambda: ms_per_step(None, TRAIN_BATCH))
    torch.cuda.empty_cache()
    if rank == 0 and errs:
        log(f"{tag} [ResNet34 change_stride {TRAIN_W}x{TRAIN_H} ptmax={PTMAX} panc 8, Adam "
            f"5e-4, backbone and NCN frozen, NCCL]: f32 step at global batch {n} (one pair a "
            f"rank) from the seeded state and a fixed draw, cuDNN deterministic, against "
            f"make_train_step without a mesh on card 0: "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f" (rules: metrics and running averages rtol 1e-5, gradients within the larger "
            f"of 1e-4 of the largest and the cuDNN-off control, Adam's bound <= 0; frozen "
            f"tensors bit-identical); with cuDNN off on every rank against the single-device "
            f"step with cuDNN off: " + ", ".join(f"{k} {v:.3g}" for k, v in errs_off.items())
            + f" (the same rules, gradients within 1e-4 of the largest); collectives per "
            f"step (debug_checks' two 4-byte all-reduces included): "
            + ", ".join(f"{k} x{v['count']} {v['bytes']} bytes ({v['bytes'] / 1024:.1f} KiB)"
                        for k, v in comm.items())
            + f", of which the gradient buffer {4 * n_grad} bytes ({n_grad} trainable "
            f"values); JAX's dryrun step (default model, 64x64, a TPU run): {JAX_DRYRUN_STEP}; "
            f"launches per rank {every}; bf16 ms/step median of 5: {ms_n:.2f} at "
            f"{TRAIN_BATCH} pairs a rank (global {TRAIN_BATCH * n}), world size 1 at batch "
            f"{TRAIN_BATCH} {ms_1:.2f}: weak-scaling efficiency {ms_1 / ms_n:.1%}, "
            f"{TRAIN_BATCH * n * 1e3 / ms_n:.2f} against {TRAIN_BATCH * 1e3 / ms_1:.2f} "
            f"training pairs/s")


def batched_parity(tag, rank, n, dev, mesh, sd, cs, pairs, sizes, per_chip_batch=None):
    """(b)'s f32 rules for ``BatchedMatcher`` over ``mesh`` on ``pairs``
    (``sizes``: how many at which size, as text; ``per_chip_batch``:
    ``BatchedMatcher``'s, its default where None):
    every pair equals ``Matcher.estimate_matches`` on rank 0's card by the
    goldens' rules, nothing is recorded but the results' final
    ``all_gather_object``, and B1-B3 launch on every rank."""
    kw = dict(ksize=2, io_thres=0.25, imsize=1024, fine_cap=FINE_CAP)
    model = build_model(cs, sd, "float32", dev)
    bm = BatchedMatcher(model, mesh=mesh, per_chip_batch=per_chip_batch, **kw)
    reset_counts()
    with record_collectives() as comm:
        out = bm.match_pairs(pairs)
    gather_only(tag, comm, n)
    every = rank_launches(tag, ("tap_sum", "corr_pool", "expand_scale_pair"))

    def parity():
        matcher = Matcher(model, device=dev, **kw)
        return [hold_pair_parity(f"{tag} f32 pair {i}", got, matcher.estimate_matches(*pair))
                for i, (got, pair) in enumerate(zip(out, pairs))]

    errs = solo(rank, parity)
    if rank == 0 and errs:
        log(f"{tag} [f32, TF32 off, imsize 1024, per_chip_batch {bm.per_chip_batch}, "
            f"{len(pairs)} pairs: {sizes}]: every pair equals Matcher.estimate_matches on "
            f"rank 0's card (rows " + " ".join(str(e[0]) for e in errs) + f"; max coord err "
            f"{max(e[1] for e in errs):.3g} px, max score err {max(e[2] for e in errs):.3g}"
            f"); nothing recorded while matching, then the results' "
            f"{format_comm_table(comm)}; launches per rank {every}")
    del model, bm, out
    torch.cuda.empty_cache()


def multi_batched(rank, n, dev, mesh, sd, pairs):
    """Phase 18 (b): ``BatchedMatcher`` on ``MULTI_PAIRS`` over the ranks."""
    kw = dict(ksize=2, io_thres=0.25, imsize=1024, fine_cap=FINE_CAP)
    sizes = " and ".join(f"{c} at {w}x{h}" for w, h, c in MULTI_PAIRS)
    for cs in (True, False):
        tag = f"multi batched {'change_stride' if cs else 'upsample 16'} [world {n}]"
        batched_parity(tag, rank, n, dev, mesh, sd, cs, pairs, sizes)

        model = build_model(cs, sd, "bfloat16", dev)

        def rates(mesh_):
            r = {}
            for pcb in (1, 2, 4):
                bm_ = BatchedMatcher(model, mesh=mesh_, per_chip_batch=pcb, **kw)
                bm_.match_pairs(pairs[:1])  # warm up
                torch.cuda.synchronize()
                if mesh_.size > 1:
                    dist.barrier()
                t0 = time.perf_counter()
                bm_.match_pairs(pairs)
                r[pcb] = len(pairs) / (time.perf_counter() - t0)
            return r

        rates_n = rates(mesh)
        rates_1 = solo(rank, lambda: rates(make_mesh(1, device=dev)))
        reset_counts()
        with capture_inputs(keep=1) as captured, record_collectives() as comm:
            BatchedMatcher(model, mesh=mesh, **kw).match_pairs(pairs)
        gather_only(tag, comm, n)
        every = rank_launches(f"{tag} bf16", ("tap_sum", "corr_pool", "expand_scale_pair"))

        def held():
            hold_path_calls(f"{tag} bf16", outside_inference(captured),
                            torch.Generator(device=dev).manual_seed(5))
            log(f"{tag} [bf16]: pairs/s over the {len(pairs)} pairs (every rank decodes and "
                f"resizes every PNG) at per_chip_batch 1 / 2 / 4: " + " / ".join(
                    f"{rates_n[k]:.2f}" for k in (1, 2, 4)) + "; world size 1 on card 0: "
                + " / ".join(f"{rates_1[k]:.2f}" for k in (1, 2, 4)) + "; scaling efficiency "
                + " / ".join(f"{rates_n[k] / (n * rates_1[k]):.1%}" for k in (1, 2, 4))
                + f"; launches per rank {every}; nothing recorded while matching")

        solo(rank, held)
        del model, captured
        torch.cuda.empty_cache()


def multi_coarse(rank, n, dev, mesh, sd):
    """Phase 18 (c): the h1-sharded coarse matcher on phase 4's
    change_stride features, ``H // 8 / n`` h1 rows a rank."""
    ims = [torch.from_numpy(seeded_images(BATCH, H, W, seed)).to(dev) for seed in (1, 2)]
    for dtype in ("bfloat16", "float32"):
        tag = f"multi coarse [{dtype}, world {n}]"
        model = build_model(True, sd, dtype, dev)
        with torch.inference_mode():
            f1, f2 = (f[-1] for f in model.extract_pyramid_pair(ims[0], ims[1]))
            for f in (f1, f2):  # the features of card 0 on every rank
                dist.broadcast(f, 0)
        fn = make_sharded_coarse_matcher(model, mesh, ksize=2)

        def single():
            with torch.inference_mode():
                return model.coarse_matches(*model.coarse_corr(f1, f2, 2), 2)

        reset_counts()
        with capture_inputs(sites=((conv4d_module, "tap_sum"),
                                   (volume_sharding_module, "corr_pool")),
                            keep=1) as captured, record_collectives() as comm:
            got = fn(f1, f2)
            torch.cuda.synchronize()
        every = rank_launches(tag, ("tap_sum", "corr_pool"))

        def held():
            want = single()
            if not (torch.equal(got.coords, want.coords)
                    and torch.equal(got.valid, want.valid)):
                fail(f"{tag}: coords or valid flags differ from coarse_matches'")
            if not torch.allclose(got.scores, want.scores, rtol=2e-5, atol=1e-6):
                fail(f"{tag}: scores differ from coarse_matches' by "
                     f"{float((got.scores - want.scores).abs().max()):.3g}")
            hold_path_calls(tag, outside_inference(captured),
                            torch.Generator(device=dev).manual_seed(8))
            return float((got.scores - want.scores).abs().max())

        serr = solo(rank, held)
        ms = time_ms(lambda: fn(f1, f2), iters=5)
        single_ms = solo(rank, lambda: time_ms(single, iters=5))
        if rank == 0 and serr is not None:
            log(f"{tag} [features {tuple(f1.shape)}, {f1.shape[1] // n} h1 rows a rank, ksize "
                f"2]: coords and valid flags equal coarse_matches' on card 0, scores max err "
                f"{serr:.3g}; {ms:.3f} ms per call (world size 1, coarse_matches on card 0: "
                f"{single_ms:.3f}); per call {format_comm_table(comm)}; launches per rank "
                f"{every}")
        del model, f1, f2, fn, got, captured
        torch.cuda.empty_cache()


def multi_ba(rank, n, dev, world, alone):
    """Phase 18 (d): the point-sharded BA at ``BA_SCALES[1]`` over the
    ranks against ``ba_step`` and ``run_ba`` on card 0; ms per LM
    iteration at world size n and 1 (``alone``: a group of rank 0)."""
    c, p, o = BA_SCALES[1]
    Rs, ts, X, ci, pi, uv = make_ba_scene(c, p, o)
    args = (Rs, ts, perturb_points(X), ci, pi, uv)
    sp = shard_problem(*args, n_shards=n)

    def single():
        card = build_problem(*args, device=dev)
        new, cn, co = ba_module.ba_step(card, 1e-3, 1e9, False)
        cost0 = float(cost(card))
        _, c_single = run_ba(card, max_iters=10, device=dev)
        return (new.Rs, new.ts, cn, co), cost0, c_single

    ref = solo(rank, single)
    step = make_dist_ba_step(c, use_huber=False, group=world)
    first = step(local_problem(sp, rank, dev), 1e-3, 1e9)
    stats = {}
    _, _, X_d, c_dist = run_dist_ba(sp, world, max_iters=10, debug_checks=True, device=dev,
                                    stats=stats)

    def lm_ms(group, sp_):
        """ms and collectives per LM iteration, k = 6 minus k = 2 iterations."""
        runs = []
        for k in (6, 2):
            st = {}
            dist.barrier(group=group)
            with record_collectives() as comm:
                t0 = time.perf_counter()
                run_dist_ba(sp_, group, max_iters=k, device=dev, stats=st)
                runs.append(((time.perf_counter() - t0) * 1e3, st["iterations"], comm))
        (t6, i6, c6), (t2, i2, c2) = runs
        if i6 <= i2:
            fail(f"multi dist BA: {i6} and {i2} LM iterations for max_iters 6 and 2")
        per = {k: {"count": (v["count"] - c2[k]["count"]) // (i6 - i2),
                   "bytes": (v["bytes"] - c2[k]["bytes"]) // (i6 - i2)}
               for k, v in c6.items() if v["count"] > c2[k]["count"]}
        return (t6 - t2) / (i6 - i2), per

    ms_n, per_n = lm_ms(world, sp)
    ms_1 = solo(rank, lambda: lm_ms(alone, shard_problem(*args, n_shards=1))[0])

    def held():
        if ref is None:
            fail("multi dist BA: no world-size-1 reference (its run failed above)")
        step_errs = hold_ba_step(f"multi dist step [world {n}] vs ba_step",
                                 (first[0], first[1], first[3], first[4]), ref[0])
        cost0, c_single = ref[1], ref[2]
        rel = abs(c_dist - c_single) / max(c_single, 1e-12)
        if not (c_dist < cost0 * 1e-2 and rel < 0.5 and np.isfinite(X_d).all()):
            fail(f"multi run_dist_ba: cost {cost0:.6g} -> {c_dist:.6g}, run_ba {c_single:.6g}")
        log(f"multi dist BA [world {n}, NCCL, {c} cams, {p} pts, {len(ci)} obs, f32, TF32 "
            f"off]: first step vs ba_step on card 0 "
            + ", ".join(f"{k} {v:.3g}" for k, v in step_errs.items())
            + f"; run_dist_ba(max_iters 10, debug_checks) cost {cost0:.6g} -> {c_dist:.6g} in "
            f"{stats['iterations']} iterations, {stats['host_syncs']} stop-flag reads; run_ba "
            f"on card 0 {c_single:.6g} (relative difference {rel:.3g}); no divergence raised; "
            f"ms per LM iteration (k = 6 minus k = 2): {ms_n:.3f} at world size {n}, {ms_1:.3f} "
            f"at world size 1 (a group of one rank), speed-up {ms_1 / ms_n:.2f}x; collectives "
            f"per iteration at world size {n}: "
            + ", ".join(f"{k} x{v['count']} {v['bytes']} bytes" for k, v in per_n.items()))

    solo(rank, held)
    del sp, ref
    torch.cuda.empty_cache()


def multi_rank(rank, n, store, pairs, t_spawn):
    """One NCCL rank of phase 18 (spawned through
    ``parallel.mesh.spawned_rank``, which ends it with exit code 1 on an
    error): its card, the group, parts (a)-(d). Rank 0 prints the wall
    seconds from ``t_spawn`` (``time.time()`` at the spawn) to each
    stage."""
    marks = {"up": time.time() - t_spawn}
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _, _, sd = load_golden("cs_1024")
    with process_group(n, rank, "nccl", store, timeout=MULTI_TIMEOUT) as world:
        mesh = make_mesh(group=world, device=dev)
        card = torch.cuda.current_device()
        print(f"rank {rank}: torch.cuda.current_device() {card}, "
              f"{torch.cuda.get_device_name(card)}", flush=True)
        cards = [None] * n
        dist.all_gather_object(cards, card)
        if sorted(cards) != list(range(n)):
            fail(f"ranks and cards: {cards}; one card a rank expected")
        alone = dist.new_group([0])
        marks["group"] = time.time() - t_spawn
        for part, run in (("a", lambda: multi_train(rank, n, dev, mesh, sd)),
                          ("b", lambda: multi_batched(rank, n, dev, mesh, sd, pairs)),
                          ("c", lambda: multi_coarse(rank, n, dev, mesh, sd)),
                          ("d", lambda: multi_ba(rank, n, dev, world, alone))):
            t0 = time.perf_counter()
            run()
            if rank == 0:
                log(f"multi part ({part}): {time.perf_counter() - t0:.1f} s")
        dist.barrier()
        marks["parts"] = time.time() - t_spawn
    marks["teardown"] = time.time() - t_spawn
    if rank == 0:
        log("multi spawn [rank 0, wall s from the spawn]: "
            + ", ".join(f"{k} {v:.1f}" for k, v in marks.items()))


def multi_cli(n):
    """Phase 18 (e): the training CLI with ``--mesh n``, phase 10's
    fixture and setting, one epoch of one step and its validation.
    Returns the run directory and the argv, which (g1) repeats."""
    root = os.path.join(MULTI_DIR, "cli")
    fixture = write_megadepth_fixture(os.path.join(root, "fixture"), CLI_PAIRS, TRAIN_H,
                                      TRAIN_W, seed=0)
    _, _, sd = load_golden("cs_1024")
    pre = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    pth = os.path.join(root, "seeded.pth")
    torch.save({"state_dict": pre}, pth)
    write_val_dense_fixture(os.path.join(fixture[0], "immatch_benchmark", "val_dense"), 2, H,
                            W, seed=1)
    argv = cli_argv(fixture, os.path.join(root, "out"), 1, "--pretrain", pth, "--mesh", str(n),
                    steps=1)
    argv.remove("--no_eval")
    t0 = time.perf_counter()
    run = train_cli.main(argv, group_timeout=MULTI_TIMEOUT)
    secs = time.perf_counter() - t0
    with open(os.path.join(run, "log.txt")) as f:
        text = f.read()
    pairs = re.search(r"Pairs 2 match_failed=0 geo_failed=0 .* time:([0-9.]+)s", text)
    written = [t for t in ("last", "immatch_best") if os.path.exists(os.path.join(run, f"{t}.pt"))]
    # --mesh 1 (a rehearsal on one card) trains without a mesh
    if ((n > 1 and f"Mesh: {n}-rank data parallel" not in text) or "Failed to eval immatch" in text
            or "Pose err: qt_mean=" not in text or pairs is None or "Finished" not in text
            or written != ["last", "immatch_best"]):
        fail(f"multi cli --mesh {n}: checkpoints {written}; log:\n" + text[-2000:])
    ckpt = checkpoint_model(run)
    last = ckpt["model"]
    frozen = [k for k in pre if k.startswith(("extract.", "ncn."))]
    changed = [k for k in frozen if not torch.equal(last[k], pre[k])]
    bad = [k for k, v in last.items() if v.is_floating_point() and not torch.isfinite(v).all()]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        means = json.loads(f.readlines()[-1])
    losses = {k: v for k, v in means.items() if k.startswith("loss")}
    if (changed or bad or ckpt["step"] != 1 or not losses
            or not all(np.isfinite(v) for v in losses.values())):
        fail(f"multi cli --mesh {n}: frozen tensors changed {changed}, non-finite {bad}, "
             f"step {ckpt['step']}, losses {losses}")
    log(f"multi cli [train.cli.main --mesh {n}, phase 10's setting and fixture, batch "
        f"{TRAIN_BATCH} ({TRAIN_BATCH // n} a rank), 1 epoch x 1 step, the "
        f"immatch validation on 2 pairs at {W}x{H}]: {secs:.1f} s in all (ranks spawned, the "
        f"protocol {float(pairs.group(1)):.2f} s on rank 0); every rank passed the epoch's "
        f"barrier; rank 0 wrote last.pt (step {ckpt['step']}) and immatch_best; "
        f"{len(frozen)} frozen tensors bit-identical to the .pth, every tensor finite; epoch "
        f"means " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(losses.items())))
    return run, argv


def multi_dryrun(n):
    """Phase 18 (f): ``dryrun_multichip(n)`` on the cards."""
    out = dryrun_multichip(n)
    if out["devices"] != [f"cuda:{r}" for r in range(n)]:
        fail(f"dryrun ranks and cards: {out['devices']}")
    log(f"multi dryrun_multichip({n}): ranks on {out['devices']}; train steps "
        + ", ".join(f"mesh {m}: step {v['step']}" for m, v in out["train"].items())
        + "; dist BA costs " + ", ".join(f"mesh {m}: {v['cost']:.3e}"
                                         for m, v in out["ba"].items())
        + "; wall s from the spawn to each stage's end on rank 0: "
        + ", ".join(f"{k} {v:.1f}" for k, v in out["seconds"].items()))


# (g): the multi-host entry points, the cards split into two hosts of n / 2
# by CUDA_VISIBLE_DEVICES. (g2)'s pairs: (b)'s first 4 at the main path's
# size and its 4 at 640x480
TCP_PAIRS = os.path.join(MULTI_DIR, "tcp_pairs.json")
TCP_SIZES = f"4 at {W}x{H} and 4 at 640x480"
# the variables of a torchrun rank, which no process of (g) inherits
RANK_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK",
            "MASTER_ADDR", "MASTER_PORT", "TORCHELASTIC_RUN_ID")


def host_cards(n):
    """The physical cards of each of two hosts of ``n // 2`` cards."""
    return [list(range(n // 2)), list(range(n // 2, n))]


def host_env(cards):
    env = {k: v for k, v in os.environ.items() if k not in RANK_ENV}
    env["CUDA_VISIBLE_DEVICES"] = ",".join(map(str, cards))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
    return env


def free_port():
    """A TCP port on 127.0.0.1 that nothing listened on a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_hosts(tag, make_specs):
    """Run the processes ``make_specs(port)`` gives ([(argv, env, cwd),
    ...]) at once, each in a session of its own, on a free port; returns
    their outputs. When one exits non-zero, or ``MULTI_TIMEOUT`` passes,
    every session still running (a launcher and its ranks) is killed and
    the phase fails; a port found taken is given up for another once."""
    for attempt in range(2):
        specs = make_specs(free_port())
        logs = [os.path.join(MULTI_DIR, f"{tag}.{i}.log") for i in range(len(specs))]
        procs = []
        for (argv, env, cwd), path in zip(specs, logs):
            with open(path, "w") as f:
                procs.append(subprocess.Popen(argv, env=env, cwd=cwd, stdout=f,
                                              stderr=subprocess.STDOUT, start_new_session=True))
        deadline = time.monotonic() + MULTI_TIMEOUT.total_seconds()
        try:
            while True:
                codes = [p.poll() for p in procs]
                if any(c not in (None, 0) for c in codes) or time.monotonic() > deadline:
                    break
                if all(c == 0 for c in codes):
                    break
                time.sleep(0.5)
        finally:
            for p in procs:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        texts = []
        for path in logs:
            with open(path) as f:
                texts.append(f.read())
        if all(c == 0 for c in codes):
            return texts
        taken = any("address already in use" in t.lower() for t in texts)
        if attempt or not taken:
            fail(f"{tag}: exit codes {codes} (None: killed after one failed or at "
                 f"MULTI_TIMEOUT); the tail of each process's output:\n"
                 + "\n".join(f"--- {i}:\n{t[-3000:]}" for i, t in enumerate(texts)))
        log(f"{tag}: port taken, again on another")


def rank_lines(texts):
    """Each rank's report: the JSON after ``multi rank report `` in the
    outputs, by global rank."""
    out = {}
    for t in texts:
        for m in re.finditer(r"^multi rank report (\{.*\})$", t, re.M):
            r = json.loads(m.group(1))
            out[r["rank"]] = r
    return dict(sorted(out.items()))


def report_ranks(tag, n, reports, need):
    """Log each rank's host, global rank and physical card; fail unless
    the n ranks each reported once, on n distinct cards, and each
    launched every kernel of ``need``. Returns the spread of the ranks'
    start and of their join, in s."""
    for r in reports.values():
        log(f"{tag} host {r['host']} rank {r['rank']}: cuda:{r['index']} of "
            f"CUDA_VISIBLE_DEVICES={r['visible']} -> physical card {r['card']}, {r['name']}; "
            f"wall s from the launch: up {r['up']:.1f}, joined {r['joined']:.1f}, done "
            f"{r['done']:.1f}; launches {r['launches']}")
    cards = [r["card"] for r in reports.values()]
    if list(reports) != list(range(n)) or len(set(cards)) != n:
        fail(f"{tag}: ranks {list(reports)} on physical cards {cards}; ranks 0-{n - 1} on "
             f"{n} cards expected")
    short = {r["rank"]: r["launches"] for r in reports.values()
             if not all(r["launches"].get(k, 0) > 0 for k in need)}
    if short:
        fail(f"{tag}: {need} must launch on every rank; launches {short}")
    return tuple(max(r[k] for r in reports.values()) - min(r[k] for r in reports.values())
                 for k in ("up", "joined"))


def rank_report(host, rank, t_launch, marks):
    """Print this rank's line for :func:`rank_lines`."""
    index = torch.cuda.current_device()
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "")
    print("multi rank report " + json.dumps({
        "host": host, "rank": rank, "index": index, "visible": visible,
        "card": int(visible.split(",")[index]), "name": torch.cuda.get_device_name(index),
        "launches": {k: v for k, v in counts().items() if v},
        **{k: v - t_launch for k, v in marks.items()}}), flush=True)


def tcp_rank(host, rank, n, address, t_launch):
    """(g2) one rank, a process of its own on its host's cards (no
    ``LOCAL_RANK``): ``initialize_multihost`` over TCP, ``make_mesh(n)``
    (``rank_device``'s card: the rank modulo the visible cards), then
    (b)'s f32 rules on ``TCP_PAIRS``, both strides."""
    marks = {"up": time.time()}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _, _, sd = load_golden("cs_1024")
    with open(TCP_PAIRS) as f:
        pairs = [tuple(p) for p in json.load(f)]
    initialize_multihost(address, n, rank, timeout=MULTI_TIMEOUT)
    try:
        mesh = make_mesh(n)
        marks["joined"] = time.time()
        for cs in (True, False):
            tag = (f"multi tcp batched {'change_stride' if cs else 'upsample 16'} [world {n}, "
                   f"2 hosts]")
            # one pair a rank a call: each bucket has work for every rank
            batched_parity(tag, rank, n, mesh.device, mesh, sd, cs, pairs, TCP_SIZES,
                           per_chip_batch=1)
        marks["done"] = time.time()
        rank_report(host, rank, t_launch, marks)
    except BaseException:
        abort_process_group()
        raise
    dist.destroy_process_group()
    return 0


def multi_tcp(n, pairs):
    """Phase 18 (g2): ``initialize_multihost`` over TCP, n ranks as
    processes of two hosts."""
    tag = f"multi tcp [world {n}, 2 hosts]"
    with open(TCP_PAIRS, "w") as f:
        json.dump(pairs[:4] + pairs[MULTI_PAIRS[0][2]:][:4], f)
    cards = host_cards(n)
    t_launch = time.time()

    def specs(port):
        return [([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--tcp-rank", str(k),
                  str(k * len(cards[0]) + i), str(n), f"127.0.0.1:{port}", str(t_launch)],
                 host_env(cards[k]), ROOT)
                for k in range(2) for i in range(len(cards[k]))]

    texts = run_hosts("tcp", specs)
    for t in texts:  # rank 0's results
        for line in t.splitlines():
            if line.startswith("multi tcp batched"):
                log(line)
    spread = report_ranks(tag, n, rank_lines(texts), ("tap_sum", "corr_pool",
                                                      "expand_scale_pair"))
    log(f"{tag}: hosts {cards} by CUDA_VISIBLE_DEVICES, initialize_multihost over "
        f"tcp://127.0.0.1 (NCCL), make_mesh({n}); the ranks started within {spread[0]:.1f} s "
        f"and joined within {spread[1]:.1f} s of each other")


def cli_rank(t_launch, argv):
    """(g1) one torchrun rank: ``train.cli.main(argv)`` as ``python -m
    patch2pix_tpu_torch.train.cli`` runs it, with phase 18's group
    timeout, then its report (host: torchrun's node rank)."""
    marks = {"up": time.time()}
    join = train_cli.initialize_multihost

    def timed_join(*a, **kw):
        join(*a, **kw)
        marks["joined"] = time.time()

    train_cli.initialize_multihost = timed_join
    train_cli.main(argv, group_timeout=MULTI_TIMEOUT)
    marks["done"] = time.time()
    rank_report(int(os.environ["GROUP_RANK"]), int(os.environ["RANK"]), t_launch, marks)
    return 0


def hold_cli_run(tag, got_dir, want_dir, argv):
    """``tests/test_torch_train_cli.py::test_cli_mesh2_equals_mesh1``'s
    rule for two runs of one step: the step count, the metrics line (rtol
    1e-5, atol 1e-6), the gradients (Adam's first moment over 0.1) within
    1e-4 of the largest, the parameters within Adam's bound, running
    averages rtol 1e-5 (atol 1e-6), frozen tensors bit-identical. Returns
    the largest errors and whether every tensor is ``torch.equal``."""
    got, want = checkpoint_model(got_dir), checkpoint_model(want_dir)
    met = []
    for d in (got_dir, want_dir):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            met.append(json.loads(f.read()))
    off = {k: (met[0].get(k), v) for k, v in met[1].items() if not isinstance(v, str)
           and not abs(met[0].get(k, np.inf) - v) <= 1e-6 + 1e-5 * abs(v)}
    cfg = train_cli.build_configs(train_cli.parse_args(argv))[0]
    names = [k for k, _ in Patch2Pix(cfg, device="cpu").named_parameters()
             if k.startswith("regress_")]
    grads = [{k: s["exp_avg"] / 0.1 for k, s in zip(names, ck["optimizer"]["state"].values())}
             for ck in (got, want)]
    scale = max(float(g.abs().max()) for g in grads[1].values())
    errs = {"grad / largest": max(float((grads[0][k] - grads[1][k]).abs().max())
                                  for k in names) / scale,
            "Adam excess": max(adam_step_excess(got["model"][k], want["model"][k], grads[0][k],
                                                grads[1][k]) for k in names)}
    running = [k for k in want["model"] if "running" in k]
    errs["running abs"] = max(float((got["model"][k] - want["model"][k]).abs().max())
                              for k in running)
    far = [k for k in running if not torch.allclose(got["model"][k], want["model"][k],
                                                    rtol=1e-5, atol=1e-6)]
    changed = [k for k in want["model"] if k.startswith(("extract.", "ncn."))
               and "running" not in k and not torch.equal(got["model"][k], want["model"][k])]
    if (got["step"] != want["step"] or off or met[0].keys() != met[1].keys()
            or errs["grad / largest"] > 1e-4 or errs["Adam excess"] > 0 or far or changed):
        fail(f"{tag}: steps {got['step']} / {want['step']}, {errs}; metrics off (got, want) "
             f"{off}; running averages off {far}; frozen tensors changed {changed}")
    equal = (all(torch.equal(got["model"][k], v) for k, v in want["model"].items())
             and all(torch.equal(got["optimizer"]["state"][i][k], v)
                     for i, st in want["optimizer"]["state"].items() for k, v in st.items()))
    return errs, equal


def multi_torchrun(n, e_run, e_argv):
    """Phase 18 (g1): the training CLI under a two-node ``torchrun``, (e)'s
    argv with ``--no_eval``, held to (e)'s run."""
    tag = f"multi torchrun [world {n}, 2 nodes]"
    cards = host_cards(n)
    root = os.path.join(MULTI_DIR, "torchrun")
    argv = list(e_argv)
    argv[argv.index("--out_dir") + 1] = "out"  # each host's own directory
    argv.append("--no_eval")
    hosts = [os.path.join(root, f"host{k}") for k in range(2)]
    for h in hosts:
        os.makedirs(h)
    t_launch = time.time()

    def specs(port):
        return [([sys.executable, "-m", "torch.distributed.run", "--nnodes", "2",
                  "--nproc-per-node", str(len(cards[k])), "--node-rank", str(k),
                  "--master-addr", "127.0.0.1", "--master-port", str(port),
                  os.path.join(ROOT, "chip_smoke.py"), "--cli-rank", str(t_launch), *argv],
                 host_env(cards[k]), hosts[k])
                for k in range(2)]

    t0 = time.perf_counter()
    texts = run_hosts("torchrun", specs)
    secs = time.perf_counter() - t0
    run = os.path.join(hosts[0], train_cli.run_dir_tags(train_cli.parse_args(argv)))
    with open(os.path.join(run, "log.txt")) as f:
        text = f.read()
    if (f"Mesh: {n}-rank data parallel" not in text or "Finished" not in text
            or os.path.exists(os.path.join(hosts[1], "out"))):
        fail(f"{tag}: node 1 wrote {os.path.exists(os.path.join(hosts[1], 'out'))}; log:\n"
             + text[-2000:])
    spread = report_ranks(tag, n, rank_lines(texts), ("tap_sum", "expand_scale_pair"))
    errs, equal = hold_cli_run(tag, run, e_run, argv)
    log(f"{tag} [python -m torch.distributed.run --nnodes 2 --nproc-per-node {n // 2}, static "
        f"rendezvous at 127.0.0.1, hosts {cards} by CUDA_VISIBLE_DEVICES; train.cli.main with "
        f"(e)'s argv and --no_eval, --mesh {n}]: {secs:.1f} s from the launch to both "
        f"launchers' exit, the ranks started within {spread[0]:.1f} s and joined within "
        f"{spread[1]:.1f} s of each other; 'Mesh: "
        f"{n}-rank data parallel' in the log; node 0's rank 0 alone wrote the run directory; "
        f"last.pt against (e)'s by test_cli_mesh2_equals_mesh1's rule: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (rules: gradients within 1e-4 of the largest, Adam's bound <= 0, running "
        f"averages rtol 1e-5, metrics rtol 1e-5, frozen tensors bit-identical); every tensor "
        f"and moment torch.equal to (e)'s: {equal}")


def multi_card_main(n):
    """``--cards n``: phase 1, then phase 18 on n cards."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    for line in smi:
        log(line)
    visible = torch.cuda.device_count()
    if visible < n:
        print(f"--cards {n}: {visible} CUDA card(s) visible", file=sys.stderr)
        return 3
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; cards "
        + ", ".join(torch.cuda.get_device_name(i) for i in range(n)))
    build_phase()
    t_phase = time.perf_counter()
    shutil.rmtree(MULTI_DIR, ignore_errors=True)
    os.makedirs(MULTI_DIR)
    try:
        pairs = write_batched_pairs(os.path.join(MULTI_DIR, "pairs"), MULTI_PAIRS)
        store = tempfile.mkdtemp(dir=MULTI_DIR)
        t_spawn = time.time()
        torch.multiprocessing.start_processes(spawned_rank,
                                              args=(multi_rank, n, store, pairs, t_spawn),
                                              nprocs=n, join=True, start_method="spawn")
        log(f"multi spawn: every rank joined {time.time() - t_spawn:.1f} s after the spawn")
        e_run = []
        for part, run in (("d, the scale demo",
                           lambda: sfm_demo_path(mesh=n, group_timeout=MULTI_TIMEOUT)),
                          ("e", lambda: e_run.extend(multi_cli(n))),
                          ("g1", lambda: multi_torchrun(n, *e_run)),
                          ("g2", lambda: multi_tcp(n, pairs)), ("f", lambda: multi_dryrun(n))):
            if part.startswith("g") and n < 2:
                log(f"multi part ({part}): two hosts need two cards; not run at --cards {n}")
                continue
            t0 = time.perf_counter()
            run()
            log(f"multi part ({part}): {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(MULTI_DIR, ignore_errors=True)
    log(f"multi-card phase: {time.perf_counter() - t_phase:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n}}))
    return 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Drive the PyTorch port on CUDA cards "
                                 "(phases 1-17 on one card; the module docstring).")
    ap.add_argument("--cards", type=int, default=None,
                    help="phase 1, then phase 18 alone on this many cards (1 rehearses it "
                    "at world size 1 on one card)")
    # phase 18 (g)'s rank processes
    ap.add_argument("--tcp-rank", nargs=5, metavar=("HOST", "RANK", "WORLD", "ADDRESS", "T0"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--cli-rank", nargs=argparse.REMAINDER, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cards is not None and args.cards < 1:
        ap.error("--cards N takes N >= 1")
    return args


def build_phase():
    """Phase 1: build every CUDA source, print the build time (and
    conv4d's alone, the slowest source) and ptxas's registers and
    spills."""
    others = [name for name in _build.KERNELS if name != "conv4d"]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        conv4d = pool.submit(_build.build, ["conv4d"])
        secs, reports = _build.build(others)
        conv4d_secs, conv4d_report = conv4d.result()
    reports.update(conv4d_report)
    PTXAS.update(reports)
    log(f"kernel build: {max(secs, conv4d_secs):.1f} s ({len(reports)} sources compiled; "
        f"conv4d {conv4d_secs:.1f} s)")
    for name, rep in reports.items():
        for line in rep.splitlines():
            # every kernel's registers, spills and ptxas's performance
            # warnings (wgmma serialised); the entry names of the wgmma
            # kernels and of patch_expand's B3 and B7 too
            if ("registers" in line or "spill" in line or "Performance" in line
                    or (name in ("corr_pool", "fine_head", "patch_expand")
                        and "Compiling entry" in line)):
                log(f"  {name}: {line.strip()}")


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    if args.tcp_rank:
        host, rank, world, address, t0 = args.tcp_rank
        return tcp_rank(int(host), int(rank), int(world), address, float(t0))
    if args.cli_rank:  # as (e)'s spawned ranks run: torch's default TF32 settings
        return cli_rank(float(args.cli_rank[0]), args.cli_rank[1:])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.cards is not None:
        return multi_card_main(args.cards)
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # phase 1: build
    build_phase()

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
    check_conv4d_cin1(gen, dev)
    torch.cuda.empty_cache()
    check_conv4d_mid(gen, dev)

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
    per_call, main_pairs_s = {}, {}
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
        main_pairs_s[cs] = pairs_s
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"main {tag} [{H}x{W} bf16 B={BATCH} fine_cap={FINE_CAP}]: "
            f"{pairs_s:.2f} pairs/s over 10 calls back to back; latency median "
            f"{np.median(times):.2f} ms/call of 10 (min {min(times):.2f}, max "
            f"{max(times):.2f}); peak device memory {peak_gb:.2f} GB; valid "
            f"matches per pair {n_valid}; launches per call {per_call[tag]}")
    main_counts = {k: counts()[k]
                   for k in ("tap_sum", "corr_pool", "expand_scale_pair", "conv4d_small")}
    log(f"main-path launches: {main_counts}")
    if min(main_counts.values()) == 0:
        fail(f"a kernel was not launched on the main path: {main_counts}")
    if conv4d_small.cin1_launches != main_counts["conv4d_small"]:
        fail(f"B4 on the main path: {main_counts['conv4d_small']} launches, "
             f"{conv4d_small.cin1_launches} of them the Cin-1 kernel's (the NCN's first layer)")
    # B4 runs the NCN's first layer (its Cin-1 kernel, once per symmetric
    # branch); B5 and B7 are off predict_fine: zero launches there
    off_path = {"conv4d_small": 2, "fused_fine_head": 0, "expand_level": 0}
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
    path_counts["conv4d_small"] += conv4d_path(dev)["conv4d_small"]
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
            if k in ("tap_sum", "corr_pool", "conv4d_small"):
                path_counts[k] += v

    # phase 13: evaluation (the RANSACs, immatch, HPatches)
    for k, v in eval_path(dev, sd).items():
        if k in ("tap_sum", "corr_pool", "expand_scale_pair"):
            path_counts[k] += v

    # phase 14: the SfM backend (BA, dist BA at world size 1, the scale demo)
    sfm_path(dev)

    # phase 15: the sharded paths at world size 1 (BatchedMatcher, the
    # sharded train step, the h1-sharded coarse matcher)
    for k, v in parallel_path(dev, sd, main_pairs_s, train_ms, ims).items():
        if k in ("tap_sum", "corr_pool", "expand_scale_pair"):
            path_counts[k] += v

    # phase 16: the tools' twins (demo, pair prep, a gather="block" run
    # directory, the synthetic training demo)
    for k, v in tools_path(dev, sd).items():
        if k in ("tap_sum", "corr_pool", "expand_scale_pair"):
            path_counts[k] += v

    # phase 17: report
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
