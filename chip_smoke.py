#!/usr/bin/env python3
"""Drive the PyTorch port (``patch2pix_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

  1. print the card's name and power limit, build the three CUDA kernels
     (one ``nvcc`` per source, in parallel) and print the build time;
  2. for each kernel (B1 tap_sum, B2 corr_pool, B3 expand_scale_pair), at
     the shapes of the main path (change_stride, 1024x768, B=2, bf16) and
     in float32: hold the kernel against its plain PyTorch version on the
     card, time kernel, plain version and library yardstick, and compute
     the bound from the bytes and operations this run's inputs need;
  3. golden parity in float32 with TF32 off: rebuild the seeded weights
     and reproduce ``tests/fixtures/pipeline_golden_{s16,cs}_1024.npz``
     (identical coarse set, coords 0.05 px, scores 5e-3) — every kernel's
     launch count must rise;
  4. the main path in bf16 at 1024x768: ``Matcher.match_arrays`` on one
     pair, then ``Patch2Pix.predict_fine`` at B=2, fine_cap 1200, for
     change_stride and upsample 16: output checks, kernel launches per
     call, pairs/s over 10 calls back to back, the median latency of 10
     calls each waited for, peak device memory; then, per stride, the
     top device kernels and the device busy share over 3 calls under
     torch.profiler (after the launch counts are read);
  5. one JSON line of per-kernel numbers, then the result line.

Needs one CUDA card, ``nvcc`` and the repository checkout; imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from patch2pix_tpu_torch.config import ModelConfig
from patch2pix_tpu_torch.evaluation.matcher import Matcher
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
from patch2pix_tpu_torch.ops import _build
from patch2pix_tpu_torch.ops.corr_pool import corr_pool, corr_pool_plain
from patch2pix_tpu_torch.ops.correlation import l2_normalize
from patch2pix_tpu_torch.ops.patch_expand import (
    expand_scale_pair,
    expand_scale_pair_plain,
    output_slice_map,
)
from patch2pix_tpu_torch.ops.tap_sum import flat_shift_masks, tap_sum, tap_sum_plain
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
}

# the main path's setting: 1024x768, B=2, fine_cap 1200
H, W, BATCH, FINE_CAP = 768, 1024, 2, 1200


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


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def reset_counts():
    for fn in KERNELS:
        fn.launches = 0


def counts():
    return {KERNELS[fn][0]: fn.launches for fn in KERNELS}


# ------------------------------------------------------------ phase 2


def check_tap_sum(dtype, gen, dev):
    """B1 at the cs main-path shape: N = B*48*64 cells, HW = 48*64."""
    bs, h1, w1, hw = BATCH, H // 16, W // 16, (H // 16) * (W // 16)
    n = bs * h1 * w1
    z = torch.randn((n, 9, hw), generator=gen, device=dev).to(dtype)
    bias = torch.randn((1,), generator=gen, device=dev)
    got = tap_sum(z, bias, bs, h1, w1)
    want = tap_sum_plain(z, bias, bs, h1, w1)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"tap_sum {dtype}: not bit-identical to the plain version "
             f"(max err {(got - want).abs().max().item()})")
    err = (got - want).abs().max().item()
    ms = time_ms(lambda: tap_sum(z, bias, bs, h1, w1))
    plain_ms = time_ms(lambda: tap_sum_plain(z, bias, bs, h1, w1), iters=5)
    # the function reads z only at the taps its masks keep
    taps = sum(int(mask.sum()) for _, mask in flat_shift_masks(bs, h1, w1, dev))
    z_bytes = taps * hw * z.element_size()
    b_ms, b_by = bound(z_bytes + nbytes(bias, got), (taps + n) * hw, torch.float32)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                shape=f"z {tuple(z.shape)} {dtype} -> {tuple(got.shape)} f32")


def check_corr_pool(dtype, gen, dev):
    """B2 at the cs main-path shape: layer3 (B, 96, 128, 256)."""
    h, w, c = H // 8, W // 8, 256
    f1 = l2_normalize(torch.randn((BATCH, h, w, c), generator=gen, device=dev)).to(dtype)
    f2 = l2_normalize(torch.randn((BATCH, h, w, c), generator=gen, device=dev)).to(dtype)
    got = corr_pool(f1, f2)
    want = corr_pool_plain(f1, f2)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not err <= 1e-4:
        fail(f"corr_pool {dtype}: max abs err {err} > 1e-4")
    ms = time_ms(lambda: corr_pool(f1, f2))
    plain_ms = time_ms(lambda: corr_pool_plain(f1, f2), iters=5)

    def library():
        c4 = torch.bmm(f1.reshape(BATCH, h * w, c), f2.reshape(BATCH, h * w, c).transpose(1, 2))
        return c4.reshape(BATCH, h // 2, 2, w // 2, 2, h // 2, 2, w // 2, 2).amax(dim=(2, 4, 6, 8))

    library_ms = time_ms(library, iters=5)
    flops = 2 * BATCH * (h * w) * (h * w) * c
    b_ms, b_by = bound(nbytes(f1, f2, got), flops, dtype)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms,
                shape=f"2x {tuple(f1.shape)} {dtype} -> {tuple(got.shape)} f32")


def check_expand(dtype, gen, dev):
    """B3 at the cs main-path shape: M = B*fine_cap proposals, levels
    (t, C) = (16, 3), (8, 64), (4, 64), (2, 128)."""
    m, psize = BATCH * FINE_CAP, 16
    levels = ((16, 3), (8, 64), (4, 64), (2, 128))
    rows = [[torch.randn((m, 4, t, t * c), generator=gen, device=dev).to(dtype)
             for t, c in levels] for _ in range(2)]
    corners = [torch.randint(0, W + psize, (m,), generator=gen, device=dev,
                             dtype=torch.int32) for _ in range(4)]
    args = (rows[0], rows[1], *corners, psize, dtype)
    got = expand_scale_pair(*args)
    want = expand_scale_pair_plain(*args)
    torch.cuda.synchronize()
    err = 0.0
    for g, w_ in zip(got, want):
        if g.shape != w_.shape or g.dtype != w_.dtype:
            fail(f"expand_scale_pair {dtype}: output {g.shape} vs {w_.shape}")
        diff = (g.float() - w_.float()).abs()
        err = max(err, diff.max().item())
        if dtype == torch.float32 and (diff > 1e-6 * w_.abs()).any():
            fail(f"expand_scale_pair f32: {int((diff > 1e-6 * w_.abs()).sum())} "
                 f"values beyond rtol 1e-6 (max rel err "
                 f"{(diff / w_.abs().clamp_min(1e-30)).max().item():.3g})")
    note = ""
    if dtype == torch.bfloat16:
        # a flip needs the two f32 inverse norms, a few f32 ulps apart, to
        # straddle a bf16 rounding midpoint; a bf16 ulp is 2^16 f32 ulps,
        # so flips are rare: one pixel in 10^4 at most
        flipped, pixels, max_ulps = expand_bf16_mismatch(got, want, levels, psize)
        if flipped * 1e4 > pixels:
            fail(f"expand_scale_pair bf16: {flipped} of {pixels} patch pixels "
                 f"disagree with the plain version")
        note = f", {flipped} of {pixels} pixels flipped inv (max {max_ulps:.3g} ulps off)"
    ms = time_ms(lambda: expand_scale_pair(*args))
    plain_ms = time_ms(lambda: expand_scale_pair_plain(*args), iters=5)
    flops = 3 * 2 * m * psize * psize * sum(c for _, c in levels)
    rows_bytes = window_bytes(levels, corners, psize, rows[0][0].element_size())
    b_ms, b_by = bound(rows_bytes + nbytes(*corners, *got), flops, torch.float32)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                shape=f"M={m} rows {[tuple(r.shape) for r in rows[0]]} {dtype}{note}, "
                      f"window reads {rows_bytes / 1e6:.1f} MB of "
                      f"{nbytes(*rows[0], *rows[1]) / 1e6:.1f} MB rows")


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
    """Bytes of superblock rows that B3's outputs depend on: for each
    proposal, side and level, the cells its patch window covers (t or
    t+1 along each axis, by the corner's alignment), C channels each."""
    total = 0
    for t, c in levels:
        ds = psize // t
        for y0, x0 in (corners[0:2], corners[2:4]):
            cells = 1
            for b in (y0, x0):
                b = b.long().clamp_min(0)
                cells = cells * ((b + psize - 1) // ds - b // ds + 1)
            total += int(cells.sum()) * c * elsize
    return total


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
    """The top device kernels and the device busy share over ``iters``
    main-path calls (torch.profiler)."""
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
    for name, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]:
        log(f"  kernel {us / iters / 1e3:8.3f} ms/call x{n // iters:<4d} {name[:110]}")


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
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # phase 2: kernels against their plain versions
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    checks = {tap_sum: check_tap_sum, corr_pool: check_corr_pool,
              expand_scale_pair: check_expand}
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
    golden_counts = counts()
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
    main_counts = counts()
    log(f"main-path launches: {main_counts}")
    if min(main_counts.values()) == 0:
        fail(f"a kernel was not launched on the main path: {main_counts}")
    expect = {"change_stride (upsample 8)": {"tap_sum": 2, "corr_pool": 1,
                                             "expand_scale_pair": 2},
              "upsample 16": {"tap_sum": 2, "corr_pool": 1,
                              "expand_scale_pair": 1}}
    if per_call != expect:
        fail(f"launches per call {per_call}, expected {expect}")
    for cs, model in models.items():
        profile_main_path(
            "change_stride (upsample 8)" if cs else "upsample 16",
            lambda: model.predict_fine(ims[0], ims[1], ksize=2, fine_cap=FINE_CAP))

    # phase 5: report
    line = {"kernels": [
        dict(name=KERNELS[fn][0], route="cuda", source=KERNELS[fn][1],
             replaces=KERNELS[fn][2], launches=main_counts[KERNELS[fn][0]],
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
