"""Training-convergence demonstration on synthetic epipolar pairs.

    python -m patch2pix_tpu_torch.train.synth_demo [--steps 300] [--out artifacts/synth_train_torch]

The port's twin of the JAX package's ``tools/train_synth_demo.py`` (the
same flags and defaults but ``--out``'s, which would otherwise write over
the JAX tool's committed run; the same ``losses.csv`` columns and
``summary.json`` keys): the full Patch2Pix stack, bf16, a fresh model of
the port's initialisers (seeded; ``--seed``), backbone and NCN frozen,
trained with ``make_train_step`` on a fixed pool of
``data/synthetic.py`` planar-scene pairs with an exact ground-truth F,
cycled; every ``--eval_every`` steps the held-out Sampson error of
``predict_fine`` on 8 unseen pairs. Defaults: the reference best-model
setting (batch 4, 480x320, ptmax 400, panc 8, Adam 5e-4).

Optional stages before the recipe, as in the JAX tool: ``--warmup_steps``
(a dense InfoNCE warm-up of the backbone on the pairs' exact plane
homographies) and ``--ncn_steps`` (NCNet weak-supervision pretraining of
the consensus filter). ``--refresh_pool`` draws fresh pairs after every
chunk, ``--unfreeze_tail`` trains layer3 too, ``--train_ncn`` the NCN,
``--real_textures GLOB`` textures the planes with random crops of the
photographs the glob matches (the JAX tool's flag takes no value and
reads the reference checkout's example pairs, which are not in this
repository).

Runs on CUDA unless ``--device`` names another device. The steps' wall
time excludes the first chunk (first-use builds and cuDNN's algorithm
search); the curves PNG needs matplotlib (``--no_plot`` skips it).
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import time

import numpy as np
import torch

from patch2pix_tpu_torch.config import ModelConfig, OptimConfig, resolve_device
from patch2pix_tpu_torch.data.synthetic import load_texture_pool, synthetic_batch
from patch2pix_tpu_torch.models.patch2pix import seeded_patch2pix
from patch2pix_tpu_torch.models.regressor import update_running_stats
from patch2pix_tpu_torch.ops.geometry import sampson_dist_batched
from patch2pix_tpu_torch.train.ncn_pretrain import make_ncn_pretrain_step
from patch2pix_tpu_torch.train.state import create_train_state, make_optimizer
from patch2pix_tpu_torch.train.step import make_train_step

CHUNK = 100  # warm-up and NCN steps between progress lines


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ht", type=int, default=320)
    ap.add_argument("--wt", type=int, default=480)
    ap.add_argument("--ptmax", type=int, default=400)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--pool", type=int, default=64, help="distinct pairs")
    ap.add_argument("--eval_every", type=int, default=25)
    ap.add_argument("--out", default="artifacts/synth_train_torch")
    ap.add_argument("--refresh_pool", action="store_true",
                    help="fresh synthetic pairs after every chunk of --eval_every steps")
    ap.add_argument("--unfreeze_tail", action="store_true",
                    help="train the backbone's layer3 too")
    ap.add_argument("--real_textures", default=None, metavar="GLOB",
                    help="texture the planes with crops of the photographs this glob matches")
    ap.add_argument("--warmup_steps", type=int, default=0,
                    help="dense InfoNCE warm-up of the backbone before the recipe")
    ap.add_argument("--ncn_steps", type=int, default=0,
                    help="NCNet weak-supervision pretraining of the NCN before the recipe")
    ap.add_argument("--train_ncn", action="store_true", help="train the NCN too")
    ap.add_argument("--seed", type=int, default=0, help="the fresh model's seed")
    ap.add_argument("--device", default=None, help="cuda unless given (e.g. cpu)")
    ap.add_argument("--no_plot", action="store_true", help="skip the curves PNG")
    return ap.parse_args(argv)


def warmup_loss(model, batch, stats):
    """Dense InfoNCE between the layer3 grids of the two homography-related
    views: the positive of view 1's cell i is the cell its centre maps to
    under the exact plane H. Returns (loss, cell-match accuracy)."""
    f1 = model.extract_pyramid(batch["im1"], stats)[-1]
    f2 = model.extract_pyramid(batch["im2"], stats)[-1]
    b, fh, fw, c = f1.shape
    ds = batch["im1"].shape[1] // fh
    dev = f1.device
    ys, xs = torch.meshgrid((torch.arange(fh, device=dev, dtype=torch.float32) + 0.5) * ds,
                            (torch.arange(fw, device=dev, dtype=torch.float32) + 0.5) * ds,
                            indexing="ij")
    pts = torch.stack([xs.reshape(-1), ys.reshape(-1), torch.ones(fh * fw, device=dev)])
    p2 = torch.einsum("bij,jn->bin", batch["H"], pts)
    ix = torch.floor(p2[:, 0] / p2[:, 2] / ds).long()
    iy = torch.floor(p2[:, 1] / p2[:, 2] / ds).long()
    ok = ((ix >= 0) & (ix < fw) & (iy >= 0) & (iy < fh)).float()
    labels = iy.clamp(0, fh - 1) * fw + ix.clamp(0, fw - 1)

    def l2n(f):
        f = f.reshape(b, fh * fw, c).float()
        return f * torch.rsqrt(torch.sum(f * f, -1, keepdim=True) + 1e-6)

    logits = torch.einsum("bnc,bmc->bnm", l2n(f1), l2n(f2)) / 0.07
    nll = -torch.gather(torch.log_softmax(logits, -1), 2, labels[..., None])[..., 0]
    n = torch.clamp(ok.sum(), min=1.0)
    acc = ((logits.argmax(-1) == labels).float() * ok).sum() / n
    return (nll * ok).sum() / n, acc.detach()


@torch.inference_mode()
def val_epi(model, val):
    """Held-out Sampson errors (px, each clipped at 50): the fine matches
    gated by confidence > 0.5 (all valid ones for a pair with none over
    it), the coarse matches, and the fine matches whose coarse error is
    within the regressors' +-16 px reach."""
    fine, _, cm = model.predict_fine(val["im1"], val["im2"], ksize=2)
    d = sampson_dist_batched(fine.coords, val["F"])
    conf = fine.valid & (fine.scores > 0.5)
    v = torch.where(conf.any(dim=1, keepdim=True), conf, fine.valid).float()
    fine_px = (torch.clamp(d, max=50.0) * v).sum() / torch.clamp(v.sum(), min=1.0)
    dc = sampson_dist_batched(cm.coords, val["F"])
    vc = cm.valid.float()
    coarse_px = (torch.clamp(dc, max=50.0) * vc).sum() / torch.clamp(vc.sum(), min=1.0)
    fx = (dc < 16.0).float() * fine.valid.float()
    fixable_px = (torch.clamp(d, max=50.0) * fx).sum() / torch.clamp(fx.sum(), min=1.0)
    return torch.stack([fine_px, coarse_px, fixable_px])


def main(argv=None):
    """Run the demo; returns ``(summary, rows)``: the ``summary.json``
    dict and one dict per step (its metrics, and the held-out errors at
    each chunk's last step)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    model = seeded_patch2pix(ModelConfig(dtype="bfloat16").resolved(), args.seed, dev)
    optim_cfg = OptimConfig(lr_init=args.lr)
    freeze = ("extract",) if args.train_ncn else ("extract", "ncn")
    if args.unfreeze_tail:
        freeze = ("extract/conv1", "extract/bn1", "extract/layer1*", "extract/layer2*", "ncn")

    texture_pool = None
    if args.real_textures:
        paths = sorted(glob.glob(args.real_textures))
        if not paths:
            raise FileNotFoundError(f"no texture images match {args.real_textures!r}")
        texture_pool = load_texture_pool(paths)

    def on_device(b):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    rs = np.random.RandomState(7)
    n_pool = args.pool // args.batch

    def fresh_pool():
        return [on_device(synthetic_batch(rs, args.batch, args.ht, args.wt,
                                          texture_pool=texture_pool,
                                          with_h=args.warmup_steps > 0))
                for _ in range(n_pool)]

    pool = fresh_pool()
    # held out: the same texture statistics, unseen geometry (8 pairs)
    val = on_device(synthetic_batch(np.random.RandomState(1234), 8, args.ht, args.wt,
                                    texture_pool=texture_pool))

    if args.warmup_steps:
        opt = make_optimizer(OptimConfig(lr_init=1e-3), model,
                             freeze=("ncn", "regress_mid", "regress_fine"))
        hist, t0 = [], time.time()
        for i in range(args.warmup_steps):
            stats = []
            loss, acc = warmup_loss(model, pool[i % n_pool], stats)
            opt.zero_grad()
            loss.backward()
            opt.step(i)
            with torch.no_grad():
                update_running_stats(stats)
            hist.append(torch.stack([loss.detach(), acc]))
            if (i + 1) % CHUNK == 0 or i + 1 == args.warmup_steps:
                last = torch.stack(hist[-20:]).mean(0).tolist()
                print(json.dumps({"warmup_step": i + 1, "nce_loss": last[0],
                                  "cell_match_acc": last[1]}))
                if args.refresh_pool:
                    pool = fresh_pool()
        print(json.dumps({"warmup_wall_s": round(time.time() - t0, 1)}))

    if args.ncn_steps:
        ncn_step, init_opt = make_ncn_pretrain_step(model, lr=1e-3, ksize=2)
        opt, hist, t0 = init_opt(), [], time.time()
        for i in range(args.ncn_steps):
            b, b2 = pool[i % n_pool], pool[(i + 1) % n_pool]
            hist.append(ncn_step(opt, {"im_src": b["im1"], "im_pos": b["im2"],
                                       "im_neg": b2["im1"]}))
            if (i + 1) % CHUNK == 0 or i + 1 == args.ncn_steps:
                print(json.dumps({"ncn_step": i + 1, **{
                    k.replace("/", "_"): float(torch.stack([h[k] for h in hist[-20:]]).mean())
                    for k in hist[-1]}}))
                if args.refresh_pool:
                    pool = fresh_pool()
        print(json.dumps({"ncn_wall_s": round(time.time() - t0, 1)}))

    # the recipe; the optimizer starts clean after either stage
    state = create_train_state(model, optim_cfg, freeze=freeze)
    step = make_train_step(model, state.optimizer, ksize=2, ptmax=args.ptmax)
    gen = torch.Generator(device=dev)
    gen.manual_seed(42)
    os.makedirs(args.out, exist_ok=True)
    val0 = val_epi(model, val).tolist()

    chunks = []  # (first step, per-step metrics on the device, held-out errors)
    done, timed_from, t0 = 0, None, None
    while done < args.steps:
        n = min(args.eval_every, args.steps - done)
        metrics = []
        for i in range(done, done + n):
            state, met = step(state, pool[i % n_pool], gen)
            metrics.append(met)
        if args.refresh_pool:
            pool = fresh_pool()
        chunks.append((done, metrics, val_epi(model, val)))
        done += n
        if timed_from is None:
            # the first chunk pays the first-use builds: time the rest
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            timed_from, t0 = done, time.time()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0

    rows = []
    for start, metrics, val_v in chunks:
        for j, met in enumerate(metrics):
            rows.append({"step": start + j,
                         **{k.replace("/", "_"): float(v) for k, v in met.items()}})
        fine_px, coarse_px, fixable_px = val_v.tolist()
        rows[-1].update(val_fine_sampson_px=fine_px, val_coarse_sampson_px=coarse_px,
                        val_fine_fixable_px=fixable_px)
        print(json.dumps({"step": rows[-1]["step"], "loss_pair": rows[-1]["loss_pair"],
                          "val_fine_sampson_px": fine_px, "val_coarse_sampson_px": coarse_px,
                          "val_fine_fixable_px": fixable_px}))
    keys = sorted({k for r in rows for k in r})
    with open(os.path.join(args.out, "losses.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)

    def win(key, sl):
        return float(np.mean([r[key] for r in rows][sl]))

    def evals(key):
        return [r[key] for r in rows if key in r]

    summary = {
        "steps": args.steps,
        "wall_s": round(wall, 1),
        # steady-state rate (the first chunk excluded)
        "ms_per_step_avg": round(1e3 * wall / max(args.steps - timed_from, 1), 1),
        "loss_pair_first25": win("loss_pair", slice(0, 25)),
        "loss_pair_last25": win("loss_pair", slice(-25, None)),
        "epi_fine_first25": win("loss_epi_fine", slice(0, 25)),
        "epi_fine_last25": win("loss_epi_fine", slice(-25, None)),
        "val_sampson_init": val0[0],
        "val_coarse_init": val0[1],
        "val_fixable_init": val0[2],
        "val_coarse_last": evals("val_coarse_sampson_px")[-1],
        "val_sampson_first": evals("val_fine_sampson_px")[0],
        "val_sampson_last": evals("val_fine_sampson_px")[-1],
        "val_fixable_first": evals("val_fine_fixable_px")[0],
        "val_fixable_last": evals("val_fine_fixable_px")[-1],
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    if args.no_plot:
        print("plot skipped (--no_plot)")
    else:
        from patch2pix_tpu_torch.utils.plotting import plot_train_curves

        plot_train_curves(rows, os.path.join(args.out, "curves.png"))
        print("plot:", os.path.join(args.out, "curves.png"))
    return summary, rows


if __name__ == "__main__":
    main()
