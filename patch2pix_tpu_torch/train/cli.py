"""Training entry point: ``python -m patch2pix_tpu_torch.train.cli``.

Port of ``patch2pix_tpu.train.cli``: the same flags and defaults, the
config-encoding run directory, the epoch loop over the MegaDepth pair
loader, checkpoints tagged ``last`` and ``ep{N}``, metrics as JSON
lines. One more flag, ``--device`` (the CUDA card unless given; the CPU
with ``--device cpu``).

Each epoch's data order is seeded with ``seed + epoch`` (as in JAX) and
its proposal draws with a generator seeded from ``(seed, epoch)``, so a
run resumed at an epoch boundary repeats the uninterrupted one.

Two things of the JAX CLI are not ported and raise at start-up, before
any step: a data-parallel ``--mesh`` above 1 (the sharded step), and the
per-epoch immatch validation, which a run without ``--no_eval`` needs
(``evaluation/immatch.py`` and the RANSAC of ``evaluation/geometry.py``
are not in the port).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from patch2pix_tpu_torch.config import ModelConfig, OptimConfig, RegressorConfig, resolve_device
from patch2pix_tpu_torch.data.megadepth import MegaDepthPairDataset, batch_iterator
from patch2pix_tpu_torch.data.prefetch import prefetch_to_device
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
from patch2pix_tpu_torch.train.checkpoint import load_ckpt, save_ckpt
from patch2pix_tpu_torch.train.state import create_train_state
from patch2pix_tpu_torch.train.step import make_train_step
from patch2pix_tpu_torch.utils.logging import (
    Logger,
    MetricsWriter,
    config2str,
    count_parameters,
    make_deterministic,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train Patch2Pix (PyTorch)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--save_step", type=int, default=1)
    p.add_argument("--plot_counts", type=int, default=5)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prefix", type=str, default="")
    p.add_argument("--out_dir", "-o", type=str, default="output/patch2pix")

    p.add_argument("--dataset", type=str, default="MegaDepth")
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--pair_root", type=str, default="data_pairs")
    p.add_argument("--match_npy", type=str,
                   default="megadepth_pairs.ov0.35_imrat1.5.pair500.excl_test.npy")

    p.add_argument("--backbone", type=str, default="ResNet34")
    p.add_argument("--change_stride", action="store_true")
    p.add_argument("--ksize", type=int, default=2)
    p.add_argument("--freeze_feat", type=int, default=87)
    p.add_argument("--feat_idx", type=int, nargs="*", default=[0, 1, 2, 3])
    p.add_argument("--feat_comb", type=str, default="pre")
    p.add_argument("--conv_kers", type=int, nargs="*", default=[3, 3])
    p.add_argument("--conv_dims", type=int, nargs="*", default=[512, 512])
    p.add_argument("--conv_strs", type=int, nargs="*", default=[2, 1])
    p.add_argument("--fc_dims", type=int, nargs="*", default=[512, 256])
    p.add_argument("--psize", type=int, nargs=2, default=[16, 16])
    p.add_argument("--pshift", type=int, default=8)
    p.add_argument("--panc", type=int, choices=[8, 1], default=8)
    p.add_argument("--ptmax", type=int, default=400)
    p.add_argument("--shared", action="store_true")

    p.add_argument("--cthres", type=float, default=0.5)
    p.add_argument("--cls_dthres", type=int, nargs=2, default=[50, 5])
    p.add_argument("--epi_dthres", type=int, nargs=2, default=[50, 5])

    p.add_argument("--pretrain", type=str, default=None)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--resume", action="store_true")

    p.add_argument("--lr_init", "-lr", type=float, default=5e-4)
    p.add_argument("--lr_decay", "-lrd", nargs="*", default=None)
    p.add_argument("--weight_decay", "-wd", type=float, default=0.0)
    p.add_argument("--weight_cls", "-wcls", type=float, default=10.0)
    p.add_argument("--weight_epi", "-wepi", type=float, nargs="*", default=[1, 1])

    p.add_argument("--mesh", type=int, default=0,
                   help="data-parallel mesh size; 0 and 1 train on one device, more "
                   "is not ported")
    p.add_argument("--steps_per_epoch", type=int, default=0,
                   help="cap batches per epoch (0 = full dataset)")
    p.add_argument("--no_eval", action="store_true",
                   help="skip the per-epoch immatch validation (required: it is not "
                   "ported)")
    p.add_argument("--wt", type=int, default=480, help="train image width")
    p.add_argument("--ht", type=int, default=320, help="train image height")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                   help="compute dtype (params stay f32)")
    p.add_argument("--remat", default="auto", choices=["auto", "none", "fine", "both", "dots"],
                   help="activation checkpointing of the regression stages; 'auto' is "
                   "'none' up to 12800 proposals per stage, else 'both'")
    p.add_argument("--backbone_train_bn", action="store_true",
                   help="batch statistics in the frozen backbone's BatchNorms while "
                   "training, as the reference's net.train() does (its running averages "
                   "move; default: running averages, as at eval)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; 'cpu' for the plain "
                   "PyTorch path)")
    return p.parse_args(argv)


def run_dir_tags(args) -> str:
    """The reference's config-encoded output directory."""
    pair_type = (args.match_npy.replace("megadepth_pairs.", "").replace("_imrat1.5", "")
                 .replace(".npy", ""))
    data_tag = "Mega." + pair_type
    odir = f"{args.prefix}.{data_tag}" if args.prefix else data_tag
    odir += f".freeze{args.freeze_feat}"
    if args.change_stride:
        odir += ".cs"
    if args.pretrain:
        odir += ".pretrain"

    feat = f"ks{args.ksize}fe{''.join(str(v) for v in args.feat_idx)}"
    thres = (f"ep{args.epi_dthres[0]}-{args.epi_dthres[1]}"
             f"cls{args.cls_dthres[0]}-{args.cls_dthres[1]}")
    train = (f"_wcls{args.weight_cls}wepi{args.weight_epi[0]}-{args.weight_epi[1]}"
             f".lr{args.lr_init}")
    if args.weight_decay > 0:
        train += f"wd{args.weight_decay}"
    if args.lr_decay:
        kind = args.lr_decay[0]
        short = {"step": "lrst", "multistep": "lrms"}.get(kind, kind)
        train += f"{short}{args.lr_decay[1]}-{args.lr_decay[2]}"
    regress = (f"{args.feat_comb}{args.ptmax}"
               f"_conv{''.join(map(str, args.conv_kers))}"
               f"dim{'-'.join(map(str, args.conv_dims))}"
               f"str{'-'.join(map(str, args.conv_strs))}"
               f"fc{'-'.join(map(str, args.fc_dims))}"
               f"_psz{args.psize[0]}-{args.psize[1]}a{args.panc}")
    if args.shared:
        regress += ".shared"
    return os.path.join(args.out_dir, odir, f"{feat}{thres}{train}", regress)


def build_configs(args):
    reg = RegressorConfig(feat_comb=args.feat_comb, conv_kers=tuple(args.conv_kers),
                          conv_dims=tuple(args.conv_dims), conv_strs=tuple(args.conv_strs),
                          fc_dims=tuple(args.fc_dims), psize=tuple(args.psize),
                          pshift=args.pshift, panc=args.panc, shared=args.shared)
    model_cfg = ModelConfig(backbone=args.backbone, change_stride=args.change_stride,
                            feat_idx=tuple(args.feat_idx), regressor=reg,
                            dtype=args.dtype).resolved()
    lr_decay = None
    if args.lr_decay:
        lr_decay = (args.lr_decay[0], float(args.lr_decay[1]),
                    *[int(float(v)) for v in args.lr_decay[2:]])
    optim_cfg = OptimConfig(opt="adam", lr_init=args.lr_init,
                            weight_decay=args.weight_decay, lr_decay=lr_decay,
                            epochs=args.epochs)
    return model_cfg, optim_cfg


def check_ported(args) -> None:
    """Raise on the options whose code is not in the port."""
    if args.mesh > 1:
        raise NotImplementedError(
            f"--mesh {args.mesh}: the data-parallel (sharded) train step is not ported; "
            "train on one device (--mesh 1)")
    if not args.no_eval:
        raise NotImplementedError(
            "the per-epoch immatch validation is not ported (evaluation/immatch.py's "
            "eval_immatch_val_sets and the RANSAC of evaluation/geometry.py); pass "
            "--no_eval")


def epoch_generator(seed: int, epoch: int, device):
    """The proposal draws' generator of one epoch, seeded from (seed,
    epoch)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, epoch]).generate_state(1)[0]))
    return gen


def load_pretrained(model, path: str) -> None:
    """Partial load of a reference ``.pth`` (e.g. NCNet-pretrained
    weights): keys the model lacks or shapes that differ raise, keys the
    file lacks keep their initial values."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    sd = {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}
    _, unexpected = model.load_state_dict(sd, strict=False)
    if unexpected:
        raise KeyError(f"pretrained keys not in the model: {unexpected}")


def main(argv=None) -> str:
    """Train as the flags say; returns the run directory."""
    args = parse_args(argv)
    check_ported(args)
    device = resolve_device(args.device)
    make_deterministic(args.seed)
    out_dir = run_dir_tags(args)
    os.makedirs(out_dir, exist_ok=True)
    log = Logger(os.path.join(out_dir, "log.txt"))
    log(config2str(args))
    log(f"Log dir {out_dir}")

    model_cfg, optim_cfg = build_configs(args)
    model = Patch2Pix(model_cfg, device=device)

    match_npy = os.path.join(args.pair_root, args.match_npy)
    dataset = MegaDepthPairDataset(args.data_root, match_npy, wt=args.wt, ht=args.ht)
    steps_per_epoch = len(dataset) // args.batch
    if args.steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.steps_per_epoch)
    log(f">>>Load dataset: MegaDepth, pairs:{len(dataset)} steps/epoch:{steps_per_epoch}")

    if args.pretrain:
        load_pretrained(model, args.pretrain)
        log(f"Load pretrained: {args.pretrain}")
    freeze = ["extract", "ncn"]
    if args.weight_epi[0] == 0:
        # the reference's quirk: a zero fine epi weight freezes the MID regressor
        freeze.append("regress_mid")
        log("Freeze regress_mid ...")
    state = create_train_state(model, optim_cfg, max(steps_per_epoch, 1), tuple(freeze))
    start_epoch = 0
    best_vals = [np.inf, 0.0, np.inf, 0.0]
    if args.resume and os.path.exists(os.path.join(out_dir, "last.meta.json")):
        state, meta = load_ckpt(out_dir, state, tag="last")
        start_epoch = meta["epoch"] + 1
        best_vals = meta.get("best_vals") or best_vals
        log(f"Resumed from epoch {start_epoch}")
    elif args.ckpt:
        state, meta = load_ckpt(args.ckpt, state, tag="last")
        log(f"Load model: {args.ckpt}")

    log("Params backbone={} ncn={} regress_mid={} regress_fine={}".format(
        *(count_parameters(getattr(model, name, None))
          for name in ("extract", "ncn", "regress_mid", "regress_fine"))))

    train_step = make_train_step(
        model, state.optimizer, ksize=args.ksize, ptmax=args.ptmax,
        cls_dthres=tuple(args.cls_dthres), epi_dthres=tuple(args.epi_dthres),
        weight_cls=args.weight_cls, weight_epi=tuple(args.weight_epi),
        backbone_train_bn=args.backbone_train_bn, remat=args.remat)

    writer = MetricsWriter(os.path.join(out_dir, "metrics.jsonl"), "train")
    t0 = time.time()
    log(f"Start training from {start_epoch} to {args.epochs} ..")
    for epoch in range(start_epoch, args.epochs):
        t1 = time.time()
        gen = epoch_generator(args.seed, epoch, device)
        it = prefetch_to_device(
            batch_iterator(dataset, args.batch, shuffle=True, seed=args.seed + epoch),
            size=2, device=device)
        for i, batch in enumerate(it):
            if i >= steps_per_epoch:
                break
            state, metrics = train_step(state, batch, generator=gen)
            writer.append(metrics)
            if steps_per_epoch >= args.plot_counts and (
                    i % max(steps_per_epoch // args.plot_counts, 1) == 0 and i > 0):
                log(f"Batch:{i} {writer.summary(['loss/pair', 'skipped'])}")
        it.close()
        means = writer.flush(epoch + 1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        log(f">Epoch:{epoch + 1} time:{time.time() - t1:.3f}s "
            + " ".join(f"{k}={v:.4f}" for k, v in sorted(means.items())))

        save_ckpt(out_dir, state, model_cfg, epoch, best_vals, tag="last")
        if (epoch + 1) % args.save_step == 0:
            save_ckpt(out_dir, state, model_cfg, epoch, best_vals, tag=f"ep{epoch + 1}")

    log(f"Finished, time:{time.time() - t0:.1f}s")
    log.close()
    return out_dir


if __name__ == "__main__":
    main()
