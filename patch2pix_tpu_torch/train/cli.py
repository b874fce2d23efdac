"""Training entry point: ``python -m patch2pix_tpu_torch.train.cli``.

Port of ``patch2pix_tpu.train.cli``: the same flags and defaults, the
config-encoding run directory, the epoch loop over the MegaDepth pair
loader, checkpoints tagged ``last`` and ``ep{N}``, metrics as JSON
lines. One more flag, ``--device`` (the CUDA card unless given; the CPU
with ``--device cpu``).

Each epoch's data order is seeded with ``seed + epoch`` (as in JAX) and
its proposal draws with a generator seeded from ``(seed, epoch)``, so a
run resumed at an epoch boundary repeats the uninterrupted one.

After each epoch, unless ``--no_eval``, the JAX CLI's validation: the
PhotoTourism immatch protocol on ``{data_root}/immatch_benchmark/val_dense``
(150 pairs a scene at most) through a ``Matcher`` at ksize 2, io_thres
0.5, imsize 1024 over the training model itself, in ``eval()`` and
under ``torch.inference_mode()``; an ``immatch_best`` checkpoint when the
mean pose error or the 0.34/0.33/0.33 pass-rate mix improves. A raise
there is logged (``Failed to eval immatch``) and training goes on, as in
JAX.

``--mesh N`` trains data-parallel over N ranks with the step over a
mesh (``train/step.make_train_step(..., mesh=)``). Under ``torchrun``
(``RANK`` and ``WORLD_SIZE`` set; ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` too) every rank joins the job's group through
``parallel.mesh.initialize_multihost``, on its host's card ``LOCAL_RANK``:
the mesh is the job's world, across hosts too, so ``--mesh 0`` is
``WORLD_SIZE`` and another N raises. A rank of such a job never spawns
ranks of its own. Otherwise ``--mesh N`` spawns N ranks from a
``file://`` store, one card each (gloo processes with ``--device cpu``),
and ``--mesh 0`` is every visible card, 1 on the CPU. It raises at
start-up when N exceeds this host's cards or does not divide
``--batch``. Every rank reads the same global batch order and takes its
rows; rank 0 alone writes the
checkpoints, metrics and log, and runs the validation, while the other
ranks wait at a barrier at the epoch's end. The process group's timeout,
``GROUP_TIMEOUT`` (``main(..., group_timeout=)``), bounds that wait.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
import traceback
from datetime import timedelta

import numpy as np
import torch

from patch2pix_tpu_torch.config import ModelConfig, OptimConfig, RegressorConfig, resolve_device
from patch2pix_tpu_torch.data.megadepth import MegaDepthPairDataset, batch_iterator
from patch2pix_tpu_torch.data.prefetch import prefetch_to_device
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
from patch2pix_tpu_torch.parallel.mesh import (
    abort_process_group,
    initialize_multihost,
    make_mesh,
    process_group,
    shard_batch,
    spawned_rank,
)
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
                   help="data-parallel mesh size: ranks, one device each; 0 is every "
                   "visible card (1 on the CPU)")
    p.add_argument("--steps_per_epoch", type=int, default=0,
                   help="cap batches per epoch (0 = full dataset)")
    p.add_argument("--no_eval", action="store_true")
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


# how long a rank waits in a collective: the end-of-epoch barrier waits
# for rank 0's checkpoints and its whole validation
GROUP_TIMEOUT = timedelta(hours=6)


def torchrun_world():
    """``WORLD_SIZE`` where this process is a rank of a ``torchrun`` job
    (``RANK`` and ``WORLD_SIZE`` set), else None."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    return None


def mesh_size(args, device) -> int:
    """The ranks ``--mesh`` asks for. Under ``torchrun`` the mesh is the
    job's world, which may span hosts: ``--mesh 0`` is ``WORLD_SIZE``,
    and another N than ``WORLD_SIZE`` raises, as does a ``LOCAL_RANK``
    beyond this host's cards. Otherwise 0 is every visible card (1 on
    the CPU), and N may not exceed them. Raises too where N does not
    divide ``--batch``."""
    cards = torch.cuda.device_count() if device.type == "cuda" else None
    world = torchrun_world()
    if world is not None:
        n = args.mesh or world
        if n != world:
            raise ValueError(f"--mesh {n} under torchrun: WORLD_SIZE {world}")
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if cards is not None and local >= cards:
            raise ValueError(f"LOCAL_RANK {local}: {cards} CUDA card(s) visible")
    else:
        n = args.mesh or (cards or 1)
        if cards is not None and n > cards:
            raise ValueError(f"--mesh {n}: {cards} CUDA card(s) visible")
    if args.batch % n:
        raise ValueError(f"--mesh {n} does not divide --batch {args.batch}")
    return n


class _Silent:
    """The log of a rank other than 0."""

    def __call__(self, msg: str) -> None:
        pass

    def close(self) -> None:
        pass


def validate(model, data_root: str, device, log):
    """The per-epoch immatch validation of the training ``model``: its
    matches at the JAX CLI's evaluation setting, on running BatchNorm
    statistics and without autograd. Every module's train/eval flag is
    restored afterwards, whatever happens. Returns (qt_mean, pass
    rates)."""
    from patch2pix_tpu_torch.evaluation.immatch import eval_immatch_val_sets
    from patch2pix_tpu_torch.evaluation.matcher import Matcher

    modes = [(m, m.training) for m in model.modules()]
    try:
        with torch.inference_mode():
            matcher = Matcher(model, ksize=2, io_thres=0.5, imsize=1024, eval_type="fine",
                              device=device)
            qt_err, pass_rate, _ = eval_immatch_val_sets(
                matcher, data_root=os.path.join(data_root, "immatch_benchmark/val_dense"),
                sample_max=150, log=log, device=device)
    finally:
        for m, training in modes:
            m.train(training)
    return qt_err, pass_rate


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


def main(argv=None, group_timeout: timedelta = GROUP_TIMEOUT) -> str:
    """Train as the flags say; returns the run directory.
    ``group_timeout``: how long a rank of ``--mesh`` waits in a
    collective or at the end-of-epoch barrier."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    n = mesh_size(args, device)
    if n == 1:
        return train(args, device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if torchrun_world() is not None:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(device)
        initialize_multihost(None, n, int(os.environ["RANK"]), backend=backend,
                             timeout=group_timeout)
        try:
            run = train(args, device, make_mesh(n, device=device))
        except BaseException:
            abort_process_group()
            raise
        torch.distributed.destroy_process_group()
        return run
    with tempfile.TemporaryDirectory() as store:
        torch.multiprocessing.start_processes(
            spawned_rank, args=(_rank_main, n, backend, store, args, group_timeout), nprocs=n,
            join=True, start_method="spawn")
    return run_dir_tags(args)


def _rank_main(rank: int, n: int, backend: str, store: str, args,
               timeout: timedelta) -> None:
    """One spawned rank of ``--mesh n``: its group, its device, its rows."""
    device = torch.device("cpu")
    if backend == "nccl":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:  # the CPU ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // n))
    with process_group(n, rank, backend, store, timeout=timeout):
        train(args, device, make_mesh(n, device=device))


def train(args, device, mesh=None) -> str:
    """The training run on this rank (all of it without a ``mesh``);
    returns the run directory."""
    lead = mesh is None or mesh.rank == 0
    make_deterministic(args.seed)
    out_dir = run_dir_tags(args)
    if lead:
        os.makedirs(out_dir, exist_ok=True)
    log = Logger(os.path.join(out_dir, "log.txt")) if lead else _Silent()
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

    step_kwargs = dict(
        ksize=args.ksize, ptmax=args.ptmax, cls_dthres=tuple(args.cls_dthres),
        epi_dthres=tuple(args.epi_dthres), weight_cls=args.weight_cls,
        weight_epi=tuple(args.weight_epi), backbone_train_bn=args.backbone_train_bn,
        remat=args.remat)
    train_step = make_train_step(model, state.optimizer, mesh=mesh, **step_kwargs)
    if mesh is not None:
        log(f"Mesh: {mesh.size}-rank data parallel")

    writer = MetricsWriter(os.path.join(out_dir, "metrics.jsonl"), "train") if lead else None
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
            if mesh is not None:
                batch = shard_batch(batch, mesh)
            state, metrics = train_step(state, batch, generator=gen)
            if lead:
                writer.append(metrics)
            if lead and steps_per_epoch >= args.plot_counts and (
                    i % max(steps_per_epoch // args.plot_counts, 1) == 0 and i > 0):
                log(f"Batch:{i} {writer.summary(['loss/pair', 'skipped'])}")
        it.close()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if lead:
            means = writer.flush(epoch + 1)
            log(f">Epoch:{epoch + 1} time:{time.time() - t1:.3f}s "
                + " ".join(f"{k}={v:.4f}" for k, v in sorted(means.items())))

            save_ckpt(out_dir, state, model_cfg, epoch, best_vals, tag="last")
            if (epoch + 1) % args.save_step == 0:
                save_ckpt(out_dir, state, model_cfg, epoch, best_vals, tag=f"ep{epoch + 1}")

            if not args.no_eval:
                try:
                    qt_err, pass_rate = validate(model, args.data_root, device, log)
                    rate = 0.34 * pass_rate[0] + 0.33 * pass_rate[4] + 0.33 * pass_rate[9]
                    if qt_err < best_vals[2] or rate > best_vals[3]:
                        best_vals[2] = min(qt_err, best_vals[2])
                        best_vals[3] = max(rate, best_vals[3])
                        save_ckpt(out_dir, state, model_cfg, epoch, best_vals, tag="immatch_best")
                        log(f">>Save best immatch model: epoch={epoch + 1} "
                            f"qt={qt_err:.3f} rate={rate:.2f}%")
                except Exception as e:  # a failed validation never stops training, as in JAX
                    log(f"Failed to eval immatch: {e}\n{traceback.format_exc()}")
        if mesh is not None:
            # the other ranks wait here, not in the next epoch's first
            # collective, while rank 0 writes and validates
            torch.distributed.barrier(group=mesh.group)

    log(f"Finished, time:{time.time() - t0:.1f}s")
    log.close()
    return out_dir


if __name__ == "__main__":
    main()
