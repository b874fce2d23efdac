#!/usr/bin/env python
"""Convert a JAX run directory's orbax checkpoint to the PyTorch port's.

Runs wherever the JAX package runs (it needs JAX, optax and orbax; the
port never imports them). For one tag of a run directory written by
``patch2pix_tpu.train.checkpoint.save_ckpt`` (``{tag}/`` and
``{tag}.meta.json``) it

  * restores the tag with the JAX package's ``load_ckpt`` on the shapes
    of a ``create_train_state`` (``jax.eval_shape``; the model from the
    tag's meta, the optimizer from the flags below, as
    ``patch2pix_tpu.train.cli`` takes them): the step, the parameters,
    the BatchNorm statistics and the optax state;
  * builds the port's ``TrainState``: the weights through
    ``utils.jax_import.load_jax_variables``, the Adam moments and
    count (or SGD's momentum) through ``optimizer_state_from_jax``, the
    step count;
  * writes ``{tag}.pt`` with the port's ``save_ckpt`` beside the orbax
    directory (or into ``--out``), and ``{tag}.meta.json`` with the JAX
    meta's ``epoch``, ``best_vals`` and ``model_config``.

``--eval_only`` restores with the JAX package's template-free
``restore_for_eval`` instead and writes the weights without an optimizer
state (such a tag evaluates, and refuses to resume).

Then the port reads the directory on the card: ``train.restore_for_eval``,
``evaluation.matcher.load_model``, ``init_patch2pix_matcher`` and
``python -m patch2pix_tpu_torch.train.cli --resume``.

Usage:
  python tools/orbax_to_torch.py RUN_DIR [--tag last] [--out DIR] [--eval_only]
      [--lr_init 5e-4] [--lr_decay step 0.5 10] [--weight_decay 0] [--epochs 100]
      [--steps_per_epoch N] [--opt adam] [--freeze extract ncn]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("run_dir", help="the JAX run directory holding {tag}/ and {tag}.meta.json")
    p.add_argument("--tag", default="last")
    p.add_argument("--out", default=None, help="where {tag}.pt goes (default: run_dir)")
    p.add_argument("--eval_only", action="store_true",
                   help="weights only, restored without a template")
    # the optimizer the run was trained with, as train/cli.py takes it
    p.add_argument("--opt", choices=["adam", "sgd"], default="adam")
    p.add_argument("--lr_init", "-lr", type=float, default=5e-4)
    p.add_argument("--lr_decay", "-lrd", nargs="*", default=None)
    p.add_argument("--weight_decay", "-wd", type=float, default=0.0)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--steps_per_epoch", type=int, default=1)
    p.add_argument("--freeze", nargs="*", default=["extract", "ncn"],
                   help="the freeze patterns the run's optimizer state was built with")
    return p.parse_args(argv)


def optim_config(args, cls):
    lr_decay = None
    if args.lr_decay:
        lr_decay = (args.lr_decay[0], float(args.lr_decay[1]),
                    *[int(float(v)) for v in args.lr_decay[2:]])
    return cls(opt=args.opt, lr_init=args.lr_init, weight_decay=args.weight_decay,
               lr_decay=lr_decay, epochs=args.epochs)


def main(argv=None):
    args = parse_args(argv)

    import jax

    from patch2pix_tpu.config import OptimConfig as JaxOptimConfig
    from patch2pix_tpu.config import model_config_from_json as jax_model_config
    from patch2pix_tpu.models.patch2pix import Patch2Pix as JaxPatch2Pix
    from patch2pix_tpu.train import create_train_state as jax_create_train_state
    from patch2pix_tpu.train.checkpoint import load_ckpt as jax_load_ckpt
    from patch2pix_tpu.train.checkpoint import read_meta as jax_read_meta
    from patch2pix_tpu.train.checkpoint import restore_for_eval as jax_restore_for_eval
    from patch2pix_tpu_torch.config import OptimConfig, model_config_from_json
    from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
    from patch2pix_tpu_torch.train import TrainState, make_optimizer, save_ckpt
    from patch2pix_tpu_torch.utils.jax_import import load_jax_variables, optimizer_state_from_jax

    meta = jax_read_meta(args.run_dir, args.tag)
    cfg_json = json.dumps(meta["model_config"])
    model = Patch2Pix(model_config_from_json(cfg_json).resolved(), device="cpu")
    if args.eval_only:
        _, variables = jax_restore_for_eval(args.run_dir, args.tag)
        load_jax_variables(model, variables)
        state = TrainState(0, model, None)
    else:
        # the state's structure and shapes only: tracing the model's init
        # is enough, running it is not needed
        template = jax.eval_shape(lambda: jax_create_train_state(
            jax.random.PRNGKey(0), JaxPatch2Pix(config=jax_model_config(cfg_json).resolved()),
            optim_config(args, JaxOptimConfig), image_shape=(1, 96, 128, 3),
            steps_per_epoch=args.steps_per_epoch, freeze=tuple(args.freeze)))
        restored, _ = jax_load_ckpt(args.run_dir, template, args.tag)
        load_jax_variables(model, {"params": restored.params,
                                   "batch_stats": restored.batch_stats})
        optimizer = make_optimizer(optim_config(args, OptimConfig), model,
                                   args.steps_per_epoch, tuple(args.freeze))
        optimizer.inner.load_state_dict(
            optimizer_state_from_jax(restored.opt_state, model, optimizer))
        state = TrainState(int(restored.step), model, optimizer)
    out = args.out or args.run_dir
    save_ckpt(out, state, model.config, meta["epoch"], meta.get("best_vals"), args.tag)
    print(f"wrote {os.path.join(out, args.tag)}.pt: step {state.step}, epoch {meta['epoch']}"
          + (", weights only" if args.eval_only else ""))


if __name__ == "__main__":
    main()
