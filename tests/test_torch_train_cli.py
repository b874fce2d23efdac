"""The port's training entry point against the JAX package's, on the CPU.

  * ``parse_args([])`` gives JAX's namespace plus ``--device``;
    ``run_dir_tags`` gives JAX's directory for six flag sets;
  * the options that are not ported (``--mesh`` above 1, a run without
    ``--no_eval``) raise before any step;
  * checkpoints: a save/load round trip restores the model, the
    optimizer and the step exactly; ``restore_for_eval`` (and
    ``load_model`` on the directory) rebuilds a model with ``panc = 1``
    whose matches equal the in-memory model's; the meta's
    ``model_config`` equals the JAX ``to_json`` of the same flags;
  * the CLI end to end on a MegaDepth-layout fixture at 96x64 with
    64-wide regressors: 2 epochs, then ``--resume`` for a third, give
    parameters, running averages and optimizer state ``torch.equal`` to 3
    uninterrupted epochs; ``init_patch2pix_matcher`` accepts the run
    directory; ``--pretrain`` loads a partial state dict and refuses
    unknown keys; a zero fine epi weight freezes ``regress_mid``, and
    ``--feat_comb``, ``--backbone_train_bn`` and ``--remat`` reach the
    step.
"""

import json
import os

import numpy as np
import pytest
import torch

from patch2pix_tpu.config import to_json as jax_to_json
from patch2pix_tpu.train import cli as jax_cli
from patch2pix_tpu_torch.config import ModelConfig, OptimConfig, RegressorConfig
from patch2pix_tpu_torch.data.synthetic import synthetic_batch, write_megadepth_fixture
from patch2pix_tpu_torch.evaluation.matcher import Matcher, init_patch2pix_matcher, load_model
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
from patch2pix_tpu_torch.train import cli, create_train_state, make_train_step
from patch2pix_tpu_torch.train.checkpoint import load_ckpt, read_meta, restore_for_eval, save_ckpt
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

FLAG_SETS = [
    [],
    ["--change_stride", "--lr_decay", "multistep", "0.2", "5", "--pretrain", "x.pth"],
    ["--prefix", "exp", "--weight_decay", "1e-4", "--lr_decay", "step", "0.5", "10",
     "--shared"],
    ["--feat_comb", "post", "--ptmax", "200", "--conv_dims", "256", "256", "--fc_dims", "128",
     "64", "--panc", "1", "-o", "runs"],
    ["--match_npy", "megadepth_pairs.ov0.5_imrat1.5.pair100.npy", "--feat_idx", "0", "2", "3",
     "--ksize", "1", "--freeze_feat", "10", "--conv_kers", "3", "5", "--conv_strs", "1", "1"],
    ["--weight_epi", "0", "1", "--cls_dthres", "40", "4", "--epi_dthres", "30", "3",
     "--weight_cls", "5", "-lr", "1e-3", "--psize", "16", "8", "--pshift", "4"],
]
REG = ["--conv_dims", "64", "64", "--fc_dims", "64", "32"]


def test_parse_args_defaults_equal_jax():
    got = vars(cli.parse_args([]))
    assert got.pop("device") is None
    assert got == vars(jax_cli.parse_args([]))


@pytest.mark.parametrize("flags", FLAG_SETS, ids=[str(i) for i in range(len(FLAG_SETS))])
def test_run_dir_tags_equal_jax(flags):
    assert cli.run_dir_tags(cli.parse_args(flags)) == jax_cli.run_dir_tags(
        jax_cli.parse_args(flags))


@pytest.mark.parametrize("flags,match", [(["--mesh", "2", "--no_eval"], "mesh"),
                                         ([], "immatch validation")], ids=["mesh", "eval"])
def test_unported_options_raise_at_start(tmp_path, flags, match):
    with pytest.raises(NotImplementedError, match=match):
        cli.main(flags + ["--device", "cpu", "--out_dir", str(tmp_path / "out"),
                          "--data_root", str(tmp_path / "none")])
    assert not (tmp_path / "out").exists()


def _small_model(seed):
    torch.manual_seed(seed)
    cfg = ModelConfig(change_stride=True, regressor=RegressorConfig(
        conv_dims=(64, 64), fc_dims=(64, 32))).resolved()
    return cfg, Patch2Pix(cfg, device="cpu")


def test_checkpoint_round_trip_and_restore_for_eval(tmp_path):
    cfg, model = _small_model(0)
    state = create_train_state(model, OptimConfig(lr_init=1e-3))
    step = make_train_step(model, state.optimizer, ksize=2, ptmax=8)
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(np.random.RandomState(0), 2, 64, 96).items()}
    state, _ = step(state, batch, generator=torch.Generator().manual_seed(0))
    save_ckpt(str(tmp_path), state, cfg, epoch=4, best_vals=[1.0, 2.0, 3.0, 4.0], tag="ep5")
    assert sorted(os.listdir(tmp_path)) == ["ep5.meta.json", "ep5.pt"]

    _, other = _small_model(1)
    fresh = create_train_state(other, OptimConfig(lr_init=1e-3))
    restored, meta = load_ckpt(str(tmp_path), fresh, tag="ep5")
    assert restored.step == 1 and meta["epoch"] == 4 and meta["best_vals"] == [1, 2, 3, 4]
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    want, got = state.optimizer.inner.state_dict(), restored.optimizer.inner.state_dict()
    assert want["param_groups"] == got["param_groups"]
    for i, s in want["state"].items():
        for k in s:
            assert torch.equal(got["state"][i][k], s[k])

    evaluated = restore_for_eval(str(tmp_path), "ep5", device="cpu")
    assert evaluated.config.regressor.panc == 1 and not evaluated.training
    assert load_model(str(tmp_path), device="cpu", tag="ep5").config.regressor.panc == 1
    model.config.regressor.panc = 1
    im1, im2 = batch["im1"][0].numpy(), batch["im2"][0].numpy()
    outs = [Matcher(m, device="cpu", io_thres=0.0).match_arrays(im1, im2)
            for m in (model, evaluated)]
    assert len(outs[0][0]) > 0
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def _cli_args(fixture, out_dir, epochs, *extra):
    data_root, pair_root, npy, _ = fixture
    return ["--data_root", data_root, "--pair_root", pair_root, "--match_npy", npy,
            "--out_dir", out_dir, "--epochs", str(epochs), "--batch", "2", "--ptmax", "8",
            "--wt", "96", "--ht", "64", "--steps_per_epoch", "2", "--save_step", "2",
            "--change_stride", "--no_eval", "--device", "cpu", *REG, *extra]


def test_cli_resumed_run_equals_uninterrupted(tmp_path):
    fixture = write_megadepth_fixture(str(tmp_path / "fx"), 6, 64, 96, seed=2)
    run = cli.main(_cli_args(fixture, str(tmp_path / "a"), 2))
    assert sorted(f for f in os.listdir(run) if f.endswith(".pt")) == ["ep2.pt", "last.pt"]
    assert read_meta(run)["epoch"] == 1
    assert cli.main(_cli_args(fixture, str(tmp_path / "a"), 3, "--resume")) == run
    whole = cli.main(_cli_args(fixture, str(tmp_path / "b"), 3))

    meta = read_meta(run)
    assert meta["epoch"] == 2 and meta == read_meta(whole)
    jax_args = _cli_args(fixture, "o", 3)
    i = jax_args.index("--device")
    del jax_args[i:i + 2]
    jax_cfg, _ = jax_cli.build_configs(jax_cli.parse_args(jax_args))
    assert meta["model_config"] == json.loads(jax_to_json(jax_cfg))
    got = torch.load(os.path.join(run, "last.pt"), weights_only=True)
    want = torch.load(os.path.join(whole, "last.pt"), weights_only=True)
    assert got["step"] == want["step"] == 6
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    ep2 = torch.load(os.path.join(run, "ep2.pt"), weights_only=True)["model"]
    for k in ("regress_fine.fc.6.weight", "regress_mid.conv.1.running_mean"):
        assert not torch.equal(ep2[k], want["model"][k]), k  # the third epoch moved them
    for i, s in want["optimizer"]["state"].items():
        for k in s:
            assert torch.equal(got["optimizer"]["state"][i][k], s[k])
    lines = [json.loads(x) for x in open(os.path.join(run, "metrics.jsonl"))]
    assert [x["epoch"] for x in lines] == [1, 2, 3]
    assert lines == [json.loads(x) for x in open(os.path.join(whole, "metrics.jsonl"))]

    matcher = init_patch2pix_matcher(run, device="cpu")
    assert matcher.model.config.regressor.panc == 1
    for k, p in matcher.model.state_dict().items():
        assert torch.equal(p, want["model"][k]), k


def test_cli_pretrain_loads_a_partial_state_dict(tmp_path):
    fixture = write_megadepth_fixture(str(tmp_path / "fx"), 2, 64, 96, seed=3)
    _, model = _small_model(5)
    ncn = {k: v for k, v in model.state_dict().items() if k.startswith("ncn.")}
    torch.save({"state_dict": ncn}, tmp_path / "ncn.pth")
    run = cli.main(_cli_args(fixture, str(tmp_path / "o"), 1, "--pretrain",
                             str(tmp_path / "ncn.pth")))
    assert ".pretrain" in run
    got = torch.load(os.path.join(run, "last.pt"), weights_only=True)["model"]
    for k, v in ncn.items():
        assert torch.equal(got[k], v), k  # the NCN is frozen
    torch.save({"state_dict": {**ncn, "ncn.extra": torch.zeros(1)}}, tmp_path / "bad.pth")
    with pytest.raises(KeyError, match="ncn.extra"):
        cli.main(_cli_args(fixture, str(tmp_path / "o2"), 1, "--pretrain",
                           str(tmp_path / "bad.pth")))


def test_cli_passes_its_training_flags(tmp_path):
    """``--weight_epi 0 1`` freezes ``regress_mid`` (the reference's quirk,
    kept); ``--feat_comb post``, ``--backbone_train_bn`` and ``--remat
    both`` reach the model and the step: the meta records ``post``, the
    backbone's running averages move and its weights do not, the fine
    regressor trains."""
    fixture = write_megadepth_fixture(str(tmp_path / "fx"), 2, 64, 96, seed=4)
    run = cli.main(_cli_args(fixture, str(tmp_path / "o"), 1, "--weight_epi", "0", "1",
                             "--feat_comb", "post", "--backbone_train_bn", "--remat", "both"))
    assert read_meta(run)["model_config"]["regressor"]["feat_comb"] == "post"
    assert "Freeze regress_mid ..." in open(os.path.join(run, "log.txt")).read()
    got = torch.load(os.path.join(run, "last.pt"), weights_only=True)["model"]
    torch.manual_seed(1)  # as the CLI seeds torch (--seed 1) before building its model
    init = Patch2Pix(ModelConfig(change_stride=True, regressor=RegressorConfig(
        feat_comb="post", conv_dims=(64, 64), fc_dims=(64, 32))).resolved(),
        device="cpu").state_dict()
    for k, v in init.items():
        if k.startswith("extract.") and ".layer4." not in k and "num_batches" not in k:
            assert torch.equal(got[k], v) != ("running" in k), k
        elif k.startswith("regress_mid.") and "num_batches" not in k and "running" not in k:
            assert torch.equal(got[k], v), k
        elif k.startswith("regress_fine.") and k.endswith("weight"):
            assert not torch.equal(got[k], v), k
