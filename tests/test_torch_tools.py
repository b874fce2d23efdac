"""The port's twins of the JAX package's three JAX-only tools, on the CPU.

  * ``data.prep_megadepth_pairs`` against ``tools/prep_megadepth_pairs.py``
    on ``tests/test_tools.py``'s synthetic ``scene_info``
    (``data.synthetic.write_scene_info`` builds it the same way): the
    same scenes, pairs and images in the same order from the same
    ``--seed``; every number within rtol 1e-6 (both are float64 numpy);
  * ``evaluation.demo_matching`` on two generated PNG pairs at 128 px,
    with random weights and with a run directory's checkpoint: one PNG
    per pair over 10 KB; ``--no_plot`` writes none;
  * ``train.synth_demo``: 2 steps at 96x128 write ``losses.csv`` (a row
    per step, the held-out errors at each chunk's end) and
    ``summary.json`` with the JAX tool's keys, and the curves PNG;
  * each twin takes every flag of its JAX tool (an AST scan of both).
"""

import ast
import csv
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from patch2pix_tpu_torch.config import ModelConfig, OptimConfig, RegressorConfig
from patch2pix_tpu_torch.data import prep_megadepth_pairs
from patch2pix_tpu_torch.data.synthetic import make_pair, write_scene_info
from patch2pix_tpu_torch.evaluation import demo_matching
from patch2pix_tpu_torch.models.patch2pix import seeded_patch2pix
from patch2pix_tpu_torch.train import create_train_state, save_ckpt, synth_demo
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import prep_megadepth_pairs as jax_prep  # noqa: E402

TWINS = {"tools/prep_megadepth_pairs.py": "patch2pix_tpu_torch/data/prep_megadepth_pairs.py",
         "examples/demo_matching.py": "patch2pix_tpu_torch/evaluation/demo_matching.py",
         "tools/train_synth_demo.py": "patch2pix_tpu_torch/train/synth_demo.py"}


def _flags(path):
    return {node.args[0].value for node in ast.walk(ast.parse((ROOT / path).read_text()))
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
            and node.args and isinstance(node.args[0], ast.Constant)}


@pytest.mark.parametrize("jax_tool", sorted(TWINS))
def test_twin_takes_the_jax_flags(jax_tool):
    want = _flags(jax_tool)
    assert want and want <= _flags(TWINS[jax_tool]), sorted(want - _flags(TWINS[jax_tool]))


def _pairs_npy(main, scene_root, out, *extra):
    main(["--base_dir", str(scene_root), "--save_dir", str(out), *extra])
    (name,) = os.listdir(out)
    return name, np.load(os.path.join(out, name), allow_pickle=True).item()


@pytest.mark.parametrize("seed,n_ims,extra", [
    (0, 4, ("--min_overlap_ratio", "0.3", "--exclude_tag", "", "--max_scene_pairs", "10")),
    (3, 6, ("--min_overlap_ratio", "0.2", "--max_scene_pairs", "4", "--seed", "5")),
])
def test_prep_twin_equals_the_jax_tool(tmp_path, seed, n_ims, extra):
    scene_root = tmp_path / "MegaDepth_undistort"
    write_scene_info(str(scene_root / "scene_info"), n_ims=n_ims, seed=seed)
    write_scene_info(str(scene_root / "scene_info"), scene="0024", n_ims=3, seed=seed)
    name, want = _pairs_npy(jax_prep.main, scene_root, tmp_path / "jax", *extra)
    got_name, got = _pairs_npy(prep_megadepth_pairs.main, scene_root, tmp_path / "port", *extra)
    assert got_name == name and list(got) == list(want) and "0001" in got
    assert ("0024" in got) == ("--exclude_tag" in extra)  # excl_test drops 0024
    for scene in want:
        assert [vars(i) for i in got[scene]["ims"]] == [vars(i) for i in want[scene]["ims"]]
        gp, wp = got[scene]["pairs"], want[scene]["pairs"]
        assert len(gp) == len(wp) > 0
        for a, b in zip(gp, wp):
            assert set(vars(a)) == set(vars(b))
            assert (a.im1, a.im2, a.crop1, a.crop2) == (b.im1, b.im2, b.crop1, b.crop2)
            for k in ("K1", "K2", "R", "t", "q", "overlap"):
                np.testing.assert_allclose(getattr(a, k), getattr(b, k), rtol=1e-6,
                                           atol=1e-12, err_msg=k)


@pytest.fixture
def png_pairs(tmp_path):
    rs = np.random.RandomState(0)
    root = tmp_path / "pairs"
    for i in range(2):
        d = root / f"pair_{i}"
        d.mkdir(parents=True)
        for j, im in enumerate(make_pair(rs, 96, 128)[:2]):
            Image.fromarray(np.clip(np.round(im * 255), 0, 255).astype(np.uint8)).save(
                d / f"{j + 1}.png")
    (root / "notes.txt").write_text("not a pair")
    return root


def _run_dir(path):
    cfg = ModelConfig(regressor=RegressorConfig(conv_dims=(64, 64), fc_dims=(64, 32)))
    model = seeded_patch2pix(cfg.resolved(), seed=1, device="cpu")
    save_ckpt(str(path), create_train_state(model, OptimConfig()), model.config, epoch=0)
    return str(path)


@pytest.mark.parametrize("ckpt", [False, True], ids=["random", "run_dir"])
def test_demo_twin_writes_a_plot_per_pair(tmp_path, png_pairs, ckpt):
    out = tmp_path / "out"
    argv = ["--pairs", str(png_pairs), "--out", str(out), "--imsize", "128", "--device", "cpu"]
    if ckpt:
        argv += ["--ckpt", _run_dir(tmp_path / "run")]
    done = demo_matching.main(argv)
    assert [d[0] for d in done] == ["pair_0", "pair_1"]
    assert sorted(os.listdir(out)) == ["pair_0.png", "pair_1.png"]
    for p in out.iterdir():
        assert p.stat().st_size > 10_000, p


def test_demo_twin_no_plot(tmp_path, png_pairs):
    out = tmp_path / "out"
    done = demo_matching.main(["--pairs", str(png_pairs), "--out", str(out), "--imsize", "128",
                               "--device", "cpu", "--no_plot"])
    assert len(done) == 2 and all(n >= 0 and s > 0 for _, n, s in done)
    assert not out.exists()


def _summary_keys():
    """The keys of the JAX tool's ``summary`` dict literal."""
    tree = ast.parse((ROOT / "tools" / "train_synth_demo.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", "") == "summary"):
            return {k.value for k in node.value.keys}
    raise AssertionError("no summary dict in the JAX tool")


def test_synth_demo_twin_writes_csv_and_summary(tmp_path):
    out = tmp_path / "synth"
    summary, rows = synth_demo.main([
        "--steps", "2", "--batch", "2", "--ht", "96", "--wt", "128", "--ptmax", "8",
        "--pool", "2", "--eval_every", "1", "--out", str(out), "--device", "cpu"])
    saved = json.loads((out / "summary.json").read_text())
    assert set(saved) == _summary_keys() == set(summary) and saved["steps"] == 2
    with open(out / "losses.csv") as f:
        table = list(csv.DictReader(f))
    assert [int(r["step"]) for r in table] == [0, 1] == [r["step"] for r in rows]
    for col in ("loss_pair", "loss_epi_fine", "loss_epi_mid", "skipped",
                "val_fine_sampson_px", "val_coarse_sampson_px", "val_fine_fixable_px"):
        assert all(np.isfinite(float(r[col])) for r in table), col
    assert (out / "curves.png").stat().st_size > 10_000
