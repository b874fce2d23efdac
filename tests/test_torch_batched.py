"""The port's ``BatchedMatcher`` against its ``Matcher`` and JAX's, on the CPU.

At the JAX package's setting (``tests/test_evaluation.py``
``test_batched_matcher_sharded``: three 240x320 pairs, imsize 128, the
default ResNet34 upsample-16 model) with one seeded state dict in both
packages:

  * ``predict_fine(..., stack_backbone=False)`` (one backbone call per
    side) is ``torch.equal`` to the stacked call;
  * ``BatchedMatcher`` at world size 1 (in this process) and 2 (the
    first two ranks of one spawned gloo group of 2; rank workers import
    no JAX) equals the port's ``Matcher`` pair by pair, on every rank,
    and JAX's ``BatchedMatcher`` on a fake 2-device mesh: the same
    coarse matches, coords within 1e-3 px, scores within 1e-4;
  * no collective is recorded at world size 1, and at world size 2 only
    the one ``all_gather_object`` of the results: the device work moves
    none; a chunk's padding rows are dropped (per_chip_batch 2 over 3
    pairs);
  * ``eval_hpatches(..., batch_matcher=BatchedMatcher(...))`` equals the
    protocol run pair by pair through ``Matcher``.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from patch2pix_tpu.config import ModelConfig as JaxModelConfig
from patch2pix_tpu.evaluation.batched import BatchedMatcher as JaxBatchedMatcher
from patch2pix_tpu.models.patch2pix import Patch2Pix as JaxPatch2Pix
from patch2pix_tpu.parallel.mesh import make_mesh as jax_make_mesh
from patch2pix_tpu.utils.torch_import import convert_patch2pix_state_dict
from patch2pix_tpu_torch.config import ModelConfig
from patch2pix_tpu_torch.evaluation import BatchedMatcher, Matcher
from patch2pix_tpu_torch.evaluation.hpatches import eval_hpatches
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
from patch2pix_tpu_torch.parallel import make_mesh, record_collectives
from tests.ref_loader import seeded_state_dict
from tests.torch_parallel_worker import run_group
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

KW = dict(ksize=2, io_thres=0.25, imsize=128)


def _by_coarse(out):
    """(matches, scores, coarse) rows in the lexicographic order of the
    coarse matches."""
    order = np.lexsort(np.asarray(out[2]).T[::-1])
    return [np.asarray(a)[order] for a in out]


def assert_pair_close(got, want):
    got, want = _by_coarse(got), _by_coarse(want)
    assert len(got[0]) == len(want[0]) > 0
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def setting(tmp_path_factory):
    cfg = ModelConfig().resolved()
    port = Patch2Pix(cfg, device="cpu")
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in port.state_dict().items()}, seed=3)
    tsd = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    port.load_state_dict(tsd)
    params, stats = convert_patch2pix_state_dict(sd)
    variables = {"params": jax.tree.map(jnp.asarray, params),
                 "batch_stats": jax.tree.map(jnp.asarray, stats)}
    rng = np.random.default_rng(3)
    d = tmp_path_factory.mktemp("pairs")
    paths = []
    for i in range(3):
        p = str(d / f"b{i}.jpg")
        Image.fromarray(rng.integers(0, 255, (240, 320, 3), np.uint8)).save(p)
        paths.append(p)
    pairs = [(paths[0], paths[1]), (paths[1], paths[2]), (paths[0], paths[2])]
    matcher = Matcher(port, device="cpu", **KW)
    singles = [matcher.estimate_matches(a, b) for a, b in pairs]
    return cfg, port, tsd, variables, pairs, singles


@pytest.fixture(scope="module")
def gloo_results(setting, tmp_path_factory):
    """One spawned gloo group of 2 CPU ranks runs every case."""
    cfg, _, tsd, _, pairs, _ = setting
    cases = {"default": ("batched", 2, (cfg, tsd, pairs, KW)),
             "pcb2": ("batched", 2, (cfg, tsd, pairs, dict(KW, per_chip_batch=2)))}
    return run_group(2, cases, tmp_path_factory.mktemp("gloo"))


def test_stack_backbone_false_equals_true(setting):
    port = setting[1]
    rs = np.random.RandomState(0)
    im1, im2 = (torch.from_numpy(rs.standard_normal((2, 96, 128, 3)).astype(np.float32))
                for _ in range(2))
    stacked = port.predict_fine(im1, im2, ksize=2)
    apart = port.predict_fine(im1, im2, ksize=2, stack_backbone=False)
    for s, a in zip(stacked, apart):
        for x, y in zip(s, a):
            assert torch.equal(x, y)


def test_batched_one_rank_equals_matcher(setting):
    _, port, _, _, pairs, singles = setting
    bm = BatchedMatcher(port, mesh=make_mesh(1, device="cpu"), **KW)
    assert bm.per_chip_batch == 1  # upsample 16
    with record_collectives() as stats:
        out = bm.match_pairs(pairs)
    assert stats == {}
    for got, want in zip(out, singles):
        assert_pair_close(got, want)
    assert_pair_close(bm(*pairs[1]), singles[1])


@pytest.mark.parametrize("case", ["default", "pcb2"])
def test_batched_two_ranks_equals_matcher_and_jax(setting, gloo_results, case):
    _, _, _, variables, pairs, singles = setting
    jm = JaxPatch2Pix(config=JaxModelConfig().resolved())
    want = JaxBatchedMatcher(jm, variables, mesh=jax_make_mesh(2), **KW).match_pairs(pairs)
    for rank in range(2):
        out, stats = gloo_results[rank][case]
        assert len(out) == 3
        assert set(stats) == {"all-gather"} and stats["all-gather"]["count"] == 1
        for got, single, jax_out in zip(out, singles, want):
            assert_pair_close(got, single)
            assert_pair_close(got, jax_out)


def test_eval_hpatches_takes_the_batched_matcher(setting, tmp_path):
    port = setting[1]
    rng = np.random.default_rng(0)
    for seq, H in {"i_a": np.eye(3), "v_b": np.diag([1.5, 1.5, 1.0])}.items():
        d = tmp_path / seq
        d.mkdir()
        for k in (1, 2, 3):
            Image.fromarray(rng.integers(0, 255, (96, 128, 3), np.uint8)).save(str(d / f"{k}.png"))
        for k in (2, 3):
            np.savetxt(str(d / f"H_1_{k}"), H)
    quiet = dict(log=lambda *_: None)
    bm = BatchedMatcher(port, mesh=make_mesh(1, device="cpu"), per_chip_batch=2, **KW)
    via = eval_hpatches(None, str(tmp_path), batch_matcher=bm, **quiet)
    per_pair = eval_hpatches(Matcher(port, device="cpu", **KW), str(tmp_path), **quiet)
    assert via.failed == per_pair.failed == [] and sum(via.num_matches) > 0
    assert via.num_matches == per_pair.num_matches
    np.testing.assert_allclose(via.mma(), per_pair.mma(), atol=1e-12)
