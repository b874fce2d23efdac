"""The port's parallel layer against the JAX package's, on the CPU.

  * ``shard_batch``: each rank's rows equal JAX's addressable shards of
    ``shard_batch`` on its fake 8-device mesh; ``make_mesh`` needs a
    process group beyond one rank; ``initialize_multihost`` is a no-op
    at one process or fewer;
  * ``format_comm_table`` equals JAX's on the same dict;
  * the conv4d folds under ``spmd_safe_dispatch`` (a constant in the
    port: no op reads it) are ``torch.equal`` to the folds outside it on
    the CPU, and equal JAX's under its gate, whose folds shift each
    pair's axis (f32 rounding, rtol 1e-5);
  * the h1-sharded coarse matcher, at 2 and 4 gloo ranks (one spawned
    group of 4, its first two ranks for 2; rank workers import no JAX)
    and at JAX's test shape (b 2, h1 8, w1 12, c 16, ksize 2): its
    Matches, on every rank, equal the port's single-device
    ``coarse_matches`` and JAX's ``make_sharded_coarse_matcher`` on the
    fake mesh — coords and valid flags equal, scores rtol 2e-5 / atol
    1e-6 (JAX's own rule);
  * its recorded collectives: all-reduces and all-gathers of O(B (na +
    nb)) scalars, and 8 collective-permutes (two per NCN layer and
    branch) of exactly one h1 row of the layer's input each; nothing at
    world size 1 but the all-reduces and all-gathers; a shape whose h1
    does not split raises;
  * a mesh of one rank inside the 4-rank job (no group) sends and
    records nothing and still equals the single-device matches.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from patch2pix_tpu.config import ModelConfig as JaxModelConfig
from patch2pix_tpu.models.patch2pix import Patch2Pix as JaxPatch2Pix
from patch2pix_tpu.ops.dispatch import spmd_safe_dispatch as jax_spmd_safe_dispatch
from patch2pix_tpu.parallel import comm_stats as jax_comm
from patch2pix_tpu.parallel import mesh as jax_mesh
from patch2pix_tpu.parallel.volume_sharding import (
    make_sharded_coarse_matcher as jax_sharded_coarse,
)
from patch2pix_tpu.utils.torch_import import convert_patch2pix_state_dict
from patch2pix_tpu_torch.config import ModelConfig
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
from patch2pix_tpu_torch.ops.dispatch import spmd_mode, spmd_safe_dispatch
from patch2pix_tpu_torch.parallel import comm_stats, mesh
from patch2pix_tpu_torch.parallel.volume_sharding import make_sharded_coarse_matcher
from tests.ref_loader import seeded_state_dict
from tests.torch_parallel_worker import run_group
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

B, H1, W1, C, KSIZE = 2, 8, 12, 16, 2
# the module (the package's ``conv4d`` attribute is the function)
jconv = importlib.import_module("patch2pix_tpu.ops.conv4d")
tconv = importlib.import_module("patch2pix_tpu_torch.ops.conv4d")


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_batch_rows_equal_jax_shards(n):
    batch = {"x": np.arange(8 * 4, dtype=np.float32).reshape(8, 4),
             "y": np.arange(8, dtype=np.float32)}
    want = jax_mesh.shard_batch(batch, jax_mesh.make_mesh(n))
    for r in range(n):
        m = mesh.Mesh("data", n, r, torch.device("cpu"))
        got = mesh.shard_batch(batch, m)
        for k in batch:
            shard = want[k].addressable_shards[r]
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(shard.data))
            assert shard.index[0] == mesh.rank_rows(8, m)
    assert mesh.data_sharding(m).axis == "data" and mesh.replicated(m).is_fully_replicated
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_batch({"x": np.zeros((3, 2))}, mesh.Mesh("data", 2, 0, torch.device("cpu")))


def test_make_mesh_and_initialize_multihost_single_process():
    m = mesh.make_mesh(device="cpu")
    assert (m.size, m.rank, m.group, m.shape) == (1, 0, None, {"data": 1})
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh(2, device="cpu")
    mesh.initialize_multihost(num_processes=1)  # must be a no-op
    mesh.initialize_multihost(num_processes=None)
    assert not torch.distributed.is_initialized()


def test_format_comm_table_equals_jax():
    stats = {"all-reduce": {"count": 3, "bytes": 5000},
             "collective-permute": {"count": 8, "bytes": 123456},
             "all-gather": {"count": 1, "bytes": 10}}
    assert comm_stats.format_comm_table(stats) == jax_comm.format_comm_table(stats)
    assert comm_stats.format_comm_table({}) == jax_comm.format_comm_table({})


def test_collectives_without_a_group_send_nothing():
    t = torch.ones(3)
    with comm_stats.record_collectives() as stats:
        comm_stats.all_reduce(t)
        assert comm_stats.all_gather(t)[0] is t
        assert comm_stats.exchange_halo(t, t) == (None, None)
    assert stats == {} and torch.equal(t, torch.ones(3))


@pytest.mark.parametrize("fold,cin,cout", [("fold_in", 1, 16), ("fold_out", 16, 1)])
def test_folds_under_the_gate(fold, cin, cout):
    rs = np.random.RandomState(0)
    x = rs.standard_normal((2, 5, 6, 4, 7, cin)).astype(np.float32)
    w = (rs.standard_normal((3, 3, 3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = rs.standard_normal(cout).astype(np.float32)
    fn = getattr(tconv, f"conv4d_{fold}")
    plain = fn(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    with spmd_safe_dispatch():
        assert spmd_mode()
        gated = fn(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert not spmd_mode()
    assert torch.equal(gated, plain)
    with jax_spmd_safe_dispatch():
        want = getattr(jconv, f"conv4d_{fold}")(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(gated.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _models():
    cfg = ModelConfig().resolved()
    port = Patch2Pix(cfg, device="cpu")
    sd = seeded_state_dict({k: tuple(v.shape) for k, v in port.state_dict().items()}, seed=7)
    tsd = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    port.load_state_dict(tsd)
    params, _ = convert_patch2pix_state_dict(sd)
    return cfg, port, tsd, jax.tree.map(jnp.asarray, params["ncn"])


def _features(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H1, W1, C)).astype(np.float32),
            rng.standard_normal((B, H1, W1, C)).astype(np.float32))


@pytest.fixture(scope="module")
def setting():
    cfg, port, tsd, ncn_params = _models()
    f1, f2 = _features()
    with torch.no_grad():
        single = port.coarse_matches(*port.coarse_corr(torch.from_numpy(f1),
                                                       torch.from_numpy(f2), KSIZE), KSIZE)
    return cfg, port, tsd, ncn_params, f1, f2, single


@pytest.fixture(scope="module")
def gloo_results(setting, tmp_path_factory):
    """One spawned gloo group of 4 CPU ranks runs every case."""
    cfg, _, tsd, _, f1, f2, _ = setting
    cases = {f"coarse{n}": ("coarse", n, (cfg, tsd, f1, f2, KSIZE)) for n in (2, 4)}
    # each rank alone: a mesh of one rank inside the 4-rank job
    cases.update({f"coarse1_{r}": ("coarse", (r,), (cfg, tsd, f1, f2, KSIZE))
                  for r in range(4)})
    return run_group(4, cases, tmp_path_factory.mktemp("gloo"))


def _assert_matches(coords, scores, valid, want_coords, want_scores, want_valid):
    np.testing.assert_array_equal(coords, want_coords)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_allclose(scores, want_scores, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_coarse_equals_single_device_and_jax(setting, gloo_results, n):
    _, _, _, ncn_params, f1, f2, single = setting
    jm = jax_sharded_coarse(JaxPatch2Pix(config=JaxModelConfig().resolved()),
                            JaxMesh(np.asarray(jax.devices()[:n]), ("cp",)), ksize=KSIZE)
    want = jax.jit(jm)({"params": {"ncn": ncn_params}}, jnp.asarray(f1), jnp.asarray(f2))
    for r in range(n):
        coords, scores, valid, _ = gloo_results[r][f"coarse{n}"]
        _assert_matches(coords, scores, valid, single.coords.numpy(), single.scores.numpy(),
                        single.valid.numpy())
        _assert_matches(coords, scores, valid, np.asarray(want.coords),
                        np.asarray(want.scores), np.asarray(want.valid))
    assert single.valid.any()


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_coarse_moves_no_volume(setting, gloo_results, n):
    port = setting[1]
    na = nb = (H1 // KSIZE) * (W1 // KSIZE)
    w1p, h2p, w2p = W1 // KSIZE, H1 // KSIZE, W1 // KSIZE
    row = B * w1p * h2p * w2p  # one h1 row of the pooled volume, one channel
    volume = B * na * nb * 4
    stats = gloo_results[0][f"coarse{n}"][3]
    assert set(stats) == {"all-reduce", "all-gather", "collective-permute"}
    assert stats["all-reduce"]["count"] == 6 and stats["all-gather"]["count"] == 3
    for kind in ("all-reduce", "all-gather"):
        per_op = stats[kind]["bytes"] / stats[kind]["count"]
        assert per_op <= 5 * 8 * B * (na + nb) < 16 * volume
    # per NCN branch: layer 1's input (1 channel, f32) and layer 2's (16
    # channels in the compute dtype), each one row up and one row down
    el = torch.finfo(port.ncn.dtype).bits // 8
    assert stats["collective-permute"] == {"count": 8,
                                           "bytes": 2 * 2 * (row * 4 + row * 16 * el)}


def test_one_rank_mesh_inside_a_larger_job_sends_nothing(setting, gloo_results):
    # its group is None: the default group of the job is not used
    single = setting[-1]
    for r in range(4):
        coords, scores, valid, stats = gloo_results[r][f"coarse1_{r}"]
        assert stats == {}
        _assert_matches(coords, scores, valid, single.coords.numpy(), single.scores.numpy(),
                        single.valid.numpy())


def test_sharded_coarse_one_rank_and_bad_split(setting):
    _, port, _, _, f1, f2, single = setting
    fn = make_sharded_coarse_matcher(port, mesh.make_mesh(device="cpu"), ksize=KSIZE)
    with comm_stats.record_collectives() as stats:
        got = fn(torch.from_numpy(f1), torch.from_numpy(f2))
    assert stats == {}
    _assert_matches(got.coords.numpy(), got.scores.numpy(), got.valid.numpy(),
                    single.coords.numpy(), single.scores.numpy(), single.valid.numpy())
    bad = make_sharded_coarse_matcher(port, mesh.Mesh("cp", 3, 0, torch.device("cpu")))
    with pytest.raises(ValueError, match="does not split"):
        bad(torch.from_numpy(f1), torch.from_numpy(f2))
