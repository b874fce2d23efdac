"""The multi-host entry points on the CPU: ``initialize_multihost`` over
TCP and the training CLI under a two-node ``torchrun``, each "host" a
process of its own (gloo, one thread each).

  * ``train.cli.mesh_size`` under a ``torchrun`` environment (``RANK``
    and ``WORLD_SIZE`` set) takes the job's world as the mesh: ``--mesh
    0`` is ``WORLD_SIZE``, another ``--mesh`` than ``WORLD_SIZE`` raises
    at start-up, and the card check is ``LOCAL_RANK`` < visible cards, so
    a mesh larger than one host's cards can start; without that
    environment ``--mesh`` may not exceed the visible cards. ``main``
    joins the torchrun group and never spawns ranks of its own there;
  * two processes join one gloo group through
    ``initialize_multihost("127.0.0.1:P", 2, k, device="cpu")`` and
    ``make_mesh(2)``: over it the dry run's tiny ``BatchedMatcher``
    equals world size 1's matches (``tests/test_torch_dryrun.py``'s
    rule), and each rank's ``shard_batch`` rows equal JAX's shards;
  * two ``torch.distributed.run`` launchers (``--nnodes 2
    --nproc-per-node 1``, static rendezvous at 127.0.0.1), each in a
    working directory of its own, run ``python -m
    patch2pix_tpu_torch.train.cli --mesh 2`` on the CPU: rank 0 alone
    writes the run directory, whose log says ``Mesh: 2-rank data
    parallel``, and its ``last.pt`` equals the spawned ``--mesh 2`` run's
    by ``tests/test_torch_train_cli.py::test_cli_mesh2_equals_mesh1``'s
    rule.

The child processes import no JAX. A port is picked by binding to port
0; a run that finds its port taken is retried once on another.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from patch2pix_tpu.parallel import mesh as jax_mesh
from patch2pix_tpu_torch.config import ModelConfig
from patch2pix_tpu_torch.data.synthetic import write_megadepth_fixture
from patch2pix_tpu_torch.evaluation.batched import BatchedMatcher
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
from patch2pix_tpu_torch.parallel import dryrun, make_mesh
from patch2pix_tpu_torch.train import cli
from tests.test_torch_train_cli import _cli_args, assert_runs_close
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_multihost_worker.py")
# a child that has not ended by then has hung
CHILD_TIMEOUT = 240
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT", "GROUP_RANK", "ROLE_RANK", "TORCHELASTIC_RUN_ID")


def _torchrun_env(monkeypatch, world, rank, local_rank):
    monkeypatch.setenv("WORLD_SIZE", str(world))
    monkeypatch.setenv("RANK", str(rank))
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))


@pytest.fixture
def four_cards(monkeypatch):
    """No torchrun variable, and ``torch.cuda.device_count()`` 4."""
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)


@pytest.mark.parametrize("mesh", [8, 0])
def test_mesh_size_under_torchrun_is_the_world(four_cards, monkeypatch, mesh):
    # two hosts of 4 cards: rank 5 is the second host's card 1
    _torchrun_env(monkeypatch, 8, 5, 1)
    args = cli.parse_args(["--mesh", str(mesh), "--batch", "8"])
    assert cli.mesh_size(args, torch.device("cuda")) == 8


@pytest.mark.parametrize("world,local,flags,match", [
    (8, 1, ["--mesh", "4"], "--mesh 4 under torchrun: WORLD_SIZE 8"),
    (8, 4, ["--mesh", "8"], "LOCAL_RANK 4: 4 CUDA card"),
    (8, 1, ["--mesh", "0", "--batch", "4"], "--mesh 8 does not divide --batch 4"),
], ids=["mesh", "local_rank", "batch"])
def test_mesh_size_under_torchrun_raises(four_cards, monkeypatch, world, local, flags, match):
    _torchrun_env(monkeypatch, world, 5, local)
    args = cli.parse_args(flags + ([] if "--batch" in flags else ["--batch", "8"]))
    with pytest.raises(ValueError, match=match):
        cli.mesh_size(args, torch.device("cuda"))


def test_mesh_size_without_torchrun_counts_the_local_cards(four_cards):
    with pytest.raises(ValueError, match="--mesh 8: 4 CUDA card"):
        cli.mesh_size(cli.parse_args(["--mesh", "8", "--batch", "8"]), torch.device("cuda"))
    assert cli.mesh_size(cli.parse_args(["--batch", "8"]), torch.device("cuda")) == 4
    assert cli.mesh_size(cli.parse_args(["--batch", "8"]), torch.device("cpu")) == 1


class _Joined(Exception):
    pass


@pytest.mark.parametrize("mesh", ["0", "2"])
def test_main_joins_torchrun_and_never_spawns(four_cards, monkeypatch, tmp_path, mesh):
    _torchrun_env(monkeypatch, 2, 1, 0)
    joined = []

    def join(address, n, rank, **kw):
        joined.append((address, n, rank, kw["backend"]))
        raise _Joined

    def spawn(*a, **kw):
        raise AssertionError("a torchrun rank spawned ranks of its own")

    monkeypatch.setattr(cli, "initialize_multihost", join)
    monkeypatch.setattr(torch.multiprocessing, "start_processes", spawn)
    with pytest.raises(_Joined):
        cli.main(["--mesh", mesh, "--batch", "2", "--device", "cpu", "--no_eval",
                  "--out_dir", str(tmp_path / "out")])
    assert joined == [(None, 2, 1, "gloo")]
    assert not (tmp_path / "out").exists()


def free_port():
    """A TCP port on 127.0.0.1 that nothing listened on a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in TORCHRUN_ENV:
        env.pop(k, None)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
    return env


def _run_together(commands):
    """Run ``[(argv, cwd), ...]`` at once; returns [(exit code, output)].
    A child still running after ``CHILD_TIMEOUT`` s is killed, as are
    the others once one fails."""
    procs = [subprocess.Popen(argv, cwd=cwd, env=_child_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for argv, cwd in commands]
    out = []
    try:
        for p in procs:
            try:
                text, _ = p.communicate(timeout=CHILD_TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                text, _ = p.communicate()
            out.append((p.returncode, text))
            if p.returncode:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()
    return out


def _on_a_free_port(make_commands):
    """``_run_together(make_commands(port))`` that must succeed; run
    again once on another port where the first one was taken."""
    for attempt in range(2):
        commands = make_commands(free_port())
        out = _run_together(commands)
        if len(out) == len(commands) and all(rc == 0 for rc, _ in out):
            return out
        taken = any("address already in use" in text.lower() for _, text in out)
        if not taken or attempt:
            pytest.fail("\n\n".join(f"exit {rc}:\n{text[-3000:]}" for rc, text in out))
    raise AssertionError("unreachable")


def test_initialize_multihost_over_tcp(tmp_path):
    hosts = [tmp_path / f"host{k}" for k in range(2)]
    for h in hosts:
        h.mkdir()
    _on_a_free_port(lambda port: [
        ([sys.executable, WORKER, str(k), "2", f"127.0.0.1:{port}", str(hosts[k])], str(hosts[k]))
        for k in range(2)])
    got = [pickle.load(open(h / "result.pkl", "rb")) for h in hosts]
    assert [(g["rank"], g["world"], g["backend"], g["mesh"]) for g in got] == [
        (k, 2, "gloo", ("data", 2, k, "cpu")) for k in range(2)]

    # each rank's rows of the dry run's batch are JAX's shards
    batch = dryrun.train_batches(2)[2]
    want = jax_mesh.shard_batch(batch, jax_mesh.make_mesh(2))
    for k, g in enumerate(got):
        for name in batch:
            np.testing.assert_array_equal(g["rows"][name],
                                          np.asarray(want[name].addressable_shards[k].data))

    # the tiny BatchedMatcher over the TCP group equals world size 1's
    for g in got:
        b = g["batched"]
        assert b["B"] == 2 and {k: v["count"] for k, v in b["comm"].items()} == {"all-gather": 1}
    pairs = dryrun.write_pairs(str(tmp_path), 2)
    model = Patch2Pix(ModelConfig().resolved(), device="cpu")
    model.load_state_dict(dryrun.template_state())
    want = BatchedMatcher(model, mesh=make_mesh(1, device="cpu"),
                          ksize=dryrun.KSIZE).match_pairs(pairs)
    for g in got:
        assert len(g["batched"]["results"]) == len(want) == 2
        for (gm, gs, gc), (wm, ws, wc) in zip(g["batched"]["results"], want):
            assert len(wc) > 0
            i, j = np.lexsort(gc.T[::-1]), np.lexsort(wc.T[::-1])
            np.testing.assert_array_equal(gc[i], wc[j])
            np.testing.assert_allclose(gm[i], wm[j], rtol=0, atol=1e-3)
            np.testing.assert_allclose(gs[i], ws[j], rtol=0, atol=1e-4)


def test_cli_under_two_node_torchrun(tmp_path):
    fixture = write_megadepth_fixture(str(tmp_path / "fx"), 2, 64, 96, seed=7)
    argv = _cli_args(fixture, "out", 1, "--mesh", "2", "--steps_per_epoch", "1")
    hosts = [tmp_path / f"host{k}" for k in range(2)]
    for h in hosts:
        h.mkdir()
    out = _on_a_free_port(lambda port: [
        ([sys.executable, "-m", "torch.distributed.run", "--nnodes", "2", "--nproc-per-node",
          "1", "--node-rank", str(k), "--master-addr", "127.0.0.1", "--master-port", str(port),
          "-m", "patch2pix_tpu_torch.train.cli", *argv], str(hosts[k]))
        for k in range(2)])
    run = os.path.join(hosts[0], cli.run_dir_tags(cli.parse_args(argv)))
    # rank 0 alone wrote the run directory: rank 1's host has none
    assert os.path.exists(os.path.join(run, "last.pt")), out[0][1][-3000:]
    assert not os.path.exists(hosts[1] / "out")
    assert "Mesh: 2-rank data parallel" in open(os.path.join(run, "log.txt")).read()

    spawned = cli.main(_cli_args(fixture, str(tmp_path / "spawned"), 1, "--mesh", "2",
                                 "--steps_per_epoch", "1"))
    assert_runs_close(run, spawned)
