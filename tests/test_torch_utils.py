"""The port's utils against the JAX package's, on the CPU.

  * ``undo_normalize`` and ``side_by_side`` equal JAX's, also when given
    tensors; ``plot_matches`` writes a PNG (matplotlib's Agg backend),
    ``plot_epilines`` takes tensors;
  * ``trace`` writes a Chrome trace of the block; ``get_sys_mem`` reads
    this process's memory.
"""

import json
import os

import numpy as np
import torch

from patch2pix_tpu.utils import logging as jax_logging
from patch2pix_tpu.utils import plotting as jax_plotting
from patch2pix_tpu_torch.utils import logging, plotting, profiling
from tests.torch_threads import torch_threads_per_worker  # noqa: F401


def test_undo_normalize_and_side_by_side_equal_jax():
    rs = np.random.RandomState(0)
    im1 = rs.standard_normal((6, 8, 3)).astype(np.float32)
    im2 = rs.standard_normal((4, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(plotting.undo_normalize(im1), jax_plotting.undo_normalize(im1))
    np.testing.assert_array_equal(plotting.undo_normalize(torch.from_numpy(im1)),
                                  jax_plotting.undo_normalize(im1))
    got, want = plotting.side_by_side(im1, im2), jax_plotting.side_by_side(im1, im2)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == 8
    got = plotting.side_by_side(torch.from_numpy(im1), torch.from_numpy(im2))
    np.testing.assert_array_equal(got[0], want[0])


def test_plot_matches_writes_a_png(tmp_path):
    rs = np.random.RandomState(1)
    im = torch.from_numpy(rs.uniform(0, 1, (32, 48, 3)).astype(np.float32))
    matches = torch.from_numpy(rs.uniform(0, 30, (300, 4)).astype(np.float32))
    path = str(tmp_path / "m.png")
    plotting.plot_matches(im, im, matches, scores=torch.ones(300), save_path=path)
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    fig = plotting.plot_epilines(im, im, matches[:5], torch.eye(3))
    assert len(fig.axes) == 2


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(tmp_path, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


def test_get_sys_mem():
    rss, vms = logging.get_sys_mem()
    jrss, jvms = jax_logging.get_sys_mem()
    assert 0 < rss <= vms and 0 < jrss <= jvms
