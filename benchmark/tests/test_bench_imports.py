"""What a run loads and refuses: no module of top-level name jax, jaxlib,
flax or patch2pix_tpu (compared whole: the port's name begins with the
JAX package's), no result without CUDA, and none from a checkout that
holds only the benchmark."""

import json
import shutil
import subprocess
import sys

from benchmark import harness, run

SNIPPET = """
import sys, time, json
t = time.perf_counter()
from benchmark import harness, run
ov = {"traffic": {"height": 64, "width": 96, "pool_pairs": 2},
      "cell": {"warmup_calls": 1, "trace_calls": 1, "check_calls": 1}}
if sys.argv[1].startswith("p2p"):
    ov["cell"]["options"] = {"mutual": True, "ncn_thres": 0.0, "fine_cap": 16}
res = harness.run_cell(harness.Cell(sys.argv[1], overrides=ov), 9, 0.01, False, "cpu", t)
print(json.dumps({"found": run.forbidden_modules(), "correct": res["correct"]}))
"""


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "patch2pix_tpu_torch_fake", sys)
    assert "patch2pix_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.forbidden_modules()


def test_a_run_loads_no_jax(tmp_path):
    for cell in ("p2p_cs-match-b2", "ncnet_vgg16-match-b1"):
        p = subprocess.run([sys.executable, "-c", SNIPPET, cell], cwd=harness.ROOT,
                           capture_output=True, text=True, timeout=300)
        assert p.returncode == 0, p.stderr[-2000:]
        got = json.loads(p.stdout.strip().splitlines()[-1])
        assert got == {"found": [], "correct": True}


def test_no_result_without_cuda_or_without_the_program(tmp_path):
    args = ["-m", "benchmark.run", "--workload", "p2p_cs-match-b2", "--seed", "1",
            "--seconds", "1", "--trace", "0"]
    p = subprocess.run([sys.executable, *args], cwd=harness.ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark")
    p = subprocess.run([sys.executable, *args], cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""
