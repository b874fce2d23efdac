"""The harness finds a configuration, traffic mix, cell, driver and
metric by name: a new cell needs new files alone."""

import json
import shutil
import time

from benchmark import harness

TOY_DRIVER = '''
from benchmark.drivers.base import BaseDriver


class Driver(BaseDriver):
    def setup(self):
        self.n = self.traffic["units"]

    def call(self, i):
        return self.n, {"value": i * self.config["scale"]}

    def judge(self, i, out):
        return {"off": abs(out["value"] - i * self.config["scale"])}
'''

TOY_METRIC = '''
def read(record):
    return float(len(record["calls"]))
'''


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark")
    bench = tmp_path / "benchmark"
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy", "source": "none", "file": "benchmark/configs/toy.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "toy-cell", "config": "toy", "traffic": "toy-mix",
                              "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "toy_calls", "unit": "calls", "better": "higher",
                               "bound": 0.01, "source": "host_clock", "workloads": ["toy-cell"]})
    spec["per_layer"].append({"name": "toy_calls.layer", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "toy", "moves": "toy_calls"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (bench / "configs" / "toy.json").write_text(json.dumps({"name": "toy", "scale": 3}))
    (bench / "traffic" / "toy-mix.json").write_text(json.dumps({"units": 2}))
    (bench / "workloads" / "toy-cell.json").write_text(json.dumps(
        {"config": "toy", "traffic": "toy-mix", "driver": "toy", "warmup_calls": 0,
         "trace_calls": 2, "check_calls": 2, "limits": {"off": 0.0}}))
    (bench / "drivers" / "toy.py").write_text(TOY_DRIVER)
    (bench / "e2e_metrics" / "toy_calls.py").write_text(TOY_METRIC)
    (bench / "layer_metrics" / "toy_calls.layer.py").write_text(TOY_METRIC)

    cell = harness.Cell("toy-cell", tmp_path)
    assert sorted(m["name"] for m in cell.metrics("end_to_end")) == ["setup_s", "toy_calls"]
    assert [m["name"] for m in cell.metrics("per_layer")] == ["toy_calls.layer"]
    # cells already named keep their metrics
    assert "toy_calls.layer" not in [m["name"] for m in
                                     harness.Cell("p2p_cs-match-b2", tmp_path).metrics("per_layer")]
    for traced in (False, True):
        res = harness.run_cell(cell, 5, 0.05, traced, "cpu", time.perf_counter())
        assert res["correct"] and res["failed"] == 0
        assert res["checks"] == {"off": {"value": 0.0, "limit": 0.0}}
        name = "toy_calls.layer" if traced else "toy_calls"
        assert res["metrics"][name]["value"] == res["attempted"] >= 1
        assert ("setup_s" in res["metrics"]) != traced
