"""What every entry driver offers the harness.

A driver is built for one cell, seed and device. ``setup`` builds the
program's instance, makes the seeded weights and inputs and warms up the
cell's shapes; ``call(i)`` runs the i-th timed call and returns (units of
work, its outputs as the caller receives them); ``stages`` names the
instance methods whose device time a traced run reads; ``judge(i, out)``
holds the outputs of call i against the plain reference and returns the
compared numbers; ``free_program`` drops the instance before the judge
runs, so that the reference neither shares its memory nor sets the
memory peak.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


class BaseDriver:
    def __init__(self, cell, seed: int, device):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.options = cell.cell.get("options", {})
        self.seed = int(seed)
        self.device = torch.device(device)

    def setup(self) -> None:
        raise NotImplementedError

    def call(self, i: int) -> Tuple[int, Dict]:
        raise NotImplementedError

    def judge(self, i: int, out: Dict) -> Dict[str, float]:
        raise NotImplementedError

    def stages(self) -> Dict[str, List]:
        return {}

    def warm_up(self) -> None:
        for i in range(self.cell.cell["warmup_calls"]):
            self.call(i)
        self.finish()

    def finish(self) -> None:
        """Wait for the work the calls queued (a window ends in it)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def counters(self) -> Dict:
        """What the readers need of the model: its operations a call, the
        shapes its kernels run at."""
        return {}

    def reading(self, side: str) -> Dict[str, float]:
        """The compared numbers of the cell's first ``check_calls`` calls
        (as many as a run judges) on one side: 'program', 'control' (the
        reference in float8 in the program's place) or 'bfloat16' (the
        reference with bfloat16 operands)."""
        worst: Dict[str, float] = {}
        outs = []
        for i in range(self.cell.cell["check_calls"]):
            outs.append(self.call(i)[1] if side == "program" else None)
        self.free_program()
        for i, out in enumerate(outs):
            got = out if side == "program" else self.control(
                i, "fp8" if side == "control" else "bfloat16")
            for name, value in self.judge(i, got).items():
                worst[name] = max(worst.get(name, 0.0), float(value))
        return worst

    def free_program(self) -> None:
        self.program = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def device_info(self, peak: int) -> Dict:
        if self.device.type != "cuda":
            return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(self.device),
                "count": 1, "memory_peak_bytes": peak}
