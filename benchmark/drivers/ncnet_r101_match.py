"""NCNet's InLoc model: ``ImMatchNet`` (ResNet101 to layer3,
relocalisation) forward and ``corr_to_matches`` relocated to the
pre-pool grid, on seeded pairs, the matches copied to the host each
call."""

from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

import torch

from benchmark import flops_r101, inputs
from benchmark.drivers.base import BaseDriver
from benchmark.reference import nets
from benchmark.reference import ncnet_r101 as ref
from benchmark.reference import ncnet_r101_judge

OUTPUT_KEYS = ("grid", "scores", "mutual")


class Driver(BaseDriver):
    def setup(self) -> None:
        from patch2pix_tpu_torch.models.immatch_net import ImMatchNet
        from patch2pix_tpu_torch.ops.match_extract import corr_to_matches

        c, t = self.config, self.traffic
        self.weights = inputs.make_weights(ref.ncnet_r101_shapes(c), self.seed, self.device)
        self.program = ImMatchNet(
            c["feature_extraction_cnn"], last_layer=c["last_layer"],
            ncons_kernel_sizes=tuple(c["ncn_kernel_sizes"]),
            ncons_channels=tuple(c["ncn_channels"]), normalize_features=c["normalize_features"],
            relocalization_k_size=c["relocalization_k_size"],
            dtype=getattr(torch, c["dtype"]), device=self.device)
        self.program.load_state_dict(self.weights)
        self.extract = corr_to_matches
        pool1, pool2, _ = inputs.traffic_pairs(self.seed, t, self.device)
        b = t["batch"]
        self.batches = [(pool1[j:j + b], pool2[j:j + b])
                        for j in range(0, t["pool_pairs"] - b + 1, b)]
        self.warm_up()

    def call(self, i: int) -> Tuple[int, Dict]:
        im1, im2 = self.batches[i % len(self.batches)]
        with torch.inference_mode():
            corr, delta = self.program(im1, im2)
            grid, scores, mutual = self.extract(corr, delta,
                                                ksize=self.config["relocalization_k_size"])
        return im1.shape[0], {k: v.cpu().numpy()
                              for k, v in zip(OUTPUT_KEYS, (grid, scores, mutual))}

    def counters(self) -> Dict:
        t = self.traffic
        b, h, w = t["batch"], t["height"], t["width"]
        k = self.config["relocalization_k_size"]
        _, fh, fw = flops_r101.resnet101_layer3_flops(h, w)
        return {"flops_per_call": flops_r101.ncnet_r101_match_flops(self.config, b, h, w),
                "ncn_volume": [b, fh // k, fw // k, fh // k, fw // k]}

    def stages(self) -> Dict[str, List]:
        """The NCNet driver's stages, and two inside ``coarse``: ``reloc``
        (the correlation and ``maxpool4d``, as ``ImMatchNet`` calls them)
        and ``ncn_taps`` (every call of the NCN's per-tap layer)."""
        immatch = importlib.import_module("patch2pix_tpu_torch.models.immatch_net")
        conv4d = importlib.import_module("patch2pix_tpu_torch.ops.conv4d")
        return {"backbone": [(self.program, "features")],
                "coarse": [(self.program, "_match"), (self, "extract")],
                "reloc": [(immatch, "feat_correlation"), (immatch, "maxpool4d")],
                "ncn_taps": [(conv4d, "conv4d_xla_taps")]}

    def judge(self, i: int, out: Dict) -> Dict[str, float]:
        im1, im2 = self.batches[i % len(self.batches)]
        return ncnet_r101_judge.judge(self.weights, self.config, self.options, im1, im2, out)

    def control(self, i: int, precision: str = "fp8") -> Dict:
        """The reference computed in ``precision`` (float8: the control;
        ``ncn_fp8``: float32 with the NCN alone in float8) in the
        program's place, on call i's inputs, in the program's layout."""
        im1, im2 = self.batches[i % len(self.batches)]
        prec, ncn_prec = nets.Precision(precision.replace("ncn_", "")), None
        if precision.startswith("ncn_"):
            prec, ncn_prec = nets.F32, prec
        with torch.no_grad(), nets.strict_float32():
            out = ref.predict(self.weights, self.config, im1, im2, prec, ncn_prec)
        return {k: out[k].cpu().numpy() for k in OUTPUT_KEYS}
