"""``Patch2Pix.predict_fine`` on batches of seeded pairs, matches copied
to the host as ``Matcher`` hands them over."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark import flops, inputs
from benchmark.drivers.base import BaseDriver
from benchmark.reference import matching, nets

OUTPUT_KEYS = ("coarse", "scores", "valid", "mid", "mid_probs", "fine", "fine_probs")


def port_model(cfg, device, panc: int = 1):
    """The program's ``Patch2Pix`` for a configuration file."""
    from patch2pix_tpu_torch.config import ModelConfig, RegressorConfig
    from patch2pix_tpu_torch.models.patch2pix import Patch2Pix

    r = cfg["regressor"]
    reg = RegressorConfig(feat_comb=r["feat_comb"], conv_kers=tuple(r["conv_kers"]),
                          conv_dims=tuple(r["conv_dims"]), conv_strs=tuple(r["conv_strs"]),
                          fc_dims=tuple(r["fc_dims"]), psize=tuple(r["psize"]),
                          pshift=r["pshift"], panc=panc, shared=r["shared"])
    mc = ModelConfig(backbone=cfg["backbone"], change_stride=cfg["change_stride"],
                     feat_idx=tuple(cfg["feat_idx"]), regressor=reg, dtype=cfg["dtype"])
    return Patch2Pix(mc.resolved(), device=device)


class Driver(BaseDriver):
    def setup(self) -> None:
        t = self.traffic
        self.weights = inputs.make_weights(nets.patch2pix_shapes(self.config), self.seed,
                                           self.device)
        self.program = port_model(self.config, self.device)
        self.program.load_state_dict(self.weights)
        pool1, pool2, _ = inputs.traffic_pairs(self.seed, t, self.device)
        b = t["batch"]
        self.batches = [(pool1[j:j + b], pool2[j:j + b])
                        for j in range(0, t["pool_pairs"] - b + 1, b)]
        self.warm_up()

    def call(self, i: int) -> Tuple[int, Dict]:
        o = self.options
        im1, im2 = self.batches[i % len(self.batches)]
        fine, mid, cm = self.program.predict_fine(
            im1, im2, ksize=self.config["ksize"], ncn_thres=o["ncn_thres"],
            mutual=o["mutual"], fine_cap=o["fine_cap"])
        tensors = (cm.coords, cm.scores, cm.valid, mid.coords, mid.scores, fine.coords,
                   fine.scores)
        return im1.shape[0], {k: v.cpu().numpy() for k, v in zip(OUTPUT_KEYS, tensors)}

    def counters(self) -> Dict:
        c, t = self.config, self.traffic
        b, h, w, k = t["batch"], t["height"], t["width"], c["ksize"]
        _, fh, fw = flops.resnet34_flops(h, w, c["change_stride"])
        return {"flops_per_call": flops.p2p_match_flops(c, b, h, w, self.options["fine_cap"]),
                "ncn_volume": [b, fh // k, fw // k, fh // k, fw // k],
                "corr_maps": [b, fh, fw, 256, k]}

    def stages(self) -> Dict[str, List]:
        m = self.program
        return {"backbone": [(m, "extract_pyramid_pair")],
                "coarse": [(m, "coarse_corr"), (m, "coarse_matches")],
                "fine": [(m, "fine_match")]}

    def judge(self, i: int, out: Dict) -> Dict[str, float]:
        im1, im2 = self.batches[i % len(self.batches)]
        return matching.p2p_judge(self.weights, self.config, self.options, im1, im2, out)

    def control(self, i: int, precision: str = "fp8") -> Dict:
        """The reference computed in ``precision`` (float8: the control)
        in the program's place, on call i's inputs, in the program's layout."""
        im1, im2 = self.batches[i % len(self.batches)]
        with torch.no_grad(), nets.strict_float32():
            out = matching.p2p_predict(self.weights, self.config, self.options, im1, im2,
                                       nets.Precision(precision))
        return {k: out[k].cpu().numpy() for k in OUTPUT_KEYS}
