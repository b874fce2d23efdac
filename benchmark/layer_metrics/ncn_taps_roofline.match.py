"""The NCN's per-tap layers: their least time from shapes
(``bounds_r101.ncn_taps_bound_s`` at the NCN's volume as the driver
records it, both directions) over their device ms a call
(``ncn_taps_ms.match``), in percent."""

from benchmark import bounds_r101


def read(record):
    ms = record.get("stages_ms", {}).get("ncn_taps")
    cfg = record.get("config", {})
    if not ms or "ncn_volume" not in record or "ncn_channels" not in cfg:
        return None
    bound = bounds_r101.ncn_taps_bound_s(record["ncn_volume"], cfg["ncn_kernel_sizes"],
                                         cfg["ncn_channels"], cfg.get("ncn_symmetric", True))
    if bound <= 0:
        return None
    return 100.0 * bound / (ms * 1e-3)
