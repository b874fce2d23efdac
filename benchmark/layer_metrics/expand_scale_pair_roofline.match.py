"""B3 ``expand_scale_pair``: its least time over the traced calls (the mid
stage at the coarse matches, the fine stage at the mid matches; every
capped row, valid or not: ``kernels.b3_bound_s`` from the padded
corners) over its device time in the trace, in percent."""

from benchmark import kernels, readers


def read(record):
    sec, n = readers.kernel_time(record, kernels.B3_NAME)
    outs = [o for o in record.get("traced_outputs", []) if o is not None]
    if n == 0 or not outs:
        return None
    t = record["traffic"]
    psize = record["config"]["regressor"]["psize"][1]
    bound = 0.0
    for o in outs:
        for key in ("coarse", "mid"):
            pts = o[key]
            y1, x1 = kernels.padded_corners(pts[..., 0:2], psize, t["height"], t["width"])
            y2, x2 = kernels.padded_corners(pts[..., 2:4], psize, t["height"], t["width"])
            bound += kernels.b3_bound_s([y1, x1, y2, x2], psize)
    if n != 2 * len(outs):
        return None
    return 100.0 * bound / sec
