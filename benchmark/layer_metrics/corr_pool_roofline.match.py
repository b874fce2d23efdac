"""B2 ``corr_pool`` (its bf16 instance): its least time from shapes
(``kernels.b2_bound_s`` on the maps (b, h, w, c, pool) as the
driver records them) over its device time in the
trace, in percent."""

from benchmark import kernels, readers


def read(record):
    sec, n = readers.kernel_time(record, kernels.B2_NAME)
    if n == 0 or "corr_maps" not in record:
        return None
    return 100.0 * n * kernels.b2_bound_s(*record["corr_maps"]) / sec
