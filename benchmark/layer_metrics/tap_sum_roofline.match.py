"""B1 ``tap_sum``: its least time from shapes (``kernels.b1_bound_s`` at
the NCN's volume (bs, h1, w1, h2, w2) as the driver records it, one
launch per symmetric branch) over its device time
in the trace, in percent."""

from benchmark import kernels, readers


def read(record):
    sec, n = readers.kernel_time(record, kernels.B1_NAME)
    if n == 0 or "ncn_volume" not in record:
        return None
    return 100.0 * n * kernels.b1_bound_s(*record["ncn_volume"]) / sec
