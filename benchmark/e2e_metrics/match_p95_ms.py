"""The 95th percentile, over every call of the window, of the time from
a call's start to its matches on the host."""

from benchmark import window


def read(record):
    return window.percentile([(c[1] - c[0]) * 1e3 for c in record["calls"]], 95)
