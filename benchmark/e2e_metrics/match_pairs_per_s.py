"""Pairs whose matches reached the host in the window, over the window:
from its start to the end of its last call."""

from benchmark import window


def read(record):
    t0, t1 = record["window"]
    return window.rate([c[2] for c in record["calls"]], t0, t1)
