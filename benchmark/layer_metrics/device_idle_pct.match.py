"""The traced window's share in which no operation ran on the card
(the profiler's device intervals, merged), in percent."""

from benchmark import readers


def read(record):
    return readers.idle_pct(record)
