"""The whole call's model operations (``benchmark.flops``) times the
traced run's calls made after its traced phases (no profiler, no stage
events), over those calls' time on the host clock, against the chip's
bf16 peak, in percent."""

from benchmark import readers


def read(record):
    return readers.mfu_pct(record)
