"""Arithmetic that several per-layer metric readers share. What depends
on the model (its operations a call, the shapes its kernels run at) the
cell's driver puts in the record (``Driver.counters``)."""


def kernel_time(record, name):
    """(device seconds, launches) of the traced kernels whose name holds
    ``name``."""
    s = n = 0
    for k, (sec, cnt) in record.get("trace", {}).get("kernels", {}).items():
        if name in k:
            s += sec
            n += cnt
    return s, n


def mfu_pct(record):
    """The model's operations of the traced run's calls that ran with
    neither the profiler nor stage events, over their time on the host
    clock, against the bf16 peak."""
    from benchmark import peaks

    plain = record.get("plain")
    if "trace" not in record or not plain or plain["calls"] == 0:
        return None
    return 100.0 * record["flops_per_call"] * plain["calls"] / plain["seconds"] / peaks.BF16_FLOPS


def idle_pct(record):
    tr = record.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
