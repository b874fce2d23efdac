"""Seconds from the process's start to the window's start: imports, the
CUDA context, kernel builds (a checkout's first run), seeded weights and
inputs, warm-up calls."""


def read(record):
    return record["setup_s"]
