"""Device ms per call of the coarse stage: CUDA events around the
instance's stage methods (the driver's ``stages``), over the traced calls."""


def read(record):
    return record.get("stages_ms", {}).get("coarse")
