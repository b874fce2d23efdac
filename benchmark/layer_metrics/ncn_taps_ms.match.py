"""Device ms per call of the NCN's per-tap layers, both symmetric
directions: CUDA events around every call of the program's
``conv4d_xla_taps`` (the driver's ``ncn_taps`` stage), over the traced
calls."""


def read(record):
    return record.get("stages_ms", {}).get("ncn_taps")
