"""Device ms per call of the relocalising correlation: CUDA events around
the pre-pool correlation and ``maxpool4d`` with its offset volumes (the
driver's ``reloc`` stage), over the traced calls."""


def read(record):
    return record.get("stages_ms", {}).get("reloc")
