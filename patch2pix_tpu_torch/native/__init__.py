"""Host-side C++ components of the port, loaded with ``ctypes``.

``tracks.cpp`` (the union-find track builder, a copy of the JAX
package's) is compiled with ``g++`` at first use into ``build/native``
beside the package (listed in ``.gitignore``), under a name that hashes
the source and the flags, so an edited source is rebuilt and an
unchanged one reused. Nothing here runs at import time. A library that
cannot be built or loaded raises: there is no silent fallback, the
Python track builder runs only when the caller asks for it
(``build_tracks(use_native=False)``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "tracks.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

# ctypes type codes of the C signatures: p = pointer, i = int32,
# l = int64, d = double
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int32, "l": ctypes.c_int64,
           "d": ctypes.c_double}
_SIGNATURES = {"p2p_build_tracks": "pppldippp", "p2p_free": "p"}
_RESTYPES = {"p2p_build_tracks": ctypes.c_int64, "p2p_free": None}

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libp2p_tracks_{digest[:16]}.so"


def build() -> Path:
    """Compile ``tracks.cpp`` with ``CXX`` into ``BUILD_DIR`` unless its
    library exists; returns its path. Raises ``RuntimeError`` when the
    compiler is missing or fails."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot build the native track builder: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{CXX} failed for {SRC.name}:\n{proc.stderr}")
    os.replace(tmp, target)
    return target


def library() -> ctypes.CDLL:
    """The loaded track-builder library (built if needed), with
    ``argtypes``/``restype`` set from ``_SIGNATURES``/``_RESTYPES``."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for fn, codes in _SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = [_CTYPES[c] for c in codes]
            f.restype = _RESTYPES[fn]
        _lib = lib
    return _lib


def native_available() -> bool:
    """Whether :func:`library` builds and loads here. It only reports:
    :func:`build_tracks_native` still raises where the library cannot
    load."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def build_tracks_native(
    pair_matches: Dict[Tuple[int, int], np.ndarray],
    cell: float = 4.0,
    min_track_len: int = 2,
) -> List[Dict[int, np.ndarray]]:
    """C++ union-find track builder. Output contract matches
    :func:`patch2pix_tpu_torch.sfm.tracks.build_tracks`; raises where the
    library cannot be built or loaded."""
    lib = library()
    ims1, ims2, rows = [], [], []
    for (i, j), m in pair_matches.items():
        m = np.asarray(m, np.float64)
        if m.size == 0:
            continue
        ims1.append(np.full(len(m), i, np.int32))
        ims2.append(np.full(len(m), j, np.int32))
        rows.append(m)
    if not rows:
        return []
    im1 = np.ascontiguousarray(np.concatenate(ims1))
    im2 = np.ascontiguousarray(np.concatenate(ims2))
    m = np.ascontiguousarray(np.concatenate(rows))

    t_ptr = ctypes.POINTER(ctypes.c_int64)()
    im_ptr = ctypes.POINTER(ctypes.c_int32)()
    xy_ptr = ctypes.POINTER(ctypes.c_double)()
    n = lib.p2p_build_tracks(
        im1.ctypes.data, im2.ctypes.data, m.ctypes.data, len(m), float(cell),
        int(min_track_len), ctypes.addressof(t_ptr), ctypes.addressof(im_ptr),
        ctypes.addressof(xy_ptr))
    if n < 0:
        raise MemoryError("p2p_build_tracks allocation failed")
    try:
        if n:
            tids = np.ctypeslib.as_array(t_ptr, shape=(n,)).copy()
            ims = np.ctypeslib.as_array(im_ptr, shape=(n,)).copy()
            xys = np.ctypeslib.as_array(xy_ptr, shape=(2 * n,)).copy().reshape(-1, 2)
    finally:
        for ptr in (t_ptr, im_ptr, xy_ptr):
            lib.p2p_free(ctypes.cast(ptr, ctypes.c_void_p))
    if not n:
        return []
    tracks: List[Dict[int, np.ndarray]] = [dict() for _ in range(int(tids.max()) + 1)]
    for t, im, xy in zip(tids, ims, xys):
        tracks[t][int(im)] = xy
    return tracks
