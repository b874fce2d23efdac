"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, which is loaded
with ``ctypes``. Libraries are built at first use into ``build/kernels``
beside the package (listed in ``.gitignore``), named by a hash of the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source is rebuilt and an unchanged one is reused. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

from patch2pix_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("tap_sum", "corr_pool", "patch_expand", "conv4d", "conv4d_mid", "fine_head")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# ctypes type codes of the C signatures: p = pointer / stream, i = int,
# l = long long
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    # the shared headers are part of every source
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Tuple[float, Dict[str, str]]:
    """Compile every missing library, one ``nvcc`` per source, all
    started together. Returns (wall seconds, {name: ptxas report})."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [name for name in names if not library_path(name).exists()]
    reports = {}
    failed = []
    if todo:
        with profiling.span("setup.nvcc"):
            procs = {}
            for name in todo:
                target = library_path(name)
                tmp = target.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
                procs[name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ), tmp, target)
            for name, (proc, tmp, target) in procs.items():
                out, _ = proc.communicate()
                reports[name] = out
                if proc.returncode != 0:
                    failed.append(f"{name}:\n{out}")
                    continue
                os.replace(tmp, target)
        profiling.count("kernels.nvcc_runs", len(todo))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0, reports


def library(name: str, signatures: Dict[str, str]) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built if needed), with
    ``argtypes``/``restype`` set from ``signatures``:
    {C function: type codes}. Every C function returns a CUDA error
    code as int."""
    lib = _loaded.get(name)
    if lib is None:
        with profiling.span("setup.kernel_load." + name):
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, codes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = [_CTYPES[c] for c in codes]
                f.restype = ctypes.c_int
            _loaded[name] = lib
    return lib


def check_launch(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error {rc}")


def refuse_grad(what: str, *tensors) -> None:
    """Raise where autograd would need the gradient of a kernel that has
    no backward (B5, B7: the JAX package gives them no VJP either): the
    kernel writes into fresh storage through ctypes, so its output
    carries no ``grad_fn`` (on the CPU the plain version is
    differentiable)."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the CUDA kernel has no backward pass; call it "
                           f"under torch.no_grad() or on inputs that do not require grad")


def current_stream(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
