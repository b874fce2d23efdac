"""The SPMD dispatch gate of the op library.

Port of ``patch2pix_tpu.ops.dispatch``, the same names. The JAX
package's sharded paths trace under :func:`spmd_safe_dispatch`, which
switches two things there: Pallas off (the SPMD partitioner cannot
split a custom call) and the conv4d folds' outer-tap shifts from the
merged ``(B*h1*w1)`` axis to a per-pair ``(h1*w1)`` one (merged shifts
cross pair boundaries, which a data-sharded mesh lowers as halo
collectives).

Neither reason arises in the port: a rank runs its own whole pairs
eagerly, so its merged shifts never cross a rank, and the kernels stay
on. The gate is therefore a constant here: :func:`spmd_mode` reports
whether a block is inside it, and no op reads it. The port's sharded
paths run B1-B3 on every rank.
"""

from __future__ import annotations

from contextlib import contextmanager

_SPMD = False


def spmd_mode() -> bool:
    return _SPMD


@contextmanager
def spmd_safe_dispatch():
    global _SPMD
    prev = _SPMD
    _SPMD = True
    try:
        yield
    finally:
        _SPMD = prev


no_pallas = spmd_safe_dispatch  # the JAX package's alias
