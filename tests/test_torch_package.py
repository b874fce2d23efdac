"""Package-level properties of the port (``patch2pix_tpu_torch``).

  * no module of the port, and not ``chip_smoke.py``, imports JAX, its
    libraries or the JAX package (an AST scan);
  * the port's parameter keys are the reference's (the 276-key shape
    map stored in the golden fixtures), and ``state_dict_from_jax``
    inverts ``convert_patch2pix_state_dict`` exactly;
  * config-derived fields and device resolution;
  * each kernel module's ctypes signatures name, for every C function
    it binds, one type code per parameter of that function's prototype
    in ``csrc/`` (a pointer ``p``, an int ``i``, a 64-bit int ``l``):
    ctypes passes a missing or extra code silently until the card
    calls it.
"""

import ast
import importlib
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from patch2pix_tpu.utils.torch_import import convert_patch2pix_state_dict
from patch2pix_tpu_torch.config import ModelConfig, resolve_device
from patch2pix_tpu_torch.models.patch2pix import Patch2Pix
from patch2pix_tpu_torch.utils.jax_import import load_jax_variables, state_dict_from_jax
from tests.ref_loader import seeded_state_dict
from tests.torch_threads import torch_threads_per_worker  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "patch2pix_tpu"}


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = sorted((ROOT / "patch2pix_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & FORBIDDEN)
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


def _fixture_shapes():
    path = ROOT / "tests" / "fixtures" / "pipeline_golden_cs.npz"
    meta = json.loads(str(np.load(path, allow_pickle=True)["meta"]))
    return {k: tuple(s) for k, s in meta["shapes"].items()}


def test_port_keys_are_the_reference_keys():
    shapes = _fixture_shapes()
    assert len(shapes) == 276
    for change_stride in (False, True):
        model = Patch2Pix(ModelConfig(change_stride=change_stride).resolved(), device="cpu")
        got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert got == shapes


def test_state_dict_from_jax_round_trip():
    sd = seeded_state_dict(_fixture_shapes(), seed=3)
    params, stats = convert_patch2pix_state_dict(sd)
    back = state_dict_from_jax({"params": params, "batch_stats": stats})
    # the JAX tree holds neither layer4 (never run) nor the BN counters
    want = {k: v for k, v in sd.items()
            if ".layer4." not in k and not k.endswith("num_batches_tracked")}
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)

    model = Patch2Pix(ModelConfig(change_stride=True).resolved(), device="cpu")
    load_jax_variables(model, {"params": params, "batch_stats": stats})
    got = model.state_dict()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    del params["ncn"]
    with pytest.raises(KeyError):
        load_jax_variables(model, {"params": params, "batch_stats": stats})


def test_config_derived_fields():
    cfg = ModelConfig(change_stride=True, dtype="bfloat16").resolved()
    assert cfg.compute_dtype == torch.bfloat16 and cfg.upsample == 8
    assert cfg.feats_downsample == (1, 2, 2, 2, 1)
    assert cfg.regressor.feat_dim == 259
    assert ModelConfig().compute_dtype == torch.float32 and ModelConfig().upsample == 16


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()


def _c_prototypes():
    """{C function: type codes} of every ``extern "C"`` function in
    ``csrc/*.cu``."""
    out = {}
    for src in sorted((ROOT / "patch2pix_tpu_torch" / "csrc").glob("*.cu")):
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            params = [a for a in m.group(2).split(",") if a.strip()]
            out[m.group(1)] = "".join(
                "p" if "*" in a else "l" if "long long" in a or "int64_t" in a else "i"
                for a in params)
    return out


SIGNATURE_MODULES = ("tap_sum", "corr_pool", "patch_expand", "conv4d_small", "fine_stage")


@pytest.mark.parametrize("module", SIGNATURE_MODULES)
def test_ctypes_signatures_match_the_c_prototypes(module):
    protos = _c_prototypes()
    sigs = importlib.import_module(f"patch2pix_tpu_torch.ops.{module}")._SIGNATURES
    assert sigs
    for fn, codes in sigs.items():
        assert protos.get(fn) == codes, fn


def test_every_c_entry_point_is_bound_once():
    """Every ``extern "C"`` function in ``csrc/`` (a new entry point
    included) is named by exactly one module's ``_SIGNATURES``, so the
    check above covers it."""
    bound = [fn for m in SIGNATURE_MODULES
             for fn in importlib.import_module(f"patch2pix_tpu_torch.ops.{m}")._SIGNATURES]
    assert sorted(bound) == sorted(_c_prototypes())
