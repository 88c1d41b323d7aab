"""Import hygiene and device defaults of the torch port."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "ndivplanning_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "oracle",
             "ndivplanning_tpu")


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods)


_PROBE = """
import importlib, json, sys
before = set(sys.modules)
mods = json.loads(sys.argv[1])
for m in mods:
    importlib.import_module(m)
new = sorted(set(sys.modules) - before)
print(json.dumps(new))
"""


def _new_modules(mods):
    out = subprocess.run([sys.executable, "-c", _PROBE, json.dumps(mods)],
                         cwd=ROOT, capture_output=True, text=True, check=True,
                         timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _forbidden(names):
    return [n for n in names if n.split(".")[0] in FORBIDDEN]


def test_every_port_module_imports_without_jax_or_the_jax_package():
    mods = _port_modules()
    assert "ndivplanning_tpu_torch.ops.ndiv_cuda" in mods
    assert {"ndivplanning_tpu_torch.parallel",
            "ndivplanning_tpu_torch.parallel.mesh",
            "ndivplanning_tpu_torch.parallel.sharded_step",
            "ndivplanning_tpu_torch.parallel.spawn",
            "ndivplanning_tpu_torch.cli",
            "ndivplanning_tpu_torch.__main__",
            "ndivplanning_tpu_torch.planning.server",
            "ndivplanning_tpu_torch.planning.client",
            "ndivplanning_tpu_torch.planning.mpc",
            "ndivplanning_tpu_torch.planning.cem",
            "ndivplanning_tpu_torch.utils.checkpoint",
            "ndivplanning_tpu_torch.utils.metrics",
            "ndivplanning_tpu_torch.train.evaluate",
            "ndivplanning_tpu_torch.train.loop"} <= set(mods)
    assert len(mods) >= 20
    new = _new_modules(mods)
    assert "torch" in new or "torch" in sys.modules
    assert _forbidden(new) == []


def test_the_checkpoint_converter_is_outside_the_package():
    """convert_jax_checkpoint.py imports both packages, so it sits at the
    root and nothing in the port imports it."""
    assert os.path.exists(os.path.join(ROOT, "convert_jax_checkpoint.py"))
    assert not any(f == "convert_jax_checkpoint.py"
                   for _, _, files in os.walk(PKG) for f in files)
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f), encoding="utf-8") as fh:
                    assert "convert_jax_checkpoint" not in fh.read(), f


def test_chip_smoke_imports_nothing_of_jax():
    with open(os.path.join(ROOT, "chip_smoke.py"), encoding="utf-8") as f:
        src = f.read()
    for name in FORBIDDEN:
        assert f"import {name}" not in src and f"from {name} " not in src
        assert f"from {name}." not in src


def test_create_train_state_defaults_to_cuda(monkeypatch):
    from ndivplanning_tpu_torch.train.state import create_train_state
    from ndivplanning_tpu_torch.utils.config import get_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_train_state(get_config("goalcond"))
    state = create_train_state(get_config("goalcond"), device="cpu")
    assert next(state.g.parameters()).device.type == "cpu"


def test_the_card_runs_in_full_float32_and_deterministically(monkeypatch):
    """TF32 off (the JAX paths compute at Precision.HIGHEST), bf16 products
    summed in float32, and cuDNN's deterministic algorithms (the JAX step
    is bitwise repeatable)."""
    from ndivplanning_tpu_torch.utils.device import resolve_device

    for mod, name, value in ((torch.backends.cuda.matmul, "allow_tf32", True),
                             (torch.backends.cuda.matmul,
                              "allow_bf16_reduced_precision_reduction", True),
                             (torch.backends.cudnn, "allow_tf32", True),
                             (torch.backends.cudnn, "deterministic", False),
                             (torch.backends.cudnn, "benchmark", True)):
        monkeypatch.setattr(mod, name, value)
    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cudnn.benchmark  # the CPU leaves them alone
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None).type == "cuda"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.benchmark


_ATOMIC = re.compile(r"\batomicAdd(?:_block|_system)?\s*\(([^,]+),([^;]+)\)")
_FLOAT_TYPES = re.compile(r"\b(float|double|half|__half|__nv_bfloat16|"
                          r"__half2|float2|float4|double2)\b")


def _declared_types(src, name):
    """The pointee types ``name`` is declared with in ``src``."""
    decl = re.compile(r"([A-Za-z_][\w ]*?)\s*\*\s*(?:__restrict__\s+)?"
                      + re.escape(name) + r"\b")
    return [m.group(1).strip() for m in decl.finditer(src)]


def test_ndiv_kernels_use_no_float_atomics():
    """Bitwise-repeatable losses: no atomic add takes a float or double
    operand in csrc/ndiv.cu; the warp kernel's integer ticket is the only
    atomic."""
    with open(os.path.join(PKG, "csrc", "ndiv.cu"), encoding="utf-8") as f:
        src = re.sub(r"//[^\n]*", "", f.read())
    calls = _ATOMIC.findall(src)
    assert calls, "expected the integer ticket's atomicAdd"
    for target, value in calls:
        assert not _FLOAT_TYPES.search(target + value), (target, value)
        float_literal = r"\d\.\d*|\d[eE][-+]?\d|\d+\.?f\b"
        assert not re.search(float_literal, value), value
        name = re.findall(r"[A-Za-z_]\w*", target)[-1]
        types = _declared_types(src, name)
        assert types, f"no declaration of {name}"
        for t in types:
            assert not _FLOAT_TYPES.search(t), f"{name} is declared {t}*"


def test_the_tile_reference_is_reached_only_on_purpose():
    """``_launch(..., impl="tile")`` runs the tile kernel where the warp
    kernel would: only the card tests, chip_smoke.py and ndiv_kernel_ab.py
    ask for it.  No module of the port names it outside its definition in
    ops/ndiv_cuda.py, and no environment variable selects it there (the
    module reads NDIV_VARIANT and NDIV_JOINT, nothing else)."""
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py") and f != "ndiv_cuda.py":
                with open(os.path.join(dirpath, f), encoding="utf-8") as fh:
                    src = fh.read()
                assert "impl=\"tile\"" not in src, f
                assert "_IMPLS" not in src, f
    with open(os.path.join(PKG, "ops", "ndiv_cuda.py"),
              encoding="utf-8") as f:
        src = f.read()
    assert set(re.findall(r"os\.environ\.get\(\"(\w+)\"", src)) == {
        "NDIV_VARIANT", "NDIV_JOINT"}
    assert "os.getenv" not in src and "os.environ[" not in src
    from ndivplanning_tpu_torch.ops import ndiv_cuda

    assert ndiv_cuda._IMPLS == {"auto": 0, "tile": 1}
    z, x = torch.zeros((2, 8, 2)), torch.zeros((2, 8, 4))
    with pytest.raises(ValueError, match="unknown impl"):
        ndiv_cuda._launch("fwd", "block", z, x, 0.8, impl="warp")
