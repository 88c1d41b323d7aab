"""Fused NDiv loss through hand-written CUDA kernels; counterpart of ``ndivplanning_tpu/ops/ndiv_pallas.py``.

Three kernels in ``csrc/ndiv.cu``, built with ``nvcc`` for ``sm_90a`` at
first use and bound through ``ctypes``:

- ``ndiv_joint``: the hinge sum plus dL/dz and dL/dx at unit cotangent, in
  one pass (replaces ``_joint_kernel_block``).  Under differentiation the
  backward is then a scalar multiply.
- ``ndiv_fwd``: the hinge sum alone (replaces ``_fwd_kernel_block`` and the
  packed ``_fwd_kernel``).
- ``ndiv_bwd``: dL/dz and dL/dx at an upstream cotangent ``g``, recomputing
  the forward (replaces ``_bwd_kernel_block`` and the packed ``_bwd_kernel``).

The kernel is chosen by shape alone (:func:`serving_kernel` says which
serves a call): fwd and bwd at 2 <= k <= 64 and joint at 2 <= k <= 32, where
the rows fit in shared memory, run the warp kernel (a team of warps per
condition, one launch); the rest run the tile kernel.  Their grads are
bitwise equal, and the warp kernel's loss total depends on the shape alone,
so the layouts it serves give bitwise equal totals and grads.

Each takes the JAX package's ``variant``: "block", "group" or "packed", the
TPU's three layouts of the same function.  The TPU packs conditions to fill
its matrix unit's lanes, which this card does not need: the variant only
names the route in ``LAUNCHES``.
:func:`ndiv_loss_fused` routes as ``_vjp_fwd`` does: under differentiation
block and group run the joint kernel when ``JOINT`` is set, and otherwise
(and always for packed) the forward kernel, whose backward is ``ndiv_bwd``.
``VARIANT`` and ``JOINT`` are read from ``NDIV_VARIANT`` and ``NDIV_JOINT``
at import, as the JAX module reads them.  ``_launch(..., impl="tile")``
runs the tile kernel at any shape, as the reference that the card tests,
``chip_smoke.py`` and ``ndiv_kernel_ab.py`` hold the warp kernel against;
nothing else selects it.

The kernels compute in float32 (accumulating in float64).  As the JAX
kernels do, the wrappers upcast bf16 and f16 inputs to float32 first and
cast the grads back to each input's dtype; under differentiation the unit
grads are cast back, then scaled by the cotangent in float32 and cast
again (``_vjp_bwd``).  The loss is float32.

Each wrapper launches its kernel for CUDA tensors (or raises) and uses its
plain version (:func:`ndiv_joint_plain`, :func:`ndiv_fwd_plain`,
:func:`ndiv_bwd_plain`) only for CPU tensors.  ``LAUNCHES`` counts kernel
launches by kernel and variant ("joint", "fwd", "bwd" for block,
"joint_group", "fwd_packed" and so on for the others).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time

import torch

from ndivplanning_tpu_torch.ops.ndiv import (
    _row_normalize,
    check_shapes,
    ndiv_loss_reference,
)
from ndivplanning_tpu_torch.ops.pairwise import pairwise_l2
from ndivplanning_tpu_torch.utils.compile_guard import record_compile

_MAX_KP = 1024
_SUBLANE = 8
_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                    "ndiv.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VARIANTS = ("block", "group", "packed")
_MODES = {"fwd": 0, "joint": 1, "bwd": 2}
# "auto": the dispatch by shape; "tile": the tile kernel at any shape.
_IMPLS = {"auto": 0, "tile": 1}

VARIANT = os.environ.get("NDIV_VARIANT", "block")
JOINT = os.environ.get("NDIV_JOINT", "1") != "0"


def launch_key(kernel: str, variant: str) -> str:
    """``LAUNCHES`` key of a kernel under a variant: "joint", "fwd_group"..."""
    return kernel if variant == "block" else f"{kernel}_{variant}"


# Kernel launches since the last reset.  The JAX package has no joint
# kernel under "packed", so neither has the port.
LAUNCHES = {launch_key(kern, v): 0 for v in _VARIANTS
            for kern in ("joint", "fwd", "bwd")
            if (kern, v) != ("joint", "packed")}

_lib = None
# One zeroed ticket (an int32 the warp kernel counts its finished blocks
# in, and leaves at 0) per (device, stream): launches on one stream run in
# order, so they never share it at once.
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}
# The grid of a launch by device, mode and shape: the warp kernel's
# depends on the device's SMs.
_GRIDS: dict[tuple[int, ...], int] = {}


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def fused_available(k: int) -> bool:
    """The k the kernels take, as the JAX fused path: 2 <= k, round_up(k, 8) <= 1024."""
    return 2 <= k and _round_up(k, _SUBLANE) <= _MAX_KP


def check_variant(variant: str, kernel: str = "fwd") -> None:
    """Raise ``ValueError`` for a layout the JAX package does not have."""
    if variant not in _VARIANTS:
        raise ValueError(
            f"unknown NDiv kernel variant {variant!r}; "
            "choose from 'block', 'group', 'packed'")
    if (kernel, variant) == ("joint", "packed"):
        raise ValueError("the packed layout has no joint kernel (as in the "
                         "JAX package): use ndiv_fwd and ndiv_bwd")


# ----------------------------------------------------------- plain versions


def _distances(a: torch.Tensor):
    """Per-condition pairwise L2 of ``a [B, k, d]``: (D, rowsum, n)."""
    d = pairwise_l2(a)
    return d, torch.sum(d, dim=-1, keepdim=True), _row_normalize(d)


def _unit_grad(a, d, r, n, g_n, valid):
    """dL/da from dL/dn by the quotient rule through the row sums."""
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    c = torch.sum(g_n * n, dim=-1, keepdim=True)
    r_pos = r > 0.0
    g_d = torch.where(valid & r_pos,
                      (g_n - c) / torch.where(r_pos, r, torch.ones_like(r)),
                      zero)
    d_pos = d > 0.0
    w = torch.where(d_pos, (g_d + g_d.transpose(-1, -2))
                    / torch.where(d_pos, d, torch.ones_like(d)), zero)
    row_w = torch.sum(w, dim=-1, keepdim=True)
    return row_w * a - torch.matmul(w, a)


def _hinge_and_grads(z, x, alpha, s_on):
    """(hinge sum, dL/dz, dL/dx) with slack ``s_on`` (a 0-d tensor) on
    every pair whose hinge is active."""
    k = z.shape[1]
    valid = ~torch.eye(k, dtype=torch.bool, device=z.device)
    dz, rz, nz = _distances(z)
    dx, rx, nx = _distances(x)
    hinge = torch.clamp(alpha * nz - nx, min=0.0)
    s = torch.where((hinge > 0.0) & valid, s_on,
                    torch.zeros((), dtype=z.dtype, device=z.device))
    gz = _unit_grad(z, dz, rz, nz, alpha * s, valid)
    gx = _unit_grad(x, dx, rx, nx, -s, valid)
    return torch.sum(hinge), gz, gx


def _pairs(z: torch.Tensor) -> int:
    """M = B k (k-1), the ordered pairs the loss averages over."""
    b, k = z.shape[:2]
    return b * k * (k - 1)


def _inv_m(z: torch.Tensor) -> float:
    return 1.0 / _pairs(z)


def ndiv_fwd_plain(z: torch.Tensor, x: torch.Tensor,
                   alpha: float) -> torch.Tensor:
    """Hinge sum over ``z [B, k, dz]``, ``x [B, k, dx]`` (plain torch)."""
    return ndiv_loss_reference(z, x, alpha) * _pairs(z)


def ndiv_joint_plain(z: torch.Tensor, x: torch.Tensor, alpha: float):
    """(hinge sum, dL/dz, dL/dx) at unit cotangent, L = sum / (B k (k-1))."""
    return _hinge_and_grads(
        z, x, alpha, torch.full((), _inv_m(z), dtype=z.dtype, device=z.device))


def ndiv_bwd_plain(z: torch.Tensor, x: torch.Tensor, alpha: float,
                   g: torch.Tensor):
    """(dL/dz, dL/dx) at the upstream cotangent ``g`` (a 0-d tensor)."""
    _, gz, gx = _hinge_and_grads(z, x, alpha, g.to(z.dtype) * _inv_m(z))
    return gz, gx


# ------------------------------------------------------------------ build


def library_path() -> str:
    """Where :func:`build` puts the library of the current source and flags."""
    with open(_SRC, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(_BUILD_DIR, f"libndiv_{digest[:16]}.so")


def build() -> tuple[str, str]:
    """Compile ``csrc/ndiv.cu`` (once per source hash); returns (library path, nvcc log)."""
    path = library_path()
    if os.path.exists(path):
        return path, ""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS, "-o", tmp,
             _SRC], capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    record_compile("cuda_build", os.path.basename(path),
                   time.perf_counter() - t0)
    return path, proc.stdout + proc.stderr


def load():
    """The built kernel library, loaded once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()[0])
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ndiv_joint.argtypes = [p, p, i, i, i, i, f, f, i, p, i, p, p, p,
                                   p, p, p]
        lib.ndiv_fwd.argtypes = [p, p, i, i, i, i, f, i, p, i, p, p, p, p]
        lib.ndiv_bwd.argtypes = [p, p, p, i, i, i, i, f, f, i, i, p, p, p,
                                 p]
        for fn in (lib.ndiv_joint, lib.ndiv_fwd, lib.ndiv_bwd):
            fn.restype = i
        lib.ndiv_blocks.argtypes = [i, i, i, i, i, i]
        lib.ndiv_blocks.restype = i
        lib.ndiv_warp_serves.argtypes = [i, i, i, i]
        lib.ndiv_warp_serves.restype = i
        lib.ndiv_scratch_floats.argtypes = [i, i, i, i, i]
        lib.ndiv_scratch_floats.restype = ctypes.c_longlong
        lib.ndiv_error_string.argtypes = [i]
        lib.ndiv_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# ---------------------------------------------------------------- wrappers


def serving_kernel(kernel: str, k: int, dz: int, dx: int) -> str:
    """The kernel ``ndiv_<kernel>`` launches at this shape, in every
    layout: "warp" (2 <= k <= 64 for fwd and bwd, 2 <= k <= 32 for joint,
    rows that fit in shared memory) or "tile"."""
    warp = load().ndiv_warp_serves(_MODES[kernel], k, dz, dx)
    return "warp" if warp else "tile"


def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _TICKETS[key]


def _upcast(a: torch.Tensor) -> torch.Tensor:
    """bf16 and f16 inputs in float32, as the JAX kernels' ``_pack``
    casts them."""
    return a.float() if a.is_floating_point() and a.element_size() < 4 else a


def _on_cpu(z: torch.Tensor, x: torch.Tensor) -> bool:
    if z.device.type == "cpu" and x.device.type == "cpu":
        return True
    if not (z.is_cuda and x.is_cuda and z.device == x.device):
        raise ValueError(
            f"z and x must both lie on one CUDA device or on the CPU, got "
            f"{z.device} and {x.device}")
    return False


def _check_cuda(z: torch.Tensor, x: torch.Tensor) -> None:
    for name, t in (("z", z), ("x", x)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be [B, k, d], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    check_shapes(z, x)
    if not fused_available(z.shape[1]):
        raise ValueError(f"k={z.shape[1]} outside the kernel's range "
                         f"2 <= k, round_up(k, 8) <= {_MAX_KP}")


def _launch(kernel: str, variant: str, z: torch.Tensor, x: torch.Tensor,
            alpha: float, g: torch.Tensor | None = None,
            blocks: int | None = None, impl: str = "auto"):
    """Launch ``ndiv_<kernel>``; ``blocks`` overrides the warp kernel's
    grid (the results do not depend on it); ``impl="tile"`` runs the tile
    kernel whatever the shape (the reference for the warp kernel, never
    taken in its place)."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r}; choose from "
                         f"{sorted(_IMPLS)}")
    _check_cuda(z, x)
    lib = load()
    b, k, dz = z.shape
    dx = x.shape[2]
    mode, how = _MODES[kernel], _IMPLS[impl]
    f32 = dict(dtype=torch.float32, device=z.device)
    n_scratch = lib.ndiv_scratch_floats(mode, k, dz, dx, how)
    scratch = torch.empty(b * n_scratch, **f32) if n_scratch else None
    scratch_ptr = scratch.data_ptr() if scratch is not None else None
    if kernel != "fwd":
        gz = torch.empty_like(z)
        gx = torch.empty_like(x)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        key = (z.device.index, mode, b, k, dz, dx, how)
        if key not in _GRIDS:
            _GRIDS[key] = lib.ndiv_blocks(mode, b, k, dz, dx, how)
        grid = _GRIDS[key] if blocks is None else blocks
        if grid < 1:
            raise RuntimeError(f"ndiv_{kernel} ({variant}): no grid for "
                               f"{tuple(z.shape)}, {tuple(x.shape)}")
        if kernel == "bwd":
            err = lib.ndiv_bwd(z.data_ptr(), x.data_ptr(), g.data_ptr(), b, k,
                               dz, dx, float(alpha), _inv_m(z), how, grid,
                               gz.data_ptr(), gx.data_ptr(), scratch_ptr,
                               stream)
        else:
            total = torch.empty((), **f32)
            partial = torch.empty(b, **f32)  # one per condition
            ticket = _ticket(z.device, stream).data_ptr()
            if kernel == "joint":
                err = lib.ndiv_joint(z.data_ptr(), x.data_ptr(), b, k, dz, dx,
                                     float(alpha), _inv_m(z), how,
                                     partial.data_ptr(), grid,
                                     total.data_ptr(), ticket, gz.data_ptr(),
                                     gx.data_ptr(), scratch_ptr, stream)
            else:
                err = lib.ndiv_fwd(z.data_ptr(), x.data_ptr(), b, k, dz, dx,
                                   float(alpha), how, partial.data_ptr(), grid,
                                   total.data_ptr(), ticket, scratch_ptr,
                                   stream)
    if err != 0:
        raise RuntimeError(f"ndiv_{kernel} ({variant}) launch failed: "
                           f"{lib.ndiv_error_string(err).decode()}")
    LAUNCHES[launch_key(kernel, variant)] += 1
    if kernel == "joint":
        return total, gz, gx
    return total if kernel == "fwd" else (gz, gx)


def ndiv_joint(z: torch.Tensor, x: torch.Tensor, alpha: float,
               variant: str = "block"):
    """(hinge sum, dL/dz, dL/dx at unit cotangent) for ``[B, k, d]`` inputs."""
    check_variant(variant, "joint")
    z32, x32 = _upcast(z), _upcast(x)
    if _on_cpu(z, x):
        total, gz, gx = ndiv_joint_plain(z32, x32, alpha)
    else:
        total, gz, gx = _launch("joint", variant, z32, x32, alpha)
    return total, gz.to(z.dtype), gx.to(x.dtype)


def ndiv_fwd(z: torch.Tensor, x: torch.Tensor, alpha: float,
             variant: str = "block") -> torch.Tensor:
    """Hinge sum for ``[B, k, d]`` inputs."""
    check_variant(variant)
    z32, x32 = _upcast(z), _upcast(x)
    if _on_cpu(z, x):
        return ndiv_fwd_plain(z32, x32, alpha)
    return _launch("fwd", variant, z32, x32, alpha)


def ndiv_bwd(z: torch.Tensor, x: torch.Tensor, alpha: float, g: torch.Tensor,
             variant: str = "block"):
    """(dL/dz, dL/dx) at the cotangent ``g`` (a 0-d tensor on z's device)
    of L = hinge sum / (B k (k-1)), for ``[B, k, d]`` inputs."""
    check_variant(variant)
    z32, x32 = _upcast(z), _upcast(x)
    if _on_cpu(z, x):
        gz, gx = ndiv_bwd_plain(z32, x32, alpha, g)
    else:
        if g.numel() != 1 or g.device != z.device:
            raise ValueError(f"g must be one value on {z.device}, got "
                             f"{tuple(g.shape)} on {g.device}")
        gz, gx = _launch("bwd", variant, z32, x32, alpha,
                         g.to(torch.float32).contiguous())
    return gz.to(z.dtype), gx.to(x.dtype)


class _NDivFused(torch.autograd.Function):
    """Loss = hinge sum / M under differentiation: the joint kernel's unit
    grads are the saved residuals and the backward scales them."""

    @staticmethod
    def forward(ctx, z, x, alpha, variant):
        total, gz, gx = ndiv_joint(z, x, alpha, variant)
        ctx.save_for_backward(gz, gx)
        return total / _pairs(z)

    @staticmethod
    def backward(ctx, g):
        def scale(unit):
            # As _vjp_bwd: scaled in float32 (or wider), cast back.
            wide = _upcast(unit)
            return (wide * g.to(wide.dtype)).to(unit.dtype)

        gz, gx = ctx.saved_tensors
        return (scale(gz) if ctx.needs_input_grad[0] else None,
                scale(gx) if ctx.needs_input_grad[1] else None, None, None)


class _NDivRecompute(torch.autograd.Function):
    """Loss = hinge sum / M from the forward kernel, with (z, x) as the
    residuals; the backward kernel recomputes the rest at the cotangent."""

    @staticmethod
    def forward(ctx, z, x, alpha, variant):
        ctx.save_for_backward(z, x)
        ctx.alpha, ctx.variant = alpha, variant
        return ndiv_fwd(z, x, alpha, variant) / _pairs(z)

    @staticmethod
    def backward(ctx, g):
        z, x = ctx.saved_tensors
        gz, gx = ndiv_bwd(z, x, ctx.alpha, g, ctx.variant)
        return (gz if ctx.needs_input_grad[0] else None,
                gx if ctx.needs_input_grad[1] else None, None, None)


def ndiv_loss_fused(z: torch.Tensor, x: torch.Tensor, alpha: float = 0.8,
                    variant: str | None = None) -> torch.Tensor:
    """NDiv loss over ``z [..., k, dz]``, ``x [..., k, dx]`` through the kernels.

    ``variant`` ("block", "group" or "packed") picks the layout, ``VARIANT``
    when None.  For k outside the kernels' range the plain reference
    computes the loss, as the JAX fused path does.
    """
    check_shapes(z, x)
    v = VARIANT if variant is None else variant
    check_variant(v)
    k = z.shape[-2]
    if not fused_available(k):
        return ndiv_loss_reference(z, x, alpha)
    z3 = z.reshape(-1, k, z.shape[-1])
    x3 = x.reshape(-1, k, x.shape[-1])
    # ctx.needs_input_grad stays set under torch.no_grad(), so whether a
    # gradient is wanted is decided here: the forward kernel serves a loss
    # that nothing differentiates.
    if torch.is_grad_enabled() and (z.requires_grad or x.requires_grad):
        if JOINT and v in ("block", "group"):
            return _NDivFused.apply(z3, x3, float(alpha), v)
        return _NDivRecompute.apply(z3, x3, float(alpha), v)
    return ndiv_fwd(z3, x3, alpha, v) / _pairs(z3)
