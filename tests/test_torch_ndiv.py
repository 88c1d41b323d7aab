"""The torch port's NDiv ops against the JAX package: values AND gradients.

The JAX fused path runs its Pallas kernels in interpret mode on the CPU
(as tests/test_ndiv_pallas.py runs them); the port's wrappers run their
kernels' plain versions on CPU tensors.  Tolerances are those of the JAX
kernel-vs-reference tests for values, rtol 1e-5 / atol 1e-6, and rtol 1e-4
for grads (f32 sums taken in another order), with the grads' atol 1e-5 of
the largest |grad|: the grads are ~1/(B k (k-1)) in size, so a fixed atol
of 1e-6 would hide those of the larger shapes.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndivplanning_tpu.ops import ndiv_pallas
from ndivplanning_tpu.ops.ndiv import ndiv_loss_reference as jax_reference
from ndivplanning_tpu.ops.ndiv_pallas import ndiv_loss_fused as jax_fused
from ndivplanning_tpu.ops.pairwise import pairwise_l2 as jax_pairwise_l2
from ndivplanning_tpu.ops.pairwise import pairwise_sq_l2 as jax_pairwise_sq_l2
from ndivplanning_tpu_torch.ops import ndiv_cuda
from ndivplanning_tpu_torch.ops.ndiv import ndiv_loss, ndiv_loss_reference
from ndivplanning_tpu_torch.ops.pairwise import pairwise_l2, pairwise_sq_l2

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)  # pairwise grads: sums of unit vectors


def _assert_grads_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))


# The shapes of tests/test_ndiv_pallas.py: k padding (k=5), single-block
# tiles (k=256), batch padding (b=3).
SHAPES = [(1, 8, 2, 64), (4, 8, 2, 64), (3, 5, 3, 7), (2, 32, 2, 64),
          (1, 256, 4, 8)]


def _case(seed, b, k, dz, dx):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, k, dz)).astype(np.float32),
            rng.normal(size=(b, k, dx)).astype(np.float32))


def _jax_value_and_grads(fn, z, x):
    val, (gz, gx) = jax.value_and_grad(
        lambda zz, xx: fn(zz, xx, 0.8), argnums=(0, 1))(jnp.asarray(z),
                                                         jnp.asarray(x))
    return float(val), np.asarray(gz), np.asarray(gx)


@pytest.mark.parametrize("b,k,dz,dx", SHAPES)
def test_joint_plain_matches_jax_kernel_and_reference(b, k, dz, dx):
    z, x = _case(b + k, b, k, dz, dx)
    total, gz, gx = ndiv_cuda.ndiv_joint_plain(torch.from_numpy(z),
                                               torch.from_numpy(x), 0.8)
    loss = float(total) / (b * k * (k - 1))
    for fn in (jax_fused, jax_reference):
        want, want_gz, want_gx = _jax_value_and_grads(fn, z, x)
        np.testing.assert_allclose(loss, want, **VAL)
        _assert_grads_close(gz.numpy(), want_gz)
        _assert_grads_close(gx.numpy(), want_gx)


@pytest.mark.parametrize("b,k,dz,dx", SHAPES)
def test_fwd_plain_matches_jax_kernel_and_reference(b, k, dz, dx):
    z, x = _case(b + k, b, k, dz, dx)
    total = ndiv_cuda.ndiv_fwd_plain(torch.from_numpy(z), torch.from_numpy(x),
                                     0.8)
    loss = float(total) / (b * k * (k - 1))
    np.testing.assert_allclose(
        loss, float(jax_fused(jnp.asarray(z), jnp.asarray(x), 0.8)), **VAL)
    np.testing.assert_allclose(
        loss, float(jax_reference(jnp.asarray(z), jnp.asarray(x), 0.8)),
        **VAL)
    np.testing.assert_allclose(
        float(ndiv_loss_reference(torch.from_numpy(z), torch.from_numpy(x))),
        loss, **VAL)


@pytest.mark.parametrize("b,k,dz,dx", [(2, 8, 2, 16), (3, 5, 3, 7)])
def test_fused_function_grads_match_reference_autograd(b, k, dz, dx):
    z, x = _case(100 + b + k, b, k, dz, dx)
    grads = []
    for fn in (ndiv_cuda.ndiv_loss_fused, ndiv_loss_reference):
        zt = torch.from_numpy(z).requires_grad_()
        xt = torch.from_numpy(x).requires_grad_()
        loss = fn(zt, xt, 0.8)
        loss.backward()
        grads.append((loss.item(), zt.grad.numpy(), xt.grad.numpy()))
    np.testing.assert_allclose(grads[0][0], grads[1][0], **VAL)
    _assert_grads_close(grads[0][1], grads[1][1])
    _assert_grads_close(grads[0][2], grads[1][2])


def test_fused_function_scales_with_upstream_cotangent():
    z, x = _case(7, 2, 8, 2, 8)
    out = []
    for g in (1.0, 3.0):
        zt = torch.from_numpy(z).requires_grad_()
        xt = torch.from_numpy(x).requires_grad_()
        ndiv_cuda.ndiv_loss_fused(zt, xt, 0.8).backward(torch.tensor(g))
        out.append((zt.grad.numpy(), xt.grad.numpy()))
    np.testing.assert_allclose(out[1][0], 3.0 * out[0][0], rtol=1e-4,
                               atol=1e-8)
    np.testing.assert_allclose(out[1][1], 3.0 * out[0][1], rtol=1e-4,
                               atol=1e-8)


def test_fused_leading_dims_and_no_grad_path():
    """[..., k, d] inputs fold into [B, k, d]; without a gradient the
    forward-only path gives the same loss as the differentiated one."""
    z, x = _case(11, 6, 8, 2, 16)
    z4 = torch.from_numpy(z).reshape(2, 3, 8, 2)
    x4 = torch.from_numpy(x).reshape(2, 3, 8, 16)
    with torch.no_grad():
        plain = ndiv_cuda.ndiv_loss_fused(z4, x4, 0.8)
    zt = z4.clone().requires_grad_()
    diff = ndiv_cuda.ndiv_loss_fused(zt, x4, 0.8)
    diff.backward()
    assert zt.grad.shape == (2, 3, 8, 2)
    np.testing.assert_allclose(float(plain), diff.item(), **VAL)
    np.testing.assert_allclose(
        float(plain), float(jax_fused(jnp.asarray(z4.numpy()),
                                      jnp.asarray(x4.numpy()), 0.8)), **VAL)


def test_identical_samples_zero_loss_finite_grads():
    z = torch.ones((2, 8, 2), requires_grad=True)
    x = torch.ones((2, 8, 4), requires_grad=True)
    loss = ndiv_cuda.ndiv_loss_fused(z, x, 0.8)
    loss.backward()
    assert loss.item() == 0.0
    assert torch.isfinite(z.grad).all() and torch.isfinite(x.grad).all()
    total, gz, gx = ndiv_cuda.ndiv_joint_plain(z.detach(), x.detach(), 0.8)
    assert float(total) == 0.0
    assert torch.count_nonzero(gz) == 0 and torch.count_nonzero(gx) == 0


def test_front_door_dispatch_on_cpu():
    z, x = _case(3, 2, 8, 2, 16)
    zt, xt = torch.from_numpy(z), torch.from_numpy(x)
    want = float(jax_reference(jnp.asarray(z), jnp.asarray(x), 0.8))
    for impl in ("auto", "pallas", "jnp"):
        np.testing.assert_allclose(float(ndiv_loss(zt, xt, impl=impl)), want,
                                   **VAL)
    with pytest.raises(ValueError):
        ndiv_loss(zt, xt, impl="bogus")


def test_kernel_shape_range_and_input_checks():
    """The wrappers take every k the JAX fused path takes; for CUDA tensors
    they refuse what the kernel cannot take instead of converting it."""
    assert not ndiv_cuda.fused_available(1)
    assert ndiv_cuda.fused_available(2) and ndiv_cuda.fused_available(1024)
    assert not ndiv_cuda.fused_available(1025)
    z = torch.zeros((2, 8, 2))
    x = torch.zeros((2, 8, 4))
    ndiv_cuda._check_cuda(z, x)
    with pytest.raises(TypeError):
        ndiv_cuda._check_cuda(z.double(), x)
    with pytest.raises(ValueError):
        ndiv_cuda._check_cuda(torch.zeros((2, 2, 8)).transpose(1, 2), x)
    with pytest.raises(ValueError):
        ndiv_cuda._check_cuda(torch.zeros((2, 7, 2)), x)
    with pytest.raises(ValueError):
        ndiv_cuda._check_cuda(z[None], x[None])
    with pytest.raises(ValueError):
        ndiv_loss_reference(torch.zeros((2, 1, 2)), torch.zeros((2, 1, 4)))
    with pytest.raises(ValueError):
        ndiv_cuda.ndiv_loss_fused(torch.zeros((2, 3, 8, 2)),
                                  torch.zeros((3, 2, 8, 4)))


@pytest.mark.parametrize("shape", [(8, 3), (4, 6, 5)])
def test_pairwise_matches_jax(shape):
    # Small integers keep the Gram form exact, so the coincident points
    # (rows 0 and 1) give an exact 0 distance, and a 0 grad, on both sides.
    a = np.random.default_rng(1).integers(-3, 4, size=shape).astype(
        np.float32)
    a[..., 1, :] = a[..., 0, :]
    np.testing.assert_allclose(pairwise_sq_l2(torch.from_numpy(a)).numpy(),
                               np.asarray(jax_pairwise_sq_l2(jnp.asarray(a))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pairwise_l2(torch.from_numpy(a)).numpy(),
                               np.asarray(jax_pairwise_l2(jnp.asarray(a))),
                               **VAL)
    at = torch.from_numpy(a).requires_grad_()
    pairwise_l2(at).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jax_pairwise_l2(v)))(jnp.asarray(a))
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(want), **GRAD)
    assert torch.isfinite(at.grad).all()


def test_pairwise_zero_safe_gradient():
    a = torch.ones((4, 3), requires_grad=True)
    d = pairwise_l2(a)
    assert torch.count_nonzero(d) == 0
    d.sum().backward()
    assert torch.count_nonzero(a.grad) == 0


VARIANTS = ("block", "group", "packed")


# The layouts' kernel shapes: k=8, k padding (k=5), and past k=32, where the
# card's fwd and bwd run the warp kernel at kp = 64 (k=64, and k=40 padded).
KERNEL_SHAPES = [(3, 8, 2, 16), (2, 5, 3, 7), (2, 64, 2, 16), (3, 40, 3, 7)]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("b,k,dz,dx", KERNEL_SHAPES)
def test_fwd_plain_matches_jax_fwd_kernel(b, k, dz, dx, variant):
    """The hinge sum against the JAX ``_fwd_sum`` of each layout in
    interpret mode (the packed ``_fwd_kernel`` under "packed")."""
    z, x = _case(500 + b + k, b, k, dz, dx)
    want = ndiv_pallas._fwd_sum(jnp.asarray(z), jnp.asarray(x), 0.8, variant)
    got = ndiv_cuda.ndiv_fwd(torch.from_numpy(z), torch.from_numpy(x), 0.8,
                             variant)
    np.testing.assert_allclose(float(got), float(want), **VAL)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("b,k,dz,dx", KERNEL_SHAPES)
def test_bwd_plain_matches_jax_bwd_kernel(b, k, dz, dx, variant):
    """The recompute backward at a cotangent g != 1, against the JAX
    ``_bwd_grads`` of each layout in interpret mode."""
    z, x = _case(200 + b + k, b, k, dz, dx)
    g = np.float32(-2.5)
    want_gz, want_gx = ndiv_pallas._bwd_grads(
        jnp.asarray(z), jnp.asarray(x), 0.8, jnp.asarray(g), variant)
    gz, gx = ndiv_cuda.ndiv_bwd(torch.from_numpy(z), torch.from_numpy(x), 0.8,
                                torch.tensor(g), variant)
    _assert_grads_close(gz.numpy(), np.asarray(want_gz))
    _assert_grads_close(gx.numpy(), np.asarray(want_gx))
    # The joint kernel's unit grads, scaled, are the same function.
    _, ugz, ugx = ndiv_cuda.ndiv_joint_plain(torch.from_numpy(z),
                                             torch.from_numpy(x), 0.8)
    _assert_grads_close(gz.numpy(), float(g) * ugz.numpy())
    _assert_grads_close(gx.numpy(), float(g) * ugx.numpy())


@pytest.mark.parametrize("joint", [True, False])
@pytest.mark.parametrize("variant", VARIANTS)
def test_fused_routes_match_reference_autograd_and_jax(monkeypatch, variant,
                                                       joint):
    """Each (variant, JOINT) route of the port and of the JAX package:
    loss and grads at a cotangent of 3 against reference autograd."""
    monkeypatch.setattr(ndiv_cuda, "JOINT", joint)
    monkeypatch.setattr(ndiv_pallas, "_JOINT", joint)
    z, x = _case(300, 3, 8, 2, 16)
    zt = torch.from_numpy(z).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    loss = ndiv_cuda.ndiv_loss_fused(zt, xt, 0.8, variant=variant)
    (3.0 * loss).backward()
    zr = torch.from_numpy(z).requires_grad_()
    xr = torch.from_numpy(x).requires_grad_()
    ref = ndiv_loss_reference(zr, xr, 0.8)
    (3.0 * ref).backward()
    np.testing.assert_allclose(loss.item(), ref.item(), **VAL)
    _assert_grads_close(zt.grad.numpy(), zr.grad.numpy())
    _assert_grads_close(xt.grad.numpy(), xr.grad.numpy())
    want, (jgz, jgx) = jax.value_and_grad(
        lambda a, c: 3.0 * jax_fused(a, c, 0.8, variant=variant),
        argnums=(0, 1))(jnp.asarray(z), jnp.asarray(x))
    np.testing.assert_allclose(3.0 * loss.item(), float(want), **VAL)
    _assert_grads_close(zt.grad.numpy(), np.asarray(jgz))
    _assert_grads_close(xt.grad.numpy(), np.asarray(jgx))


def test_unknown_variant_and_joint_under_packed_raise():
    z, x = (torch.from_numpy(a) for a in _case(4, 2, 4, 2, 2))
    with pytest.raises(ValueError, match="unknown NDiv kernel variant"):
        ndiv_cuda.ndiv_loss_fused(z, x, variant="blcok")
    for fn in (ndiv_cuda.ndiv_fwd, ndiv_cuda.ndiv_joint):
        with pytest.raises(ValueError, match="unknown NDiv kernel variant"):
            fn(z, x, 0.8, "blcok")
    with pytest.raises(ValueError, match="unknown NDiv kernel variant"):
        ndiv_cuda.ndiv_bwd(z, x, 0.8, torch.ones(()), "blcok")
    with pytest.raises(ValueError, match="no joint kernel"):
        ndiv_cuda.ndiv_joint(z, x, 0.8, "packed")
    assert set(ndiv_cuda.LAUNCHES) == {
        "joint", "fwd", "bwd", "joint_group", "fwd_group", "bwd_group",
        "fwd_packed", "bwd_packed"}


def test_variant_and_joint_defaults_come_from_the_environment():
    """NDIV_VARIANT and NDIV_JOINT are read at import, as the JAX module
    reads them."""
    probe = ("import json; from ndivplanning_tpu_torch.ops import ndiv_cuda;"
             "print(json.dumps([ndiv_cuda.VARIANT, ndiv_cuda.JOINT]))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for env, want in (({}, ["block", True]),
                      ({"NDIV_VARIANT": "packed", "NDIV_JOINT": "0"},
                       ["packed", False])):
        full = {k: v for k, v in os.environ.items()
                if k not in ("NDIV_VARIANT", "NDIV_JOINT")}
        out = subprocess.run([sys.executable, "-c", probe], cwd=root,
                             env={**full, **env}, capture_output=True,
                             text=True, check=True, timeout=300)
        assert json.loads(out.stdout.strip().splitlines()[-1]) == want


@pytest.mark.parametrize("variant", VARIANTS)
def test_recompute_route_at_pod_dp_widths_matches_jax(monkeypatch, variant):
    """The NDIV_JOINT=0 route (forward, then the backward at the cotangent)
    at pod_dp's k=32, dz=2, dx=64, where the block layout's kernels are the
    warp kernel on the card: loss and grads at a cotangent of -2.5 against
    JAX's fwd and bwd kernels in interpret mode and reference autograd."""
    monkeypatch.setattr(ndiv_cuda, "JOINT", False)
    monkeypatch.setattr(ndiv_pallas, "_JOINT", False)
    z, x = _case(400, 2, 32, 2, 64)
    zt = torch.from_numpy(z).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    loss = ndiv_cuda.ndiv_loss_fused(zt, xt, 0.8, variant=variant)
    (-2.5 * loss).backward()
    zr = torch.from_numpy(z).requires_grad_()
    xr = torch.from_numpy(x).requires_grad_()
    (-2.5 * ndiv_loss_reference(zr, xr, 0.8)).backward()
    want, (jgz, jgx) = jax.value_and_grad(
        lambda a, c: -2.5 * jax_fused(a, c, 0.8, variant=variant),
        argnums=(0, 1))(jnp.asarray(z), jnp.asarray(x))
    np.testing.assert_allclose(-2.5 * loss.item(), float(want), **VAL)
    for got, ref in ((zt.grad, (zr.grad, jgz)), (xt.grad, (xr.grad, jgx))):
        for r in ref:
            _assert_grads_close(got.numpy(), np.asarray(r))
