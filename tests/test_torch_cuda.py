"""The port's CUDA kernels on the card (marked ``cuda``; skipped without one).

Run on a machine with a card, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest pins JAX to the CPU, and this file
needs no JAX.)
"""

import math

import pytest
import torch

from ndivplanning_tpu_torch.ops import ndiv_cuda
from ndivplanning_tpu_torch.ops.ndiv import ndiv_loss_reference

pytestmark = pytest.mark.cuda

VARIANTS = ("block", "group", "packed")
# Shapes: the goalcond and imagecond main paths; k padding (k=5) with a
# batch that fills no whole group or packed tile; conditions whose k x k
# matrices spill to global scratch under group and packed (k=32: 4 and 8
# conditions per block); one condition per block at every tiling (k=256).
SHAPES = [(256, 8, 2, 64), (512, 8, 2, 64), (3, 5, 3, 7), (9, 5, 3, 7),
          (40, 32, 2, 16), (2, 64, 2, 16), (1, 256, 4, 8)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NDiv kernels have no CPU mode")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


def _spread_latents(gen, b, k, d):
    """k random points of an integer grid per condition, jittered by at
    most 0.25 per axis: no near-duplicate pairs, where the Gram form would
    cancel most digits and any two float32 orderings disagree."""
    side = math.ceil(k ** (1.0 / d)) + 1
    axis = torch.arange(side, dtype=torch.float32, device="cuda")
    grid = torch.cartesian_prod(*[axis] * d).reshape(-1, d)
    pick = torch.argsort(torch.rand((b, side ** d), generator=gen,
                                    device="cuda"), dim=1)[:, :k]
    jitter = 0.5 * (torch.rand((b, k, d), generator=gen, device="cuda") - 0.5)
    return (grid[pick] + jitter - 0.5 * (side - 1)).contiguous()


def _inputs(gen, b, k, dz, dx):
    return (_spread_latents(gen, b, k, dz),
            torch.randn((b, k, dx), generator=gen, device="cuda"))


def _assert_grads_close(got, want):
    """rtol 1e-4 and an atol of 1e-5 of the largest |want|: the unit grads
    are ~1/(B k (k-1)) in size, so a fixed atol would hide them."""
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("b,k,dz,dx", SHAPES)
def test_kernels_match_plain_versions_bitwise_repeatably(cuda, b, k, dz, dx,
                                                         variant):
    z, x = _inputs(cuda, b, k, dz, dx)
    total = ndiv_cuda.ndiv_fwd(z, x, 0.8, variant)
    torch.testing.assert_close(total, ndiv_cuda.ndiv_fwd_plain(z, x, 0.8),
                               rtol=1e-5, atol=0.0)
    assert torch.equal(ndiv_cuda.ndiv_fwd(z, x, 0.8, variant), total)
    if variant == "packed":
        return
    total, gz, gx = ndiv_cuda.ndiv_joint(z, x, 0.8, variant)
    ref, ref_gz, ref_gx = ndiv_cuda.ndiv_joint_plain(z, x, 0.8)
    torch.testing.assert_close(total, ref, rtol=1e-5, atol=0.0)
    _assert_grads_close(gz, ref_gz)
    _assert_grads_close(gx, ref_gx)
    again = ndiv_cuda.ndiv_joint(z, x, 0.8, variant)
    assert all(torch.equal(a, b) for a, b in zip(again, (total, gz, gx)))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("b,k,dz,dx", SHAPES)
def test_bwd_matches_plain_version_at_a_cotangent(cuda, b, k, dz, dx,
                                                  variant):
    z, x = _inputs(cuda, b, k, dz, dx)
    g = torch.tensor(-2.5, device="cuda")
    gz, gx = ndiv_cuda.ndiv_bwd(z, x, 0.8, g, variant)
    ref_gz, ref_gx = ndiv_cuda.ndiv_bwd_plain(z, x, 0.8, g)
    _assert_grads_close(gz, ref_gz)
    _assert_grads_close(gx, ref_gx)
    again = ndiv_cuda.ndiv_bwd(z, x, 0.8, g, variant)
    assert torch.equal(again[0], gz) and torch.equal(again[1], gx)


@pytest.mark.parametrize("b,k,dz,dx", SHAPES)
def test_tilings_give_bitwise_equal_grads(cuda, b, k, dz, dx):
    """Every per-condition value is computed in one fixed order whatever
    the tiling, so the grads agree bitwise; the loss's summation tree
    differs, so the losses agree to rounding (rtol 1e-6)."""
    z, x = _inputs(cuda, b, k, dz, dx)
    g = torch.tensor(0.75, device="cuda")
    block = ndiv_cuda.ndiv_joint(z, x, 0.8, "block")
    group = ndiv_cuda.ndiv_joint(z, x, 0.8, "group")
    assert torch.equal(block[1], group[1]) and torch.equal(block[2], group[2])
    bwd = [ndiv_cuda.ndiv_bwd(z, x, 0.8, g, v) for v in VARIANTS]
    for other in bwd[1:]:
        assert torch.equal(bwd[0][0], other[0])
        assert torch.equal(bwd[0][1], other[1])
    for v in VARIANTS:
        torch.testing.assert_close(ndiv_cuda.ndiv_fwd(z, x, 0.8, v), block[0],
                                   rtol=1e-6, atol=0.0)


# (variant, JOINT) -> the launches one differentiated loss makes, as
# _vjp_fwd routes it: the joint kernel for block and group with JOINT on,
# else one forward and one backward.
ROUTES = [("block", True, {"joint": 1}),
          ("block", False, {"fwd": 1, "bwd": 1}),
          ("group", True, {"joint_group": 1}),
          ("group", False, {"fwd_group": 1, "bwd_group": 1}),
          ("packed", True, {"fwd_packed": 1, "bwd_packed": 1}),
          ("packed", False, {"fwd_packed": 1, "bwd_packed": 1})]


@pytest.mark.parametrize("variant,joint,want", ROUTES)
def test_autograd_routes_launch_their_kernels(cuda, monkeypatch, variant,
                                              joint, want):
    monkeypatch.setattr(ndiv_cuda, "JOINT", joint)
    z = _spread_latents(cuda, 16, 8, 2).requires_grad_()
    x = torch.randn((16, 8, 32), generator=cuda, device="cuda",
                    requires_grad=True)
    before = dict(ndiv_cuda.LAUNCHES)
    loss = ndiv_cuda.ndiv_loss_fused(z, x, 0.8, variant=variant)
    (3.0 * loss).backward()
    launched = {key: n - before[key] for key, n in ndiv_cuda.LAUNCHES.items()
                if n != before[key]}
    assert launched == want
    zr = z.detach().clone().requires_grad_()
    xr = x.detach().clone().requires_grad_()
    (3.0 * ndiv_loss_reference(zr, xr, 0.8)).backward()
    torch.testing.assert_close(loss, ndiv_loss_reference(zr, xr, 0.8),
                               rtol=1e-5, atol=0.0)
    _assert_grads_close(z.grad, zr.grad)
    _assert_grads_close(x.grad, xr.grad)


def test_autograd_counts_one_launch_per_loss(cuda):
    z = _spread_latents(cuda, 16, 8, 2).requires_grad_()
    x = torch.randn((16, 8, 32), generator=cuda, device="cuda",
                    requires_grad=True)
    before = dict(ndiv_cuda.LAUNCHES)
    loss = ndiv_cuda.ndiv_loss_fused(z, x, 0.8, variant="block")
    loss.backward()
    with torch.no_grad():
        ndiv_cuda.ndiv_loss_fused(z, x, 0.8, variant="block")
    assert ndiv_cuda.LAUNCHES["joint"] == before["joint"] + 1
    assert ndiv_cuda.LAUNCHES["fwd"] == before["fwd"] + 1
    zr = z.detach().clone().requires_grad_()
    xr = x.detach().clone().requires_grad_()
    ndiv_loss_reference(zr, xr, 0.8).backward()
    _assert_grads_close(z.grad, zr.grad)
    _assert_grads_close(x.grad, xr.grad)


def test_wrappers_raise_instead_of_converting(cuda):
    z = torch.zeros((2, 8, 2), device="cuda")
    with pytest.raises(TypeError):
        ndiv_cuda.ndiv_joint(z.double(), torch.zeros((2, 8, 4), device="cuda"),
                             0.8)
    with pytest.raises(ValueError):
        ndiv_cuda.ndiv_fwd(z, torch.zeros((2, 8, 4)), 0.8)
    with pytest.raises(ValueError):
        ndiv_cuda.ndiv_bwd(z, torch.zeros((2, 8, 4), device="cuda"), 0.8,
                           torch.ones(()), "group")
    with pytest.raises(ValueError, match="no joint kernel"):
        ndiv_cuda.ndiv_joint(z, torch.zeros((2, 8, 4), device="cuda"), 0.8,
                             "packed")
