"""The port's CUDA kernels on the card (marked ``cuda``; skipped without one).

Run on a machine with a card, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest pins JAX to the CPU, and this file
needs no JAX.)
"""

import math

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ndivplanning_tpu_torch.ops import ndiv_cuda
from ndivplanning_tpu_torch.ops.ndiv import (
    ndiv_loss_reference,
    normalized_pairwise_l2,
)
from ndivplanning_tpu_torch.ops.pairwise import pairwise_l2

pytestmark = pytest.mark.cuda

VARIANTS = ("block", "group", "packed")
# Shapes: the goalcond and imagecond main paths; k padding (k=5) with a
# batch that fills no whole group or packed tile; conditions whose k x k
# matrices spill to global scratch under the tile kernel (the joint at
# k=63 and 64, and k=256, where the tile kernel serves every mode); k=32
# at pod_dp's widths (its per-rank batch 8192, and 1024); ragged k for the warp kernel
# (k=2 and 31, batches that fill no whole block of 4 or 2 conditions; k=33,
# 40 and 63, padded to kp = 64, where fwd and bwd run the warp kernel and
# the joint the tile kernel); k=64 at imagecond's widths.
SHAPES = [(256, 8, 2, 64), (512, 8, 2, 64), (3, 5, 3, 7), (9, 5, 3, 7),
          (40, 32, 2, 16), (2, 64, 2, 16), (1, 256, 4, 8),
          (1024, 32, 2, 64), (8192, 32, 2, 64), (7, 2, 3, 7),
          (5, 31, 2, 16), (6, 33, 2, 16), (5, 40, 3, 7), (3, 63, 2, 16),
          (512, 64, 2, 64)]
# The largest k the warp kernel serves in each mode, in every layout (the
# rows of every shape here fit in shared memory).
WARP_K = {"joint": 32, "fwd": 64, "bwd": 64}
WARP_SHAPES = [s for s in SHAPES if s[1] <= WARP_K["fwd"]]
JOINT_WARP_SHAPES = [s for s in SHAPES if s[1] <= WARP_K["joint"]]
ALPHA = 0.8
G_CHECK = -2.5  # the cotangent the backward kernels are checked at


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


def _draw(gen, b, k, dz, dx):
    return (_spread_latents(gen, b, k, dz),
            torch.randn((b, k, dx), generator=gen, device="cuda"))


def _inputs(gen, b, k, dz, dx):
    """Spread latents and Gaussian outputs, with every condition redrawn
    that holds a pair whose hinge slack alpha nz - nx lies within 2^-16 of
    its own size from 0 (in float64): at such a kink the subgradient takes
    either side under float32 rounding, and one flipped pair moves its
    condition's grads by ~1/k of the largest.  At 1024 conditions of k=32
    a few such pairs occur in most draws."""
    z, x = _draw(gen, b, k, dz, dx)
    off = ~torch.eye(k, dtype=torch.bool, device="cuda")
    for _ in range(100):
        nz = 0.8 * normalized_pairwise_l2(z.double())
        nx = normalized_pairwise_l2(x.double())
        kink = ((nz - nx).abs() < 2.0 ** -16 * torch.maximum(nz, nx)) & off
        bad = kink.flatten(1).any(dim=1)
        if not bool(bad.any()):
            return z, x
        z[bad], x[bad] = _draw(gen, int(bad.sum()), k, dz, dx)
    raise AssertionError("no inputs away from the hinge's kinks in 100 draws")


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


def _tile(kernel, variant, z, x, g=None):
    """The tile kernel at this shape, whatever the dispatch would run: the
    reference the warp kernel is held against."""
    return ndiv_cuda._launch(kernel, variant, z, x, ALPHA, g, impl="tile")


def _serves_warp(kernel, k):
    return k <= WARP_K[kernel]


@pytest.mark.parametrize("b,k,dz,dx", SHAPES)
def test_tilings_give_bitwise_equal_grads(cuda, b, k, dz, dx):
    """Every per-condition value is computed in one fixed order whatever
    the layout or kernel, so the grads agree bitwise; the loss's summation
    tree may differ, so the losses agree to rounding (rtol 1e-6).  The
    kernel is chosen by shape alone, in every layout: the warp kernel up
    to WARP_K, the tile kernel past it."""
    z, x = _inputs(cuda, b, k, dz, dx)
    g = torch.tensor(0.75, device="cuda")
    for kernel in ("joint", "fwd", "bwd"):
        want = "warp" if _serves_warp(kernel, k) else "tile"
        assert ndiv_cuda.serving_kernel(kernel, k, dz, dx) == want
    block = ndiv_cuda.ndiv_joint(z, x, 0.8, "block")
    group = ndiv_cuda.ndiv_joint(z, x, 0.8, "group")
    assert torch.equal(block[1], group[1]) and torch.equal(block[2], group[2])
    torch.testing.assert_close(block[0], group[0], rtol=1e-6, atol=0.0)
    bwd = [ndiv_cuda.ndiv_bwd(z, x, 0.8, g, v) for v in VARIANTS]
    for other in bwd[1:]:
        assert torch.equal(bwd[0][0], other[0])
        assert torch.equal(bwd[0][1], other[1])
    for v in VARIANTS:
        torch.testing.assert_close(ndiv_cuda.ndiv_fwd(z, x, 0.8, v), block[0],
                                   rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("b,k,dz,dx", WARP_SHAPES)
def test_layouts_are_bitwise_equal_under_the_warp_kernel(cuda, b, k, dz, dx):
    """Where the warp kernel serves, the three layouts are one launch of
    one kernel: totals and grads bitwise equal, not only to rounding."""
    z, x = _inputs(cuda, b, k, dz, dx)
    g = torch.tensor(G_CHECK, device="cuda")
    fwd = [ndiv_cuda.ndiv_fwd(z, x, ALPHA, v) for v in VARIANTS]
    bwd = [ndiv_cuda.ndiv_bwd(z, x, ALPHA, g, v) for v in VARIANTS]
    for other_fwd, other_bwd in zip(fwd[1:], bwd[1:]):
        assert torch.equal(fwd[0], other_fwd)
        assert all(torch.equal(a, c) for a, c in zip(bwd[0], other_bwd))
    if _serves_warp("joint", k):
        block = ndiv_cuda.ndiv_joint(z, x, ALPHA, "block")
        group = ndiv_cuda.ndiv_joint(z, x, ALPHA, "group")
        assert all(torch.equal(a, c) for a, c in zip(block, group))


@pytest.mark.parametrize("g_val", [1.0, G_CHECK])
@pytest.mark.parametrize("b,k,dz,dx", WARP_SHAPES)
def test_block_fwd_and_bwd_run_the_warp_kernel_as_the_tile_kernel(
        cuda, b, k, dz, dx, g_val):
    """Where the warp kernel serves (fwd and bwd up to k=64, joint up to
    32), its grads are bitwise the tile kernel's (reached on purpose,
    _tile) at the cotangent, and its totals lie within rtol 1e-6 of the
    tile kernel's (another summation tree) and repeat bitwise."""
    z, x = _inputs(cuda, b, k, dz, dx)
    g = torch.tensor(g_val, device="cuda")
    assert ndiv_cuda.serving_kernel("bwd", k, dz, dx) == "warp"
    assert ndiv_cuda.serving_kernel("fwd", k, dz, dx) == "warp"
    block = ndiv_cuda.ndiv_bwd(z, x, ALPHA, g)
    tile = _tile("bwd", "block", z, x, g)
    assert torch.equal(block[0], tile[0]) and torch.equal(block[1], tile[1])
    total = ndiv_cuda.ndiv_fwd(z, x, ALPHA)
    torch.testing.assert_close(total, _tile("fwd", "block", z, x), rtol=1e-6,
                               atol=0.0)
    assert torch.equal(ndiv_cuda.ndiv_fwd(z, x, ALPHA), total)
    if _serves_warp("joint", k):
        joint = ndiv_cuda.ndiv_joint(z, x, ALPHA)
        tile = _tile("joint", "block", z, x)
        assert torch.equal(joint[1], tile[1]) and torch.equal(joint[2],
                                                              tile[2])
        torch.testing.assert_close(joint[0], tile[0], rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("kernel,b,k,dz,dx", [
    (kernel, *s) for kernel in ("joint", "fwd", "bwd") for s in SHAPES
    if _serves_warp(kernel, s[1])])
def test_warp_kernel_results_do_not_depend_on_its_grid(cuda, b, k, dz, dx,
                                                       kernel):
    """One partial per condition, summed in an order set by the shape: the
    total and the grads are bitwise equal whether 1, 7 or the resident
    count of blocks walks the conditions (a card with other SMs gives
    other grids)."""
    z, x = _inputs(cuda, b, k, dz, dx)
    g = torch.tensor(G_CHECK, device="cuda")
    resident = ndiv_cuda.load().ndiv_blocks(ndiv_cuda._MODES[kernel], b, k,
                                            dz, dx, 0)
    assert resident >= 1
    runs = [ndiv_cuda._launch(kernel, "block", z, x, ALPHA,
                              g if kernel == "bwd" else None, blocks=n)
            for n in (1, 7, resident)]
    runs = [r if isinstance(r, tuple) else (r,) for r in runs]
    for other in runs[1:]:
        assert all(torch.equal(a, c) for a, c in zip(runs[0], other))


def _kink_band(k):
    """Relative width of the band around the hinge's kink where the
    kernel's float32 slack alpha nz - nx may take either sign: each of nz
    and nx carries the rounding of a distance, a k-term row sum and a
    quotient (and alpha's product), (k + 1) 2^-24 of it at most."""
    return 2.0 * (k + 1) * 2.0 ** -24


def _with_kinks(z, x, every=8):
    """Every ``every``-th condition with x_1 moved along x_1 - x_0 until
    its pair (0, 1) sits on the hinge's kink in float64, alpha nz_01 =
    nx_01 (nx_01 = D_01 / (D_01 + rest of row 0)), then rounded to
    float32: within a few 2^-24 of the kink."""
    x = x.clone()
    rows = slice(0, None, every)
    z64, x64 = z[rows].double(), x[rows].double()
    a = ALPHA * normalized_pairwise_l2(z64)[:, 0, 1]
    d0 = pairwise_l2(x64)[:, 0]
    rest = d0.sum(-1) - d0[:, 1]
    scale = (a * rest / (1.0 - a)) / d0[:, 1]
    x[rows, 1] = (x64[:, 0] + scale[:, None]
                  * (x64[:, 1] - x64[:, 0])).float()
    return x


def _plain_grads_given(z, x, s_on, active):
    """The plain version's grads with slack ``s_on`` on the pairs of
    ``active`` [b, k, k] (instead of on those whose hinge is positive)."""
    valid = ~torch.eye(z.shape[1], dtype=torch.bool, device=z.device)
    dz, rz, nz = ndiv_cuda._distances(z)
    dx, rx, nx = ndiv_cuda._distances(x)
    s = torch.where(active & valid, s_on, torch.zeros_like(s_on))
    return (ndiv_cuda._unit_grad(z, dz, rz, nz, ALPHA * s, valid),
            ndiv_cuda._unit_grad(x, dx, rx, nx, -s, valid))


def _assert_grads_on_either_side(got, z64, x64, s_on):
    """Grads against the float64 plain version at rtol 1e-4 + 1e-5 of the
    largest: exactly in every condition without a pair in the kink band,
    and with each such pair's slack taken on one side or the other in the
    others."""
    k = z64.shape[1]
    off = ~torch.eye(k, dtype=torch.bool, device=z64.device)
    nz = ALPHA * normalized_pairwise_l2(z64)
    nx = normalized_pairwise_l2(x64)
    active = (nz - nx > 0) & off
    band = ((nz - nx).abs() <= _kink_band(k) * torch.maximum(nz, nx)) & off
    kinked = band.flatten(1).any(dim=1)
    assert bool(kinked.any()), "no condition holds a pair at its kink"
    want = _plain_grads_given(z64, x64, s_on, active)
    atols = [1e-5 * float(w.abs().max()) for w in want]

    def close(g_c, w_c, atol):
        return ((g_c.double() - w_c).abs()
                <= 1e-4 * w_c.abs() + atol).flatten(1).all(dim=1)

    ok = close(got[0], want[0], atols[0]) & close(got[1], want[1], atols[1])
    assert bool(ok[~kinked].all()), (
        f"{int((~ok & ~kinked).sum())} conditions away from the kinks off")
    for c in torch.nonzero(kinked).flatten().tolist():
        pairs = torch.nonzero(band[c]).tolist()
        assert len(pairs) <= 10, f"condition {c}: {len(pairs)} kink pairs"
        sides = []
        for mask in range(2 ** len(pairs)):
            act = active[c].clone()
            for bit, (i, j) in enumerate(pairs):
                act[i, j] = bool(mask >> bit & 1)
            w_c = _plain_grads_given(z64[c:c + 1], x64[c:c + 1], s_on,
                                     act[None])
            sides.append(all(bool(close(g[c:c + 1], w, atol)[0])
                             for g, w, atol in zip(got, w_c, atols)))
        assert any(sides), f"condition {c}: no side of {pairs} matches"


@pytest.mark.parametrize("variant", ["block", "group"])
@pytest.mark.parametrize("b,k,dz,dx", [(1024, 32, 2, 64), (512, 8, 2, 64),
                                       (512, 64, 2, 64)])
def test_kernels_hold_at_the_hinge_kinks(cuda, b, k, dz, dx, variant):
    """Draws kept with their near-kink pairs, every 8th condition with a
    pair put on its kink: the totals of ndiv_fwd and ndiv_joint against the
    float64 plain version at rtol 1e-5 (the hinge is continuous there), and
    the grads of ndiv_joint and of ndiv_bwd at G_CHECK on either side of
    each kink (_assert_grads_on_either_side)."""
    z, x = _draw(cuda, b, k, dz, dx)
    x = _with_kinks(z, x)
    z64, x64 = z.double(), x.double()
    want = ndiv_cuda.ndiv_fwd_plain(z64, x64, ALPHA)
    joint = ndiv_cuda.ndiv_joint(z, x, ALPHA, variant)
    for total in (ndiv_cuda.ndiv_fwd(z, x, ALPHA, variant), joint[0]):
        torch.testing.assert_close(total.double(), want, rtol=1e-5, atol=0.0)
    inv_m = 1.0 / (b * k * (k - 1))
    one = torch.tensor(inv_m, dtype=torch.float64, device="cuda")
    _assert_grads_on_either_side(joint[1:], z64, x64, one)
    g = torch.tensor(G_CHECK, device="cuda")
    _assert_grads_on_either_side(ndiv_cuda.ndiv_bwd(z, x, ALPHA, g, variant),
                                 z64, x64, G_CHECK * one)


def _ndiv_launches(fn):
    """NDiv kernels the profiler sees in one call of ``fn``, after one
    call unprofiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and ("ndiv" in e.key or "sum_partials" in e.key))


@pytest.mark.parametrize("k,joint,fwd", [(8, 1, 1), (32, 1, 1), (33, 2, 1),
                                         (64, 2, 1), (65, 2, 2)])
def test_block_joint_call_is_one_kernel_launch_up_to_k_32(cuda, k, joint,
                                                          fwd):
    """The warp kernel sums the loss in its last block: one launch per
    joint call up to k=32 and per fwd call up to k=64; the tile kernel
    adds its one-block sum of the partials."""
    z, x = _inputs(cuda, 64, k, 2, 16)
    for call, want in ((ndiv_cuda.ndiv_joint, joint),
                       (ndiv_cuda.ndiv_fwd, fwd)):
        assert _ndiv_launches(lambda: call(z, x, 0.8)) == want, call.__name__


def test_padded_conditions_get_zero_hinge_and_grads(cuda):
    """The sharded call site pads the batch with all-zero conditions: the
    warp kernel gives them a zero hinge and zero grads, beside real ones."""
    from ndivplanning_tpu_torch.parallel import sharded_step

    assert ndiv_cuda.serving_kernel("joint", 32, 2, 16) == "warp"
    zeros_z = torch.zeros((4, 32, 2), device="cuda")
    zeros_x = torch.zeros((4, 32, 16), device="cuda")
    total, gz, gx = ndiv_cuda.ndiv_joint(zeros_z, zeros_x, 0.8)
    assert float(total) == 0.0 and not gz.any() and not gx.any()
    # b=5 over div=4: chunks of 2, rows 5..7 padding; chunk 3 is all padding,
    # chunk 2 holds row 4 and one padded row.
    z, x = _inputs(cuda, 5, 32, 2, 16)
    zf, xf = z.clone().requires_grad_(), x.clone().requires_grad_()
    empty = sharded_step.ndiv_rank_partial(zf, xf, 0.8, 3, 4)
    g_z, g_x = torch.autograd.grad(empty, (zf, xf))
    assert float(empty) == 0.0 and not g_z.any() and not g_x.any()
    half = sharded_step.ndiv_rank_partial(zf, xf, 0.8, 2, 4)
    g_z, g_x = torch.autograd.grad(half, (zf, xf))
    want = ndiv_cuda.ndiv_joint(z[4:5], x[4:5], 0.8)[0]
    torch.testing.assert_close(half.detach(), want, rtol=1e-6, atol=0.0)
    assert not g_z[:4].any() and not g_x[:4].any()
    assert g_z[4].any() and g_x[4].any()


# (variant, JOINT) -> the launches one differentiated loss makes, as
# _vjp_fwd routes it: the joint kernel for block and group with JOINT on,
# else one forward and one backward; and the NDiv kernels the profiler
# counts (the warp kernel serves every layout at k=8, one kernel a launch).
ROUTES = [("block", True, {"joint": 1}, 1),
          ("block", False, {"fwd": 1, "bwd": 1}, 2),
          ("group", True, {"joint_group": 1}, 1),
          ("group", False, {"fwd_group": 1, "bwd_group": 1}, 2),
          ("packed", True, {"fwd_packed": 1, "bwd_packed": 1}, 2),
          ("packed", False, {"fwd_packed": 1, "bwd_packed": 1}, 2)]


@pytest.mark.parametrize("variant,joint,want,kernels", ROUTES)
def test_autograd_routes_launch_their_kernels(cuda, monkeypatch, variant,
                                              joint, want, kernels):
    monkeypatch.setattr(ndiv_cuda, "JOINT", joint)
    z = _spread_latents(cuda, 16, 8, 2).requires_grad_()
    x = torch.randn((16, 8, 32), generator=cuda, device="cuda",
                    requires_grad=True)

    def step():
        z.grad = x.grad = None
        loss = ndiv_cuda.ndiv_loss_fused(z, x, 0.8, variant=variant)
        (3.0 * loss).backward()
        return loss

    assert _ndiv_launches(step) == kernels
    before = dict(ndiv_cuda.LAUNCHES)
    loss = step()
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


def test_bf16_inputs_compute_in_f32_and_return_bf16_grads(cuda):
    """bf16 z and x: the kernel runs on their float32 upcast; the grads come
    back as bf16, within an ulp (2^-8 to 2^-7 of a value) of the plain
    version's on the CPU: the two round different float32 values."""
    z = _spread_latents(cuda, 64, 8, 2).bfloat16().requires_grad_()
    x = torch.randn((64, 8, 32), generator=cuda,
                    device="cuda").bfloat16().requires_grad_()
    before = ndiv_cuda.LAUNCHES["joint"]
    loss = ndiv_cuda.ndiv_loss_fused(z, x, 0.8)
    gz, gx = torch.autograd.grad(3.0 * loss, (z, x))
    assert ndiv_cuda.LAUNCHES["joint"] == before + 1
    assert loss.dtype == torch.float32 and gz.dtype == torch.bfloat16
    zc = z.detach().cpu().requires_grad_()
    xc = x.detach().cpu().requires_grad_()
    ref = ndiv_cuda.ndiv_loss_fused(zc, xc, 0.8)
    ref_gz, ref_gx = torch.autograd.grad(3.0 * ref, (zc, xc))
    torch.testing.assert_close(loss.cpu(), ref, rtol=1e-5, atol=0.0)
    for got, want in ((gz, ref_gz), (gx, ref_gx)):
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   rtol=2.0 ** -7,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("dp,div,b", [(1, 2, 64), (2, 2, 64), (2, 2, 6)])
def test_sharded_call_site_ranks_match_the_unsharded_kernel(cuda, dp, div, b):
    """The per-rank function of the sharded call site for dp x div virtual
    ranks: one joint launch each, and partials and grads that sum to the
    unsharded kernel's."""
    from ndivplanning_tpu_torch.parallel import sharded_step

    z, x = _inputs(cuda, b, 8, 2, 16)
    m = b * 8 * 7
    total, want_gz, want_gx = ndiv_cuda.ndiv_joint(z, x, 0.8)
    before = ndiv_cuda.LAUNCHES["joint"]
    partial, gz, gx = 0.0, torch.zeros_like(z), torch.zeros_like(x)
    bl = b // dp
    for i in range(dp):
        rows = slice(i * bl, (i + 1) * bl)
        zf = z[rows].clone().requires_grad_()
        xf = x[rows].clone().requires_grad_()
        for j in range(div):
            p = sharded_step.ndiv_rank_partial(zf, xf, 0.8, j, div)
            g_z, g_x = torch.autograd.grad(p / m, (zf, xf))
            partial += float(p.detach())
            gz[rows] += g_z
            gx[rows] += g_x
    assert ndiv_cuda.LAUNCHES["joint"] - before == dp * div
    assert abs(partial - float(total)) <= 1e-6 * float(total)
    for got, want in ((gz, want_gz), (gx, want_gx)):
        torch.testing.assert_close(got, want, rtol=0.0,
                                   atol=1e-6 * float(want.abs().max()))


def test_pod_dp_step_on_a_one_rank_nccl_mesh(cuda, tmp_path):
    """A shrunk bf16 pod_dp step through make_sharded_train_step on a 1x1
    NCCL mesh: the joint kernel once a step through the sharded call site,
    and the step without a mesh within 1e-5 of it."""
    import copy
    import dataclasses

    import torch.distributed as dist

    from ndivplanning_tpu_torch.parallel import (
        make_mesh,
        make_sharded_train_step,
        shard_state,
    )
    from ndivplanning_tpu_torch.train.state import create_train_state
    from ndivplanning_tpu_torch.train.step import train_step_fused
    from ndivplanning_tpu_torch.utils.config import get_config

    cfg = get_config("pod_dp", batch_size=256, k=8, dp_shards=1)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        step_fn, mesh = make_sharded_train_step(cfg, make_mesh(cfg=cfg))
        state = shard_state(create_train_state(cfg, seed=0), mesh)
        rng = torch.Generator(device="cuda")
        rng.set_state(state.rng.get_state())
        unsharded = dataclasses.replace(
            copy.deepcopy(dataclasses.replace(state, rng=None)), rng=rng)
        before = ndiv_cuda.LAUNCHES["joint"]
        state, m = step_fn(state)
        torch.cuda.synchronize()
        assert ndiv_cuda.LAUNCHES["joint"] - before == 1
        _, want = train_step_fused(cfg, unsharded)
        for key, value in want.items():
            assert m[key].shape == (1,)
            torch.testing.assert_close(m[key][0], value, rtol=1e-5,
                                       atol=0.0)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shards", [dict(dp_shards=2), dict(div_shards=2)])
def test_sharded_config_without_a_mesh_runs_the_fused_kernel(cuda, shards):
    """dp_shards x div_shards > 1 and no mesh: the goalcond step's NDiv
    over the global batch is one launch of the fused joint kernel on the
    card, not the plain reference, and the loss it feeds is finite."""
    from ndivplanning_tpu_torch.train.state import create_train_state
    from ndivplanning_tpu_torch.train.step import train_step_fused
    from ndivplanning_tpu_torch.utils.config import get_config

    cfg = get_config("goalcond", batch_size=64, k=8, **shards)
    state = create_train_state(cfg, seed=0)
    before = dict(ndiv_cuda.LAUNCHES)
    _, m = train_step_fused(cfg, state)
    torch.cuda.synchronize()
    launched = {key: n - before[key] for key, n in ndiv_cuda.LAUNCHES.items()
                if n != before[key]}
    assert launched == {"joint": 1}
    assert math.isfinite(float(m["g_ndiv"])) and float(m["g_ndiv"]) > 0.0


# The serving path on the vendored planning512 model: every score on the
# card within 1e-4 (rtol and atol) of the CPU's, from one state and one
# set of latents; picks may differ only at a near-tie (chip_smoke.py states
# the rule, SERVE_RTOL).
SERVE_TOL = 1e-4
PLANNING512 = "checkpoints_torch/planning512"


def _planning512(device):
    import os

    from ndivplanning_tpu_torch.cli import _load_state
    from ndivplanning_tpu_torch.utils.config import load_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    workdir = os.path.join(root, PLANNING512)
    cfg = load_config(workdir).replace(workdir=workdir)
    return cfg, _load_state(cfg, device)


def test_plan_batch_on_the_card_matches_the_cpu(cuda):
    from ndivplanning_tpu_torch.data.scenes import (
        rasterize_batch,
        random_scene_batch,
    )
    from ndivplanning_tpu_torch.planning.planner import (
        _diverse_top_m,
        plan_batch,
    )

    cfg, state = _planning512("cuda")
    _, cpu_state = _planning512("cpu")
    scenes = random_scene_batch(torch.Generator().manual_seed(3), 16)
    z = torch.randn((16, 1000, cfg.latent_dim),
                    generator=torch.Generator().manual_seed(4))
    want = plan_batch(cfg, cpu_state, scenes, rasterize_batch(scenes, 32),
                      n_diverse=4, z=z)
    cuda_scenes = type(scenes)(**{k: v.cuda() for k, v in vars(scenes).items()})
    got = plan_batch(cfg, state, cuda_scenes,
                     rasterize_batch(cuda_scenes, 32), n_diverse=4,
                     z=z.cuda())
    torch.testing.assert_close(got.scores.cpu(), want.scores, rtol=SERVE_TOL,
                               atol=SERVE_TOL)
    rows = torch.arange(16)
    best, cpu_best = got.scores.argmin(1).cpu(), want.scores.argmin(1)
    gap = (want.scores[rows, best] - want.scores[rows, cpu_best]).abs()
    assert bool((gap <= 2 * (SERVE_TOL * want.scores[rows, cpu_best].abs()
                             + SERVE_TOL)).all())
    # Differing diverse picks come from the scores alone: the CPU's own
    # selection, fed the card's scores, picks the card's.
    same = (got.diverse_idx.cpu() == want.diverse_idx).all(1)
    explained = (_diverse_top_m(want.taus.flatten(2), got.scores.cpu(), 4)
                 == got.diverse_idx.cpu()).all(1)
    assert bool((same | explained).all())


def test_bucket_16_dispatch_launches_as_bucket_1(cuda):
    """The scenes of a dispatch are a batch axis: handle_batch at bucket 16
    launches at most 1.25x the kernels of bucket 1 (profiler count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ndivplanning_tpu_torch.planning.server import handle_batch

    cfg, state = _planning512("cuda")
    req = {"start": [0.1, 0.1], "goal": [0.9, 0.9],
           "obstacles": [[0.5, 0.5, 0.1]]}
    launches = {}
    for bucket in (1, 16):
        handle_batch(cfg, state, [req] * bucket, cuda)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = handle_batch(cfg, state, [req] * bucket, cuda)
            torch.cuda.synchronize()
        assert {r["batch_size"] for r in out} == {bucket}
        launches[bucket] = sum(e.count for e in prof.key_averages()
                               if e.device_type == DeviceType.CUDA)
    assert 0 < launches[16] <= 1.25 * launches[1], launches


def test_train_loop_launches_one_joint_a_step_and_one_fwd_an_eval_leg(
        cuda, tmp_path):
    """The loop on the card: one ndiv_joint launch per step and one ndiv_fwd
    launch per eval leg (EMA and raw), and a run resumed from its workdir
    bitwise equal to an uninterrupted one."""
    from ndivplanning_tpu_torch.train.loop import train
    from ndivplanning_tpu_torch.utils.config import get_config

    cfg = get_config("goalcond", batch_size=64, g_hidden=(64, 64),
                     d_hidden=(64, 64), g_ema_decay=0.9, lr_schedule="cosine",
                     steps=6, log_every=3, eval_every=3, checkpoint_every=3,
                     eval_suite_scenes=64)
    for key in ndiv_cuda.LAUNCHES:
        ndiv_cuda.LAUNCHES[key] = 0
    state_a, _ = train(cfg, workdir=str(tmp_path / "a"), echo=False)
    assert {k: n for k, n in ndiv_cuda.LAUNCHES.items() if n} == {
        "joint": 6, "fwd": 2 * 2}
    train(cfg, num_steps=3, workdir=str(tmp_path / "b"), echo=False)
    state_b, _ = train(cfg, workdir=str(tmp_path / "b"), echo=False)
    assert state_a.step == state_b.step == 6
    for name in ("g", "d", "g_ema"):
        for (key, p), q in zip(getattr(state_a, name).state_dict().items(),
                               getattr(state_b, name).state_dict().values()):
            assert torch.equal(p, q), (name, key)
    for opt in ("g_opt", "d_opt"):
        for key, mu in getattr(state_a, opt).mu.items():
            assert torch.equal(mu, getattr(state_b, opt).mu[key]), key
            assert torch.equal(getattr(state_a, opt).nu[key],
                               getattr(state_b, opt).nu[key]), key
    assert torch.equal(state_a.rng.get_state(), state_b.rng.get_state())


def test_card_eval_matches_the_cpu_on_planning512(cuda):
    """The frozen suite (drawn on the CPU) through planning512 on the card
    and on the CPU: each rate within 2 of the 4096 samples, every other
    metric at rtol 1e-5, and the card's NDiv through one ndiv_fwd launch."""
    from ndivplanning_tpu_torch.train.evaluate import evaluate_fixed
    from ndivplanning_tpu_torch.utils.metrics import host_floats

    cfg, state = _planning512("cuda")
    _, cpu_state = _planning512("cpu")
    for key in ndiv_cuda.LAUNCHES:
        ndiv_cuda.LAUNCHES[key] = 0
    card = host_floats(evaluate_fixed(cfg, state, 512))
    assert {k: n for k, n in ndiv_cuda.LAUNCHES.items() if n} == {"fwd": 1}
    cpu = host_floats(evaluate_fixed(cfg, cpu_state, 512))
    assert card.keys() == cpu.keys()
    for key, want in cpu.items():
        if key in ("eval_success_rate", "eval_collision_rate"):
            assert abs(card[key] - want) <= 2 / (512 * cfg.k) + 1e-9, key
        else:
            assert abs(card[key] - want) <= 1e-5 * abs(want), key


class _CpuResults(TorchDispatchMode):
    """Records every op whose result is a tensor on the CPU."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        leaves = out if isinstance(out, (tuple, list)) else (out,)
        if any(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in leaves):
            self.ops.append(str(func))
        return out


def _unicycle150k_on_the_card(n):
    from ndivplanning_tpu_torch.cli import _load_state
    from ndivplanning_tpu_torch.data.scenes import random_scene_batch
    from ndivplanning_tpu_torch.planning.server import _condition_for
    from ndivplanning_tpu_torch.utils.config import load_config

    workdir = "checkpoints_torch/unicycle150k"
    cfg = load_config(workdir).replace(workdir=workdir)
    state = _load_state(cfg, "cuda")
    scenes = random_scene_batch(torch.Generator(device="cuda").manual_seed(3),
                                n)
    return cfg, state, scenes, _condition_for(cfg, scenes)


def test_mpc_batch_on_the_card_stays_there_and_repeats_bitwise(cuda):
    """8 closed-loop episodes of unicycle150k (64 steps, a replan every 8
    from 256 candidates): no op yields a CPU tensor, and the same seed
    gives the same paths bitwise."""
    from ndivplanning_tpu_torch.planning.mpc import mpc_rollout_batch

    cfg, state, scenes, conds = _unicycle150k_on_the_card(8)
    run = lambda: mpc_rollout_batch(
        cfg, state, scenes, conds,
        torch.Generator(device="cuda").manual_seed(5))
    log = _CpuResults()
    with log:
        a = run()
    assert log.ops == []
    b = run()
    assert torch.equal(a.positions, b.positions)
    assert torch.equal(a.reached, b.reached)
    assert a.positions.shape == (8, 64, 2) and a.positions.is_cuda


def test_cem_plan_on_the_card_stays_there_and_repeats_bitwise(cuda):
    """A CEM plan of 8 unicycle150k scenes at the default budget: no op
    yields a CPU tensor, and the same seed gives the same plan bitwise."""
    from ndivplanning_tpu_torch.planning.cem import plan_cem_batch

    cfg, state, scenes, conds = _unicycle150k_on_the_card(8)
    run = lambda: plan_cem_batch(
        cfg, state, scenes, conds,
        torch.Generator(device="cuda").manual_seed(5))
    log = _CpuResults()
    with log:
        a, curve_a = run()
    assert log.ops == []
    b, curve_b = run()
    assert torch.equal(a.taus, b.taus) and torch.equal(curve_a, curve_b)
    assert torch.equal(a.diverse_idx, b.diverse_idx)
    assert (curve_a[:, 1:] <= curve_a[:, :-1]).all()
