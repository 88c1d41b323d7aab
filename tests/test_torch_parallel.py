"""The torch port's mesh, sharded NDiv and sharded train step on gloo ranks.

Ranks are spawned processes (``parallel/spawn.py::run_ranks``, workers in
``tests/torch_dist_workers.py``) joined through a ``FileStore`` in
``tmp_path``; the kernels run as their plain versions on the CPU.  The
sharded NDiv is held against the JAX package's
``ndiv_loss_sharded`` on its 8 virtual CPU devices (``conftest.py``), at
``tests/test_parallel.py``'s tolerances; the sharded step against the
port's unsharded step on the same injected batches and latents.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndivplanning_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ndivplanning_tpu.parallel.sharded_step import (
    ndiv_loss_sharded as jax_ndiv_loss_sharded,
)
from ndivplanning_tpu_torch.data.tasks import Batch, make_task
from ndivplanning_tpu_torch.envs.types import Scene
from ndivplanning_tpu_torch.parallel import make_mesh
from ndivplanning_tpu_torch.parallel.spawn import run_ranks
from ndivplanning_tpu_torch.train.state import create_train_state
from ndivplanning_tpu_torch.train.step import train_step_impl
from ndivplanning_tpu_torch.utils.config import get_config
from tests.torch_dist_workers import (
    ndiv_mesh_state_worker,
    sharded_step_worker,
)

WORLD = 4
MESHES = [(4, 1), (2, 2), (1, 4)]
IMPLS = ["jnp", "pallas"]
STEP_MESHES = [(2, 2), (4, 1)]
STEPS = 3
# tests/test_parallel.py's tolerances for the JAX package's own sharding.
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
STEP_TOL = dict(rtol=1e-3, atol=1e-5)


def _inputs():
    rng = np.random.default_rng(1)
    full = (rng.normal(size=(16, 8, 2)).astype(np.float32),
            rng.normal(size=(16, 8, 64)).astype(np.float32))
    # The ragged batch: 3 conditions per dp rank over 2 div ranks (chunk 2,
    # one zero-padded condition).
    rng = np.random.default_rng(2)
    ragged = (rng.normal(size=(6, 8, 2)).astype(np.float32),
              rng.normal(size=(6, 8, 16)).astype(np.float32))
    cases = [(f"{impl}_{dp}x{div}", dp, div, impl, *full)
             for dp, div in MESHES for impl in IMPLS]
    cases += [(f"{impl}_ragged", 2, 2, impl, *ragged) for impl in IMPLS]
    return {c[0]: c for c in cases}


def _small_cfg(**kw):
    return get_config("pod_dp", batch_size=16, k=8, g_hidden=(32,),
                      d_hidden=(32,), cond_embed_dim=8, compute_dtype="f32",
                      dp_shards=1, div_shards=1, **kw)


@pytest.fixture(scope="module")
def ndiv_ranks(tmp_path_factory):
    cases = _inputs()
    results = run_ranks(ndiv_mesh_state_worker, WORLD,
                        tmp_path_factory.mktemp("ndiv"), list(cases.values()),
                        _small_cfg())
    return cases, results


@pytest.fixture(scope="module")
def step_ranks(tmp_path_factory):
    """The sharded step at STEP_MESHES (twice at the first) and the port's
    unsharded step, from one state on the same batches and latents."""
    cfg = _small_cfg()
    state = create_train_state(cfg, seed=5, device="cpu")
    weights = {name: {k: v.numpy().copy()
                      for k, v in module.state_dict().items()}
               for name, module in (("g", state.g), ("d", state.d),
                                    ("g_ema", state.g_ema))}
    gen = torch.Generator().manual_seed(3)
    rng = np.random.default_rng(4)
    inputs = []
    for _ in range(STEPS):
        batch = make_task(cfg).sample(gen, cfg.batch_size)
        inputs.append((batch.conditions.numpy(), batch.real_traj.numpy(),
                       rng.normal(size=(cfg.batch_size, cfg.k,
                                        cfg.latent_dim)).astype(np.float32)))
    sharded = run_ranks(sharded_step_worker, WORLD,
                        tmp_path_factory.mktemp("step"), cfg, STEP_MESHES,
                        weights, inputs, 2)
    history = []
    for cond, real, z in inputs:
        batch = Batch(torch.tensor(cond), torch.tensor(real),
                      Scene.create_batch(torch.tensor(cond[:, :2]),
                                         torch.tensor(cond[:, 2:])))
        state, m = train_step_impl(cfg, state, batch, z=torch.tensor(z))
        history.append({k: float(v) for k, v in m.items()})
    return cfg, sharded, (history, state)


def _jax_want(name, dp, div, impl, z, x):
    mesh = jax_make_mesh(dp=dp, div=div)

    def loss(a, b):
        return jax_ndiv_loss_sharded(a, b, 0.8, mesh, impl=impl)

    value, grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        jnp.asarray(z), jnp.asarray(x))
    return float(value), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", [f"{impl}_{dp}x{div}" for dp, div in MESHES
                                  for impl in IMPLS]
                         + [f"{impl}_ragged" for impl in IMPLS])
def test_sharded_ndiv_matches_jax(ndiv_ranks, name):
    """Loss and grads of both strategies at (4,1), (2,2), (1,4) and on the
    ragged batch: every rank returns the same loss, and the ranks' grads of
    their own blocks assemble to JAX's grads of the global arrays."""
    cases, results = ndiv_ranks
    case = cases[name]
    want, (want_gz, want_gx) = _jax_want(*case)
    z, x = case[4], case[5]
    got_gz, got_gx = np.full_like(z, np.nan), np.full_like(x, np.nan)
    losses = []
    for rank_out in results:
        loss, (rows, cols), gz, gx = rank_out["ndiv"][name]
        losses.append(loss)
        got_gz[rows, cols], got_gx[rows, cols] = gz, gx
    assert len(set(losses)) == 1, losses
    np.testing.assert_allclose(losses[0], want, **LOSS_TOL)
    np.testing.assert_allclose(got_gz, want_gz, **GRAD_TOL)
    np.testing.assert_allclose(got_gx, want_gx, **GRAD_TOL)


def test_shard_state_makes_replicas_bitwise_equal(ndiv_ranks):
    """Each rank built its state from its own seed and counters;
    shard_state gives every rank rank 0's, generator state included."""
    _, results = ndiv_ranks
    tensors0, counters0, draw0 = results[0]["shard_state"]
    assert counters0 == (0, 0, 0)
    for rank_out in results[1:]:
        tensors, counters, draw = rank_out["shard_state"]
        assert counters == counters0
        assert all(np.array_equal(a, b) for a, b in zip(tensors, tensors0))
        np.testing.assert_array_equal(draw, draw0)
    # The seeds differed: without shard_state rank 1's params would not.
    cfg = _small_cfg()
    own = create_train_state(cfg, seed=11, device="cpu")
    assert not np.array_equal(next(own.g.parameters()).detach().numpy(),
                              tensors0[0])


def test_make_mesh_raises_on_a_world_size_mismatch(ndiv_ranks):
    _, results = ndiv_ranks
    for rank_out in results:
        assert "(3x1) needs 3 ranks" in rank_out["mesh_error"]
        assert "has 4" in rank_out["mesh_error"]


def test_make_mesh_raises_without_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(dp=1, div=1)


def _assert_params_close(got, want, mu, lr, steps):
    """STEP_TOL, except where the gradient is within f32 noise of zero
    (|Adam first moment| below 1% of its tensor's largest), where Adam may
    flip an element's update: such an element lies within 2 lr a step."""
    for name, ref in want.items():
        diff = np.abs(got[name] - ref)
        off = diff > STEP_TOL["atol"] + STEP_TOL["rtol"] * np.abs(ref)
        resolved = np.abs(mu[name]) > 1e-2 * np.abs(mu[name]).max()
        assert not np.any(off & resolved), (name, diff[off & resolved].max())
        assert diff.max() <= 2.0 * lr * steps + 1e-6, (name, diff.max())


@pytest.mark.parametrize("mesh", STEP_MESHES)
def test_sharded_step_matches_unsharded(step_ranks, mesh):
    """Three f32 steps over the mesh against the port's unsharded step:
    metrics, and G, D and EMA params, on every rank."""
    cfg, sharded, (history, state) = step_ranks
    want = {name: {k: v.numpy() for k, v in module.state_dict().items()}
            for name, module in (("g", state.g), ("d", state.d),
                                 ("g_ema", state.g_ema))}
    mu = {k: v.numpy() for k, v in state.g_opt.mu.items()}
    d_mu = {k: v.numpy() for k, v in state.d_opt.mu.items()}
    for rank_out in sharded:
        got_history, params, _ = rank_out[mesh][0]
        for got, ref in zip(got_history, history):
            assert set(got) == set(ref)
            for key in ref:
                np.testing.assert_allclose(got[key], ref[key], err_msg=key,
                                           **STEP_TOL)
        _assert_params_close(params["g"], want["g"], mu, cfg.g_lr, STEPS)
        _assert_params_close(params["g_ema"], want["g_ema"], mu, cfg.g_lr,
                             STEPS)
        _assert_params_close(params["d"], want["d"], d_mu, cfg.d_lr, STEPS)
    # Replicas stay bitwise equal: every rank applied the same update.
    first = sharded[0][mesh][0][1]
    for rank_out in sharded[1:]:
        params = rank_out[mesh][0][1]
        assert all(np.array_equal(params[n][k], first[n][k])
                   for n in first for k in first[n])


def test_two_sharded_runs_are_bitwise_equal(step_ranks):
    """The JAX package's determinism promise (ops/ndiv.py): no float
    atomics, fixed collective order."""
    _, sharded, _ = step_ranks
    for rank_out in sharded:
        (h1, p1, mu1), (h2, p2, mu2) = rank_out[STEP_MESHES[0]]
        assert h1 == h2
        assert all(np.array_equal(p1[n][k], p2[n][k])
                   for n in p1 for k in p1[n])
        assert all(np.array_equal(mu1[k], mu2[k]) for k in mu1)


@pytest.mark.parametrize("impl,want", [("pallas", "pallas"), ("jnp", "jnp"),
                                       ("auto", "jnp")])
def test_step_ndiv_with_a_mesh_goes_through_the_sharded_call_site(
        monkeypatch, impl, want):
    """A mesh is authoritative, even a 1x1 one: the step's NDiv is the
    sharded share, through the fused call site for "pallas" and the
    row-block strategy for "jnp" ("auto" on CPU tensors), as the JAX step
    dispatches; on one rank the share is the unsharded loss."""
    from ndivplanning_tpu_torch.ops.ndiv import ndiv_loss
    from ndivplanning_tpu_torch.parallel import sharded_step
    from ndivplanning_tpu_torch.parallel.mesh import Mesh
    from ndivplanning_tpu_torch.train.step import _ndiv

    seen = []
    real = sharded_step.ndiv_share_sharded

    def spy(z, x, alpha, mesh, impl):
        seen.append(impl)
        return real(z, x, alpha, mesh, impl)

    monkeypatch.setattr(sharded_step, "ndiv_share_sharded", spy)
    cfg = _small_cfg(ndiv_impl=impl)
    rng = np.random.default_rng(7)
    z = torch.tensor(rng.normal(size=(4, 8, 2)).astype(np.float32))
    traj = torch.tensor(rng.normal(size=(4, 8, 16, 2)).astype(np.float32))
    got = _ndiv(cfg, z, traj, Mesh(1, 1, 0, 0, None, None))
    assert seen == [want]
    want_loss = ndiv_loss(z, traj.reshape(4, 8, -1), cfg.ndiv_alpha)
    torch.testing.assert_close(got, want_loss, **LOSS_TOL)


def test_run_ranks_reports_a_failing_rank(tmp_path):
    """A rank's exception comes back to the caller with its traceback, and
    no rank is left running."""
    from tests.torch_dist_workers import failing_worker

    with pytest.raises(RuntimeError, match="fails on purpose"):
        run_ranks(failing_worker, 2, tmp_path, timeout=60)
