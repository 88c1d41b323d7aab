"""The torch port's train step against the JAX step.

Both start from the same weights, Adam moments and EMA (converted from the
JAX state) and see the same batch and latents: the JAX step's own z draw
(``split(state.rng)``, then ``normal``) is reproduced here and injected into
the port, since the two packages' random streams never agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndivplanning_tpu.data.tasks import make_task as jax_make_task
from ndivplanning_tpu.train.state import create_train_state as jax_create
from ndivplanning_tpu.train.state import lr_schedule as jax_lr_schedule
from ndivplanning_tpu.train.step import train_step as jax_train_step
from ndivplanning_tpu.utils.config import get_config as jax_get_config
from ndivplanning_tpu_torch.data.tasks import Batch
from ndivplanning_tpu_torch.envs.types import Scene
from ndivplanning_tpu_torch.train.state import (
    check_optimizer_knobs,
    create_train_state,
    lr_schedule,
)
from ndivplanning_tpu_torch.train.step import (
    train_step_fused,
    train_step_impl,
)
from ndivplanning_tpu_torch.utils.config import get_config
from ndivplanning_tpu_torch.utils.convert import (
    params_from_flax,
    train_state_from_flax,
)

METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
# NDiv's distances are in Gram form, ||a||^2 + ||b||^2 - 2<a, b>, in both
# packages.  The initial generator's sigmoid samples of one condition sit
# ~0.01 apart at ||x||^2 ~ 16, so the form loses ~3 digits and each package
# rounds differently: JAX's own loss there is 0.4% off the float64 value.
# Measured port-vs-JAX: 4.4e-3 relative at the small width, 2.2e-4 at full.
NDIV_TOL = dict(rtol=1e-2, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
# Gradients (the Adam first moments after one step) carry that NDiv noise:
# measured up to 1.1e-3 of each tensor's largest element.
GRAD_SCALE_TOL = 3e-3
SMALL = dict(batch_size=8, k=4, horizon=8, g_hidden=(32, 32),
             d_hidden=(32, 32))
# The port's LR schedules against optax's, both in float32.
LR_RTOL = 1e-6


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _jax_tree(state):
    """Numpy copy of a JAX TrainState in the converter's layout: each Adam
    chain's optax state as it is, (ScaleByAdamState, EmptyState) under a
    constant LR, (ScaleByAdamState, ScaleByScheduleState) under a
    schedule."""
    return _np({
        "step": state.step, "g_params": state.g_params,
        "d_params": state.d_params, "g_ema_params": state.g_ema_params,
        "ada": state.ada, "g_adam": state.g_opt_state,
        "d_adam": state.d_opt_state,
    })


def _lrs_taken(opt):
    """The LR of every update an Adam chain has taken."""
    return [opt.lr(c) if callable(opt.lr) else opt.lr
            for c in range(opt.count)]


def _torch_batch(jbatch):
    cond = torch.tensor(np.asarray(jbatch.conditions))
    scenes = Scene.create_batch(torch.tensor(np.asarray(jbatch.scenes.start)),
                                torch.tensor(np.asarray(jbatch.scenes.goal)))
    return Batch(conditions=cond,
                 real_traj=torch.tensor(np.asarray(jbatch.real_traj)),
                 scenes=scenes)


def _run_both(n_steps, jax_first=0, **overrides):
    """n_steps of each package from one JAX state (after ``jax_first`` JAX
    steps of its own); returns per-step metrics and the final states."""
    jcfg = jax_get_config("goalcond", **overrides)
    cfg = get_config("goalcond", **overrides)
    jstate = jax_create(jcfg, seed=0)
    task = jax_make_task(jcfg)
    for i in range(jax_first):
        jstate, _ = jax_train_step(
            jcfg, jstate, task.sample(jax.random.PRNGKey(50 + i),
                                      cfg.batch_size))
    state = train_state_from_flax(cfg, _jax_tree(jstate), device="cpu")
    jmetrics, metrics = [], []
    for i in range(n_steps):
        jbatch = task.sample(jax.random.PRNGKey(100 + i), cfg.batch_size)
        z = jax.random.normal(jax.random.split(jstate.rng)[1],
                              (cfg.batch_size, cfg.k, cfg.latent_dim),
                              jnp.float32)
        batch = _torch_batch(jbatch)
        jstate, jm = jax_train_step(jcfg, jstate, jbatch)
        state, m = train_step_impl(cfg, state, batch,
                                   z=torch.tensor(np.asarray(z)))
        jmetrics.append({k: float(v) for k, v in jm.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return jmetrics, metrics, jstate, state


def _assert_state_close(jstate, state, n_steps):
    """Params, EMA and Adam moments of the two packages after n_steps.

    Adam divides each gradient by its own magnitude, so a gradient within
    f32 noise of zero can flip its element's update (first step:
    +-lr * g / (|g| + eps)).  So: every element lies within two updates
    (2 lr per step) of JAX's; after one step, every element outside
    PARAM_TOL has a gradient below 1% of its tensor's largest, and the
    gradients themselves agree within GRAD_SCALE_TOL of that largest."""
    bound = 2.0 * max(_lrs_taken(state.g_opt) + _lrs_taken(state.d_opt)) \
        * n_steps + 1e-6
    for tree, module, opt, jopt in (
            (jstate.g_params, state.g, state.g_opt, jstate.g_opt_state),
            (jstate.d_params, state.d, state.d_opt, jstate.d_opt_state),
            (jstate.g_ema_params, state.g_ema, state.g_opt,
             jstate.g_opt_state)):
        want = params_from_flax(_np(tree))
        jmu = params_from_flax(_np(jopt[0].mu))
        for name, value in module.state_dict().items():
            got, ref = value.numpy(), want[name].numpy()
            diff = np.abs(got - ref)
            assert diff.max() <= bound, (name, diff.max())
            if n_steps == 1:
                mu = jmu[name].numpy()
                scale = np.abs(mu).max()
                np.testing.assert_allclose(opt.mu[name].numpy(), mu,
                                           rtol=1e-4,
                                           atol=GRAD_SCALE_TOL * scale,
                                           err_msg=name)
                off = diff > PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(ref)
                resolved = np.abs(mu) > 1e-2 * scale
                assert not np.any(off & resolved), (name, diff[off].max())
    assert state.step == int(jstate.step)
    assert state.g_opt.count == int(jstate.g_opt_state[0].count)
    np.testing.assert_allclose(float(state.ada["r"]), float(jstate.ada["r"]),
                               **METRIC_TOL)


def _assert_metrics_close(got, want, keys):
    for key in keys:
        tol = NDIV_TOL if key == "g_ndiv" else METRIC_TOL
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **tol)


@pytest.mark.parametrize("ndiv_impl", ["auto", "pallas"])
def test_one_step_small_matches_jax(ndiv_impl):
    """"pallas" puts the JAX interpret-mode joint kernel and the port's
    autograd Function (its plain joint version on the CPU) in the step."""
    jm, m, jstate, state = _run_both(1, ndiv_impl=ndiv_impl, **SMALL)
    assert set(m[0]) == set(jm[0])
    _assert_metrics_close(m[0], jm[0], m[0].keys())
    assert m[0]["g_ndiv"] > 0.0
    _assert_state_close(jstate, state, 1)


def test_three_step_curve_small_matches_jax():
    jm, m, jstate, state = _run_both(3, **SMALL)
    for step in range(3):
        _assert_metrics_close(m[step], jm[step], ("d_loss", "g_adv", "g_ndiv"))
    _assert_state_close(jstate, state, 3)


def test_step_from_converted_mid_training_state_matches_jax():
    """Adam moments, step count, EMA and the ADA tracker carried across by
    the converter after two JAX steps of its own."""
    jm, m, jstate, state = _run_both(1, jax_first=2, **SMALL)
    _assert_metrics_close(m[0], jm[0], m[0].keys())
    assert state.step == 3 and state.d_opt.count == 3
    # Wrong moments would move most elements off JAX's; the Adam flips of
    # near-zero gradients (see _assert_state_close) touch a few (measured:
    # 2 of 24,577), each by at most two updates.
    bound = 2.0 * state.g_opt.lr + 1e-6
    off = total = 0
    for tree, module in ((jstate.g_params, state.g),
                         (jstate.d_params, state.d),
                         (jstate.g_ema_params, state.g_ema)):
        want = params_from_flax(_np(tree))
        for name, value in module.state_dict().items():
            diff = np.abs(value.numpy() - want[name].numpy())
            assert diff.max() <= bound, name
            off += int(np.sum(diff > PARAM_TOL["atol"] + PARAM_TOL["rtol"]
                              * np.abs(want[name].numpy())))
            total += diff.size
    assert off <= 1e-3 * total, (off, total)


def test_one_step_full_goalcond_width_matches_jax():
    jm, m, jstate, state = _run_both(1)
    _assert_metrics_close(m[0], jm[0], m[0].keys())
    _assert_state_close(jstate, state, 1)


def test_fused_step_samples_on_device_and_learns_on_cpu():
    cfg = get_config("pointmass2d", batch_size=8, k=4, horizon=8,
                     g_hidden=(16,), d_hidden=(16,))
    state = create_train_state(cfg, seed=1, device="cpu")
    before = [p.detach().clone() for p in state.g.parameters()]
    for _ in range(2):
        state, metrics = train_step_fused(cfg, state)
    assert state.step == 2
    assert all(torch.isfinite(v) for v in metrics.values())
    assert any(not torch.equal(a, b)
               for a, b in zip(before, state.g.parameters()))


@pytest.mark.parametrize("shards", [dict(dp_shards=2), dict(div_shards=2)])
def test_sharded_config_without_a_mesh_matches_jax(shards):
    """dp_shards x div_shards > 1 and no mesh: the step runs over the
    global batch, as JAX's does; on the CPU both take the NDiv reference
    (on the card the port's fused kernel serves it: test_torch_cuda.py)."""
    jm, m, jstate, state = _run_both(1, **SMALL, **shards)
    assert set(m[0]) == set(jm[0])
    _assert_metrics_close(m[0], jm[0], m[0].keys())
    assert m[0]["g_ndiv"] > 0.0
    _assert_state_close(jstate, state, 1)


def test_pod_dp_shaped_step_on_the_recompute_route_matches_jax(monkeypatch):
    """A pod_dp step shrunk in batch and width but at its k=32, dz=2 and
    dx=64, in float32, with NDIV_JOINT=0 in both packages: the NDiv loss
    through the forward and the backward at the cotangent (the port's
    ndiv_bwd once), against JAX's interpret-mode fwd and bwd kernels."""
    from ndivplanning_tpu.ops import ndiv_pallas
    from ndivplanning_tpu_torch.ops import ndiv_cuda

    calls = []
    bwd = ndiv_cuda.ndiv_bwd
    monkeypatch.setattr(ndiv_cuda, "ndiv_bwd",
                        lambda *a, **kw: calls.append(1) or bwd(*a, **kw))
    monkeypatch.setattr(ndiv_cuda, "JOINT", False)
    monkeypatch.setattr(ndiv_pallas, "_JOINT", False)
    kw = dict(batch_size=4, k=32, g_hidden=(32, 32), d_hidden=(32, 32),
              cond_embed_dim=8, compute_dtype="f32", ndiv_impl="pallas",
              dp_shards=1)
    jcfg, cfg = jax_get_config("pod_dp", **kw), get_config("pod_dp", **kw)
    assert (cfg.k, cfg.latent_dim, 2 * cfg.horizon) == (32, 2, 64)
    jstate = jax_create(jcfg, seed=0)
    state = train_state_from_flax(cfg, _jax_tree(jstate), device="cpu")
    jbatch = jax_make_task(jcfg).sample(jax.random.PRNGKey(11),
                                        cfg.batch_size)
    z = jax.random.normal(jax.random.split(jstate.rng)[1],
                          (cfg.batch_size, cfg.k, cfg.latent_dim),
                          jnp.float32)
    jstate, jm = jax_train_step(jcfg, jstate, jbatch)
    state, m = train_step_impl(cfg, state, _torch_batch(jbatch),
                               z=torch.tensor(np.asarray(z)))
    assert len(calls) == 1
    jm = {k: float(v) for k, v in jm.items()}
    m = {k: float(v) for k, v in m.items()}
    assert set(m) == set(jm)
    _assert_metrics_close(m, jm, m.keys())
    assert m["g_ndiv"] > 0.0
    _assert_state_close(jstate, state, 1)


@pytest.mark.parametrize("schedule,warmup", [("cosine", 0), ("cosine", 5),
                                             ("linear", 0), ("linear", 5)])
def test_lr_schedule_matches_optax(schedule, warmup):
    kw = dict(lr_schedule=schedule, warmup_steps=warmup, steps=100,
              lr_final_ratio=0.1)
    want = jax_lr_schedule(jax_get_config("goalcond", **kw), 2e-3)
    got = lr_schedule(get_config("goalcond", **kw), 2e-3)
    counts = [0, 1, 37, 100, 110]
    if warmup:
        counts += [warmup - 1, warmup, warmup + 1]
    for count in counts:
        np.testing.assert_allclose(
            got(count), float(want(jnp.asarray(count, jnp.int32))),
            rtol=LR_RTOL, err_msg=f"count {count}")


def test_constant_lr_stays_a_float_and_unknown_schedules_raise():
    assert lr_schedule(get_config("goalcond"), 1e-3) == 1e-3
    warm = lr_schedule(get_config("goalcond", warmup_steps=4), 1e-3)
    assert [warm(c) for c in (0, 2)] == [0.0, np.float32(5e-4)]
    with pytest.raises(ValueError, match="unknown lr_schedule 'step'"):
        check_optimizer_knobs(get_config("goalcond", lr_schedule="step"))


def test_three_cosine_warmup_steps_small_match_jax():
    """The schedule's LR on each update: optax reads its own count before
    the increment, the port's one Adam count after it."""
    kw = dict(SMALL, lr_schedule="cosine", warmup_steps=2, steps=6)
    jm, m, jstate, state = _run_both(3, **kw)
    for step in range(3):
        _assert_metrics_close(m[step], jm[step], ("d_loss", "g_adv", "g_ndiv"))
    _assert_state_close(jstate, state, 3)
    assert int(jstate.g_opt_state[1].count) == state.g_opt.count == 3
    # The first update took LR 0: the warmup starts from 0.
    assert _lrs_taken(state.g_opt)[0] == 0.0 < _lrs_taken(state.g_opt)[1]
