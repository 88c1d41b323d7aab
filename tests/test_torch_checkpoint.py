"""Torch checkpoints, and the vendored planning model through the port, on the CPU.

``checkpoints_torch/planning512`` is ``convert_jax_checkpoint.py``'s form
of the JAX package's ``checkpoints/planning512`` (the deployable
image-conditioned planning model, trained under a cosine LR schedule).
Re-converting the JAX checkpoint here must give it bitwise; the port
restores it with torch alone (``cli._load_state``), and its EMA G's
outputs and a 64-candidate plan are held against the JAX package's.  The
same holds for the env families' ``unicycle150k``, ``reacher150k`` and
``quadrotor150k`` (their frozen suites: ``tests/test_torch_evaluate.py``).
"""

import dataclasses
import functools
import os
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convert_jax_checkpoint import convert
from ndivplanning_tpu.data.scenes import rasterize_batch as jax_rasterize
from ndivplanning_tpu.data.scenes import rasterize_scene as jax_rasterize_one
from ndivplanning_tpu.envs.types import Scene as JaxScene
from ndivplanning_tpu.planning.planner import plan as jax_plan
from ndivplanning_tpu.train.state import build_models as jax_build_models
from ndivplanning_tpu.train.state import create_train_state as jax_create
from ndivplanning_tpu.utils import checkpoint as ckpt
from ndivplanning_tpu.utils.config import load_config as jax_load_config
from ndivplanning_tpu_torch.cli import _load_state
from ndivplanning_tpu_torch.data.scenes import (
    rasterize_batch,
    rasterize_scene,
)
from ndivplanning_tpu_torch.envs.types import Scene
from ndivplanning_tpu_torch.planning.planner import plan
from ndivplanning_tpu_torch.train.state import create_train_state
from ndivplanning_tpu_torch.train.step import train_step_fused
from ndivplanning_tpu_torch.utils import checkpoint
from ndivplanning_tpu_torch.utils.config import get_config, load_config
from ndivplanning_tpu_torch.utils.convert import train_state_from_flax
from test_torch_scenes import shared_scenes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKDIR = os.path.join(REPO, "checkpoints", "planning512")
TORCH_WORKDIR = os.path.join(REPO, "checkpoints_torch", "planning512")
STEP = 55000


@functools.lru_cache(maxsize=1)
def jax_planning512():
    """(JAX config, the JAX package's restore of planning512's best)."""
    jcfg = jax_load_config(WORKDIR)
    best = ckpt.restore_latest(os.path.join(WORKDIR, "best"), jax_create(jcfg))
    assert best is not None and int(best.step) == STEP
    return jcfg, best


def torch_planning512(**overrides):
    """(the port's config, the committed torch planning512 restored on the
    CPU by the CLI's loader)."""
    cfg = load_config(TORCH_WORKDIR).replace(workdir=TORCH_WORKDIR,
                                              **overrides)
    return cfg, _load_state(cfg, "cpu")


@pytest.fixture(scope="module")
def planning512():
    """(JAX config, restored JAX state, the port's config and state)."""
    jcfg, best = jax_planning512()
    cfg, state = torch_planning512()
    assert state.step == STEP
    assert cfg.lr_schedule == "cosine" and cfg.conditioning == "image"
    return jcfg, best, cfg, state


def test_vendored_generator_matches_jax_on_rasterised_scenes(planning512):
    jcfg, best, cfg, state = planning512
    _, scenes, jscenes = shared_scenes(512, 8)
    images = rasterize_batch(scenes, size=cfg.image_size)
    jimages = jax_rasterize(jscenes, size=cfg.image_size)
    z = np.random.default_rng(8).normal(size=(8, 8, 2)).astype(np.float32)
    jg, _ = jax_build_models(jcfg)
    want = np.asarray(jg.apply(best.g_ema_params, jimages, jnp.asarray(z)))
    with torch.no_grad():
        got = state.g_ema(images, torch.from_numpy(z))
    assert got.shape == (8, 8, 32, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # A trained generator: the 8 latents of a scene give distinct paths.
    assert float(got.std(dim=1).mean()) > 1e-3


def test_vendored_model_plans_as_jax(planning512):
    jcfg, best, cfg, state = planning512
    obstacles = [[0.5, 0.5, 0.12], [0.35, 0.65, 0.08], [0.65, 0.35, 0.1]]
    jscene = JaxScene.create(jnp.asarray([0.1, 0.1]), jnp.asarray([0.9, 0.9]),
                             jnp.asarray(obstacles))
    scene = Scene.create([0.1, 0.1], [0.9, 0.9], obstacles, device="cpu")
    key = jax.random.PRNGKey(3)
    jimage = jax_rasterize_one(jscene, size=cfg.image_size)
    image = rasterize_scene(scene, size=cfg.image_size)
    want = jax_plan(jcfg, best, jscene, jimage, key, n_candidates=64)
    z = np.asarray(jax.random.normal(key, (1, 64, cfg.latent_dim)))
    got = plan(cfg, state, scene, image, n_candidates=64, z=torch.tensor(z))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.diverse_idx.numpy(),
                                  np.asarray(want.diverse_idx))
    assert int(torch.argmin(got.scores)) == int(np.argmin(want.scores))
    assert float(got.best_reached) == float(want.best_reached) == 1.0


def _flat(saved, prefix=""):
    """A checkpoint's contents as {path: tensor or int or str}."""
    out = {}
    for key, value in saved.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = value
    return out


def _assert_same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, torch.Tensor):
            assert got[key].dtype == value.dtype, key
            assert torch.equal(got[key], value), key
        else:
            assert got[key] == value, key


def _assert_reconversion_bitwise(tmp_path, src, committed, step):
    """``convert_jax_checkpoint.py`` of ``src`` again: the same step, the
    same config.json and best_path.json bytes, and a state.pt that
    ``torch.load(weights_only=True)`` alone reads as the committed one."""
    assert convert(src, str(tmp_path)) == step
    for sub in ("config.json", os.path.join("best", "best_path.json")):
        with open(tmp_path / sub, "rb") as f, \
                open(os.path.join(committed, sub), "rb") as g:
            assert f.read() == g.read(), sub
    load = functools.partial(torch.load, weights_only=True)
    rel = os.path.join("best", "checkpoints", str(step), checkpoint.FILENAME)
    _assert_same(_flat(load(tmp_path / rel)),
                 _flat(load(os.path.join(committed, rel))))


def test_committed_artifact_is_the_reconversion_bitwise(tmp_path):
    _assert_reconversion_bitwise(tmp_path, WORKDIR, TORCH_WORKDIR, STEP)


# The vendored env-family models (tests/test_vendored_checkpoint.py): the
# best step of each, and its family.
FAMILY_STEPS = {"unicycle150k": (120000, "unicycle"),
                "reacher150k": (105000, "reacher"),
                "quadrotor150k": (30000, "quadrotor")}


@pytest.mark.parametrize("name", sorted(FAMILY_STEPS))
def test_family_artifact_is_the_reconversion_bitwise(tmp_path, name):
    step, env = FAMILY_STEPS[name]
    committed = os.path.join(REPO, "checkpoints_torch", name)
    _assert_reconversion_bitwise(tmp_path, os.path.join(REPO, "checkpoints",
                                                        name), committed, step)
    cfg = load_config(committed).replace(workdir=committed)
    assert (cfg.env, cfg.conditioning, cfg.rollout_mode) == (
        env, "startgoal", "waypoints")
    assert (cfg.g_hidden, cfg.d_hidden, cfg.cond_embed_dim) == (
        (256, 256), (256, 256), 64)
    state = _load_state(cfg, "cpu")
    assert state.step == state.g_opt.count == step


# The three distilled models (expert iteration on quadrotor150k and a
# unicycle run): their best step and family.  Their configs set no knob
# the port lacks (g_arch mlp, ada_target 0, d_reset_every 0).
DISTILLED_STEPS = {"quadrotor_distilled": (504, "quadrotor"),
                   "quadrotor_distilled_ilqr": (1512, "quadrotor"),
                   "unicycle_distilled": (4536, "unicycle")}


@pytest.mark.parametrize("name", sorted(DISTILLED_STEPS))
def test_distilled_artifact_is_the_reconversion_bitwise(tmp_path, name):
    step, env = DISTILLED_STEPS[name]
    committed = os.path.join(REPO, "checkpoints_torch", name)
    _assert_reconversion_bitwise(tmp_path, os.path.join(REPO, "checkpoints",
                                                        name), committed, step)
    cfg = load_config(committed).replace(workdir=committed)
    assert (cfg.env, cfg.conditioning, cfg.rollout_mode, cfg.g_arch) == (
        env, "startgoal", "waypoints", "mlp")
    assert (cfg.ada_target, cfg.d_reset_every, cfg.g_ema_decay) == (
        0.0, 0, 0.999)
    state = _load_state(cfg, "cpu")
    assert state.step == state.g_opt.count == step


@pytest.mark.parametrize("name", sorted(DISTILLED_STEPS))
def test_distilled_generator_plans_as_jax(name):
    """The restored EMA G on JAX's 64 latents of a three-obstacle scene:
    candidates within 1e-5 of the JAX checkpoint's.  The unicycle's plan
    scores at rtol/atol 1e-4 with the same best pick; the quadrotor's
    32-step rollouts agree in aggregate (tests/test_torch_envs.py): 80%
    of the scores within 1e-4, the mean within 1%."""
    step, env = DISTILLED_STEPS[name]
    src = os.path.join(REPO, "checkpoints", name)
    jcfg = jax_load_config(src)
    jstate = ckpt.restore_latest(os.path.join(src, "best"), jax_create(jcfg))
    assert int(jstate.step) == step
    committed = os.path.join(REPO, "checkpoints_torch", name)
    cfg = load_config(committed).replace(workdir=committed)
    state = _load_state(cfg, "cpu")
    obstacles = [[0.5, 0.5, 0.12], [0.35, 0.65, 0.08], [0.65, 0.35, 0.1]]
    jscene = JaxScene.create(jnp.asarray([0.1, 0.1]), jnp.asarray([0.9, 0.9]),
                             jnp.asarray(obstacles))
    scene = Scene.create([0.1, 0.1], [0.9, 0.9], obstacles, device="cpu")
    condition = np.asarray([0.1, 0.1, 0.9, 0.9], np.float32)
    key = jax.random.PRNGKey(5)
    want = jax_plan(jcfg, jstate, jscene, jnp.asarray(condition), key,
                    n_candidates=64)
    z = np.asarray(jax.random.normal(key, (1, 64, cfg.latent_dim)))
    got = plan(cfg, state, scene, torch.from_numpy(condition),
               n_candidates=64, z=torch.tensor(z))
    np.testing.assert_allclose(got.taus.numpy(), np.asarray(want.taus),
                               rtol=1e-5, atol=1e-5)
    scores, wscores = got.scores.numpy(), np.asarray(want.scores)
    if env == "unicycle":
        np.testing.assert_allclose(scores, wscores, rtol=1e-4, atol=1e-4)
        assert int(np.argmin(scores)) == int(np.argmin(wscores))
    else:
        close = np.abs(scores - wscores) <= 1e-4 + 1e-4 * np.abs(wscores)
        assert close.mean() >= 0.8
        np.testing.assert_allclose(scores.mean(), wscores.mean(), rtol=1e-2)


def test_artifact_carries_the_whole_jax_state(planning512):
    """G, D, EMA G, both Adam chains (count, mu, nu) and the step."""
    jcfg, best, cfg, state = planning512
    tree = jax.tree.map(np.asarray, {
        "step": best.step, "g_params": best.g_params,
        "d_params": best.d_params, "g_ema_params": best.g_ema_params,
        "ada": best.ada, "g_adam": best.g_opt_state,
        "d_adam": best.d_opt_state})
    want = train_state_from_flax(cfg, tree, device="cpu")
    assert state.g_opt.count == state.d_opt.count == STEP
    saved, ref = checkpoint.state_dict(state), checkpoint.state_dict(want)
    del saved["rng"], ref["rng"]
    _assert_same(_flat(saved), _flat(ref))
    # The cosine schedule was rebuilt: 55000 of 150000 steps in.
    assert 0.0 < state.g_opt.lr(STEP) < cfg.g_lr


def test_converter_rejects_disagreeing_adam_and_schedule_counts():
    from ndivplanning_tpu_torch.utils.convert import _adam_fields

    adam = namedtuple("ScaleByAdamState", "count mu nu")(np.int32(3), {}, {})
    sched = namedtuple("ScaleByScheduleState", "count")
    assert _adam_fields((adam, sched(np.int32(3))))[0] == 3
    with pytest.raises(ValueError, match="disagrees"):
        _adam_fields((adam, sched(np.int32(2))))


def _trained_state(seed=0):
    cfg = get_config("goalcond", batch_size=8, k=4, horizon=8,
                     g_hidden=(16,), d_hidden=(16,), lr_schedule="cosine",
                     warmup_steps=1, steps=10)
    state = create_train_state(cfg, seed=seed, device="cpu")
    for _ in range(2):
        state, _ = train_step_fused(cfg, state)
    return cfg, state


def test_save_restore_round_trip_is_bitwise(tmp_path):
    cfg, state = _trained_state()
    checkpoint.save_checkpoint(str(tmp_path), state)
    fresh = create_train_state(cfg, seed=5, device="cpu")
    restored = checkpoint.restore_latest(str(tmp_path), fresh)
    assert restored is fresh and restored.step == 2
    _assert_same(_flat(checkpoint.state_dict(restored)),
                 _flat(checkpoint.state_dict(state)))
    assert restored.g_opt.count == restored.d_opt.count == 2
    # The restored run draws what the saved one would have drawn next.
    assert torch.equal(torch.rand(4, generator=restored.rng),
                       torch.rand(4, generator=state.rng))
    # And takes the same next step.
    train_step_fused(cfg, state)
    train_step_fused(cfg, restored)
    for a, b in zip(state.g.parameters(), restored.g.parameters()):
        assert torch.equal(a, b)


def test_three_checkpoints_are_kept(tmp_path):
    _, state = _trained_state()
    for step in (10, 20, 30, 40, 50):
        checkpoint.save_checkpoint(str(tmp_path), state, step=step)
    assert checkpoint.all_steps(str(tmp_path)) == [30, 40, 50]
    assert checkpoint.latest_step(str(tmp_path)) == 50
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["30", "40", "50"]


def test_empty_workdir_restores_none(tmp_path):
    cfg, state = _trained_state()
    assert checkpoint.restore_latest(str(tmp_path), state) is None
    assert checkpoint.latest_step(str(tmp_path)) is None
    assert state.step == 2


def test_cli_loader_prefers_best(tmp_path, capsys):
    cfg, state = _trained_state()
    cfg = cfg.replace(workdir=str(tmp_path))
    state.step = 7
    checkpoint.save_checkpoint(str(tmp_path), state)
    state.step = 3
    checkpoint.save_checkpoint(str(tmp_path / "best"), state)
    assert _load_state(cfg, "cpu").step == 3
    assert _load_state(cfg, "cpu", prefer_best=False).step == 7
    assert "UNTRAINED" not in capsys.readouterr().err
    assert _load_state(cfg.replace(workdir=str(tmp_path / "none")),
                       "cpu").step == 0
    assert "UNTRAINED" in capsys.readouterr().err
