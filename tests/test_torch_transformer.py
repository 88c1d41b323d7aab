"""The transformer generator family (``g_arch="transformer"``) in the torch port against the JAX package.

The module from converted weights in float32 and bf16, a train step (the
JAX draws injected), a 64-candidate plan on JAX's latents, the frozen
suite, a checkpoint round trip and the CLI from ``train`` to ``plan``,
with LeCam (and, in the last two, spectral norm) set on D.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndivplanning_tpu.envs.types import Scene as JaxScene
from ndivplanning_tpu.planning.planner import plan as jax_plan
from ndivplanning_tpu.train.state import build_models as jax_build_models
from ndivplanning_tpu.train.state import create_train_state as jax_create
from ndivplanning_tpu.utils.config import get_config as jax_get_config
from ndivplanning_tpu_torch.cli import _load_state, main
from ndivplanning_tpu_torch.envs.types import Scene
from ndivplanning_tpu_torch.models.transformer import TrajectoryTransformer
from ndivplanning_tpu_torch.planning.planner import plan
from ndivplanning_tpu_torch.train.evaluate import evaluate_fixed
from ndivplanning_tpu_torch.train.state import build_models, create_train_state
from ndivplanning_tpu_torch.train.step import train_step_fused
from ndivplanning_tpu_torch.utils import checkpoint
from ndivplanning_tpu_torch.utils.config import get_config, load_config
from ndivplanning_tpu_torch.utils.convert import (
    params_from_flax,
    train_state_from_flax,
)
from tests.test_torch_stabilisers import _tree, run_both
from tests.test_torch_train_step import (
    GRAD_SCALE_TOL,
    PARAM_TOL,
    _assert_metrics_close,
    _lrs_taken,
    _np,
)

# Narrow, at the family's full depth and heads: dim 32, 2 blocks, 4 heads.
SMALL = dict(batch_size=8, k=4, g_tf_dim=32, d_hidden=(32, 32),
             g_arch="transformer")
BF16_ULP = 2.0 ** -8
# bf16: two packages' bf16 sums may round an ulp apart at each of the ~12
# roundings of two attention blocks (measured 2.4 ulps of the largest
# output), so the outputs are held at 4 ulps of their largest.
BF16_TOL = 4 * BF16_ULP
# The tuned transformer recipe (benchmarks/convergence_tf_lr0.0001_s*.json),
# its warmup cut to the test's steps.
RECIPE = dict(lr_schedule="cosine", compute_dtype="bf16", warmup_steps=2,
              g_lr=1e-4, steps=10)


def _models(preset, **kw):
    jcfg = jax_get_config(preset, **SMALL, **kw)
    jstate = jax_create(jcfg, seed=1)
    g, d = build_models(get_config(preset, **SMALL, **kw))
    g.load_state_dict(params_from_flax(_np(jstate.g_params)))
    d.load_state_dict(params_from_flax(_np(jstate.d_params)))
    return jcfg, jstate, g, d


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_transformer_generator_matches_flax(dtype):
    """G's trajectories on converted weights: float32 within 1e-5 of the
    largest, bf16 within BF16_TOL."""
    jcfg, jstate, g, _ = _models("goalcond", compute_dtype=dtype)
    assert isinstance(g.generator, TrajectoryTransformer)
    rng = np.random.default_rng(0)
    cond = rng.uniform(0, 1, (6, 4)).astype(np.float32)
    z = rng.normal(size=(6, 4, 2)).astype(np.float32)
    jg, _ = jax_build_models(jcfg)
    tau = np.asarray(jax.jit(jg.apply)(jstate.g_params, jnp.asarray(cond),
                                       jnp.asarray(z)))
    with torch.no_grad():
        got = g(torch.tensor(cond), torch.tensor(z))
    assert got.dtype == torch.float32 and got.shape == (6, 4, 32, 2)
    tol = 1e-5 if dtype == "f32" else BF16_TOL
    np.testing.assert_allclose(got.numpy(), tau, rtol=tol,
                               atol=tol * np.abs(tau).max())


def _assert_transformer_step_close(jstate, state):
    """``_assert_state_close`` after one step, with two differences.
    Attention's key biases have an exactly-zero gradient (a shift of every
    logit of a softmax row changes nothing), so both packages' moments
    there are rounding noise (~1e-10 against ~1e-3) and are held below
    1e-6 of G's largest first moment instead of against each other.  And
    at init the attention is near uniform, so its query and key weights'
    gradients reach down to Adam's eps (1e-8), where the normalised step
    ``g / (|g| + eps)`` is steep: an element's step must match only where
    its gradient is also above 100 eps (first moment 1e-7)."""
    bound = 2.0 * max(_lrs_taken(state.g_opt) + _lrs_taken(state.d_opt)) \
        + 1e-6
    jmu = params_from_flax(_np(jstate.g_opt_state[0].mu))
    top = max(float(np.abs(v.numpy()).max()) for v in jmu.values())
    for tree, module, opt in ((jstate.g_params, state.g, state.g_opt),
                              (jstate.g_ema_params, state.g_ema, state.g_opt)):
        want = params_from_flax(_np(tree))
        for name, value in module.state_dict().items():
            got, ref = value.numpy(), want[name].numpy()
            diff = np.abs(got - ref)
            assert diff.max() <= bound, (name, diff.max())
            mu = jmu[name].numpy()
            if name.endswith("attn.key.bias"):
                for moment in (mu, opt.mu[name].numpy()):
                    assert np.abs(moment).max() < 1e-6 * top, name
                continue
            scale = np.abs(mu).max()
            np.testing.assert_allclose(opt.mu[name].numpy(), mu, rtol=1e-4,
                                       atol=GRAD_SCALE_TOL * scale,
                                       err_msg=name)
            off = diff > PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(ref)
            resolved = np.abs(mu) > max(1e-2 * scale, 1e-7)
            assert not np.any(off & resolved), name


def test_transformer_step_matches_jax():
    """One float32 step with LeCam on D: metrics, trackers, D at the train
    step's tolerances, G as ``_assert_transformer_step_close``."""
    jm, m, jstate, state = run_both("goalcond", 1, g_arch="transformer",
                                    g_tf_dim=32, lecam_weight=0.1)
    assert set(m[0]) == set(jm[0])
    _assert_metrics_close(m[0], jm[0], m[0].keys())
    _assert_transformer_step_close(jstate, state)
    d_want = params_from_flax(_np(jstate.d_params))
    d_mu = params_from_flax(_np(jstate.d_opt_state[0].mu))
    for name, value in state.d.state_dict().items():
        np.testing.assert_allclose(value.numpy(), d_want[name].numpy(),
                                   **PARAM_TOL, err_msg=name)
        np.testing.assert_allclose(
            state.d_opt.mu[name].numpy(), d_mu[name].numpy(), rtol=1e-4,
            atol=GRAD_SCALE_TOL * np.abs(d_mu[name].numpy()).max(),
            err_msg=name)
    for key, value in jstate.lecam_ema.items():
        np.testing.assert_allclose(float(state.lecam_ema[key]), float(value),
                                   rtol=1e-4, atol=1e-6)


def test_tuned_transformer_recipe_step_in_bf16_matches_jax():
    """The tuned recipe in bf16: two steps' metrics within four bf16 ulps
    of JAX's (as the pod_dp bf16 step, tests/test_torch_bf16.py)."""
    jm, m, _, state = run_both("goalcond", 2, g_arch="transformer",
                               g_tf_dim=32, **RECIPE)
    for step in range(2):
        assert set(m[step]) == set(jm[step])
        if "g_lr" in jm[step]:
            np.testing.assert_allclose(m[step]["g_lr"], jm[step]["g_lr"],
                                       rtol=1e-6)
        for key in m[step]:
            np.testing.assert_allclose(m[step][key], jm[step][key],
                                       rtol=4 * BF16_ULP, atol=1e-6,
                                       err_msg=key)
    assert all(p.dtype == torch.float32 for p in state.g.parameters())


def test_transformer_plans_as_jax():
    """A 64-candidate plan of a converted transformer G on JAX's latents:
    candidates within 1e-5, scores at 1e-4, the same best pick."""
    jcfg = jax_get_config("goalcond", **SMALL)
    jstate = jax_create(jcfg, seed=3)
    cfg = get_config("goalcond", **SMALL)
    state = train_state_from_flax(cfg, _tree(jstate), device="cpu")
    obstacles = [[0.5, 0.5, 0.12], [0.35, 0.65, 0.08]]
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
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-4, atol=1e-4)
    assert int(torch.argmin(got.scores)) == int(np.argmin(want.scores))


def test_transformer_frozen_suite_and_checkpoint_round_trip(tmp_path):
    """Two steps, a bitwise save and restore (the LeCam trackers too), and
    the frozen suite on both states: the same metrics."""
    cfg = get_config("goalcond", **SMALL, lecam_weight=0.1,
                     d_spectral_norm=True)
    state = create_train_state(cfg, seed=0, device="cpu")
    for _ in range(2):
        state, _ = train_step_fused(cfg, state)
    assert float(state.lecam_ema["fake"]) != 0.0
    checkpoint.save_checkpoint(str(tmp_path), state)
    restored = checkpoint.restore_latest(
        str(tmp_path), create_train_state(cfg, seed=5, device="cpu"))
    saved, back = checkpoint.state_dict(state), checkpoint.state_dict(restored)
    for key in ("g", "d", "g_ema", "lecam_ema", "ada"):
        assert saved[key].keys() == back[key].keys()
        assert all(torch.equal(saved[key][n], back[key][n])
                   for n in saved[key])
    want = evaluate_fixed(cfg, state, n_scenes=16)
    got = evaluate_fixed(cfg, restored, n_scenes=16)
    assert want.keys() == got.keys()
    assert all(torch.equal(want[k], got[k]) for k in want)
    assert all(bool(torch.isfinite(v)) for v in got.values())


def test_cli_trains_evaluates_and_plans_a_transformer(tmp_path, capsys):
    """``train --set g_arch=transformer`` with stabiliser knobs, then
    ``eval`` and ``plan`` through the CLI's one loader."""
    run = str(tmp_path / "run")
    sets = ["g_arch=transformer", "g_tf_dim=32", "d_hidden=32",
            "d_spectral_norm=true", "lecam_weight=0.1", "diffaug=shift",
            "ada_target=0.6", "log_every=3", "eval_every=6",
            "checkpoint_every=6", "eval_suite_scenes=16", "n_candidates=32"]
    argv = ["train", "--preset", "goalcond", "--batch-size", "8", "--k", "4",
            "--steps", "6", "--workdir", run, "--device", "cpu"]
    for kv in sets:
        argv += ["--set", kv]
    assert main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["final_step"] == 6 and "ada_p" in out["last"]
    cfg = load_config(run)
    assert (cfg.g_arch, cfg.d_spectral_norm, cfg.lecam_weight) == (
        "transformer", True, 0.1)
    state = _load_state(cfg.replace(workdir=run), "cpu", prefer_best=False)
    assert state.step == 6 and float(state.lecam_ema["real"]) != 0.0
    assert main(["eval", "--workdir", run, "--device", "cpu",
                 "--suite-size", "16"]) == 0
    assert 0.0 <= json.loads(capsys.readouterr().out)["eval_success_rate"]
    assert main(["plan", "--workdir", run, "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["n_candidates"] == 32
    assert os.path.exists(os.path.join(run, "best", "best_path.json"))
