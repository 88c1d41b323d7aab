"""The port's deployment export (``utils/export.py``) on the CPU: the
ported cases of ``tests/test_export.py`` at its small config.  Each
loaded ``.pt2`` program is bitwise the port's eager planner on the same
draws, at batches 1 and 3 from one artifact; the manifest's budgets are
the JAX package's ``export_bundle`` manifest's for the same config; an
artifact refuses another device.  The iLQR planner is not exported yet:
its export raises, the manifest says so, and the torch error that blocks
it is reproduced."""

import json

import numpy as np
import pytest
import torch

from ndivplanning_tpu.train.state import create_train_state as jax_create
from ndivplanning_tpu.utils.config import get_config as jax_get_config
from ndivplanning_tpu.utils.export import export_bundle as jax_export_bundle
from ndivplanning_tpu_torch.data.scenes import random_scene_batch
from ndivplanning_tpu_torch.planning.cem import plan_cem_batch
from ndivplanning_tpu_torch.planning.mpc import mpc_rollout_batch
from ndivplanning_tpu_torch.planning.planner import plan_batch
from ndivplanning_tpu_torch.planning.server import _condition_for
from ndivplanning_tpu_torch.planning.trajopt import plan_trajopt_batch
from ndivplanning_tpu_torch.train.state import create_train_state, gen_params
from ndivplanning_tpu_torch.utils.config import get_config
from ndivplanning_tpu_torch.utils.export import (
    CEM_PLANNER_FILE,
    GENERATOR_FILE,
    MANIFEST_FILE,
    MPC_CONTROLLER_FILE,
    PLANNER_FILE,
    TRAJOPT_PLANNER_FILE,
    draw_noise,
    export_bundle,
    export_generator,
    export_ilqr_planner,
    export_planner,
    load_exported,
)

SMALL = dict(batch_size=8, k=4, g_hidden=(32,), d_hidden=(32,),
             cond_embed_dim=8, image_size=16, n_candidates=32,
             trajopt_steps=3, ilqr_iters=2)
MPC = dict(mpc_total_steps=8, mpc_replan_every=4, mpc_candidates=8)
BATCHES = (1, 3)


def _small(preset="goalcond", **kw):
    return get_config(preset, **{**SMALL, **kw})


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """The goalcond bundle of one random state, n_diverse 4."""
    cfg = _small()
    state = create_train_state(cfg, device="cpu")
    out = tmp_path_factory.mktemp("bundle")
    manifest = export_bundle(cfg, state, str(out), n_diverse=4, **MPC)
    return cfg, state, out, manifest


def _scenes(cfg, b, seed):
    scenes = random_scene_batch(torch.Generator().manual_seed(seed), b)
    return scenes, _condition_for(cfg, scenes), torch.arange(b) + seed


def _raw(scenes):
    return (scenes.start, scenes.goal, scenes.obstacles,
            scenes.obstacle_mask)


def _assert_bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


def test_generator_export_roundtrip(bundle):
    cfg, state, out, manifest = bundle
    for name in manifest["artifacts"]:
        assert (out / manifest[name]["file"]).exists()
    assert manifest["device"] == "cpu"
    assert (json.loads((out / MANIFEST_FILE).read_text())
            == json.loads(json.dumps(manifest)))
    g = load_exported(str(out / GENERATOR_FILE))
    for b, n in [(3, 5), (1, 4)]:  # symbolic batch and sample axes
        gen = torch.Generator().manual_seed(b * 10 + n)
        cond = torch.rand((b, 4), generator=gen)
        z = torch.randn((b, n, cfg.latent_dim), generator=gen)
        with torch.no_grad():
            want = gen_params(cfg, state)(cond, z)
        assert torch.equal(g(cond, z), want)


def test_planner_export_matches_live_plan(bundle):
    cfg, state, out, _ = bundle
    p = load_exported(str(out / PLANNER_FILE))
    assert p.noise_shape == (cfg.n_candidates, cfg.latent_dim)
    for b in BATCHES:
        scenes, conds, seeds = _scenes(cfg, b, 7)
        got = p(conds, *_raw(scenes), seeds)
        r = plan_batch(cfg, state, scenes, conds, n_diverse=4,
                       z=draw_noise(seeds, p.noise_shape, "cpu"))
        _assert_bitwise(got, (r.best_traj, r.best_score, r.best_reached,
                              r.diverse_trajs))
        assert got[0].shape == (b, cfg.horizon, cfg.state_dim)
        assert got[3].shape[:2] == (b, 4)


def test_export_cli(tmp_path):
    from ndivplanning_tpu_torch.cli import main

    out_dir = tmp_path / "bundle"
    rc = main(["export", "--preset", "pointmass2d", "--batch-size", "8",
               "--k", "4", "--set", "g_hidden=32", "--set", "d_hidden=32",
               "--set", "n_candidates=16", "--set", "trajopt_steps=1",
               "--workdir", str(tmp_path / "run"), "--out", str(out_dir),
               "--device", "cpu"])
    assert rc == 0
    assert (out_dir / MANIFEST_FILE).exists()


def test_cem_export_matches_live_plan_cem(bundle):
    cfg, state, out, manifest = bundle
    p = load_exported(str(out / CEM_PLANNER_FILE))
    n = manifest["cem_planner"]["population"]
    assert p.noise_shape == (cfg.cem_iters + 1, n, cfg.latent_dim)
    for b in BATCHES:
        scenes, conds, seeds = _scenes(cfg, b, 21)
        got = p(conds, *_raw(scenes), seeds)
        r, curve = plan_cem_batch(cfg, state, scenes, conds, n_diverse=4,
                                  eps=draw_noise(seeds, p.noise_shape, "cpu"))
        _assert_bitwise(got, (r.best_traj, r.best_score, r.best_reached,
                              r.diverse_trajs, curve))
        c = got[4].numpy()
        assert c.shape == (b, cfg.cem_iters)
        assert np.all(c[:, 1:] <= c[:, :-1])  # non-increasing


def test_trajopt_export_matches_live_plan_trajopt(bundle):
    cfg, state, out, manifest = bundle
    p = load_exported(str(out / TRAJOPT_PLANNER_FILE))
    assert manifest["trajopt_planner"]["adam_steps"] == 3
    for b in BATCHES:
        scenes, conds, seeds = _scenes(cfg, b, 7)
        got = p(conds, *_raw(scenes), seeds)
        r, curve = plan_trajopt_batch(
            cfg, state, scenes, conds, n_diverse=4,
            z=draw_noise(seeds, p.noise_shape, "cpu"))
        _assert_bitwise(got, (r.best_traj, r.best_score, r.best_reached,
                              r.diverse_trajs, curve))
        assert got[4].shape == (b, 3)


def test_ilqr_export_raises_and_the_manifest_says_so(bundle, tmp_path):
    cfg, state, out, manifest = bundle
    with pytest.raises(NotImplementedError, match="iLQR planner is not"):
        export_ilqr_planner(cfg, state, str(tmp_path / "ilqr.pt2"))
    entry = manifest["ilqr_planner"]
    assert entry["exported"] is False and entry["file"] is None
    assert "ilqr_planner" not in manifest["artifacts"]
    assert not list(out.glob("ilqr*"))


def test_ilqr_jacobians_still_refuse_a_symbolic_batch():
    """The iLQR artifact's blocker, reproduced: the port's forward-mode
    Jacobians (``planning/ilqr.py::_jacfwd``, ``vmap`` of ``jvp``) run
    eagerly but do not export with a symbolic batch in this torch.  Once
    this export goes through, ``export_ilqr_planner`` can be written."""
    from torch.func import vmap

    from ndivplanning_tpu_torch.planning.ilqr import _jacfwd

    def step(x, u):
        return torch.sin(x) * u.sum(-1, keepdim=True) + torch.sqrt(x * x + 1)

    class Jacobians(torch.nn.Module):
        def forward(self, x, u):
            (a, b), _ = vmap(_jacfwd(step, 2))(x, u)
            return a, b

    x, u = torch.randn(7, 4), torch.randn(7, 2)
    a, b = Jacobians()(x, u)
    assert a.shape == (7, 4, 4) and b.shape == (7, 4, 2)
    batch = torch.export.Dim("b", min=1, max=1 << 16)
    with pytest.raises(Exception):
        torch.export.export(Jacobians(), (x, u),
                            dynamic_shapes=({0: batch}, {0: batch}),
                            strict=False)


def test_manifest_budgets_equal_jax(bundle, tmp_path):
    """The budgets baked in, key by key, against JAX's manifest of the
    same config (JAX's bundle holds the iLQR artifact too)."""
    cfg, _, _, manifest = bundle
    jcfg = jax_get_config("goalcond", **SMALL)
    jax_manifest = jax_export_bundle(jcfg, jax_create(jcfg), str(tmp_path),
                                     n_diverse=4, **MPC)
    shared = set(jax_manifest) - {"platforms"}
    assert shared <= set(manifest)
    for name in ("generator", "planner", "cem_planner", "trajopt_planner",
                 "ilqr_planner", "mpc_controller"):
        keys = set(jax_manifest[name]) - {"file", "bytes"}
        assert keys <= set(manifest[name]), name
        assert ({k: manifest[name][k] for k in keys}
                == {k: jax_manifest[name][k] for k in keys}), name
    assert manifest["step"] == int(jax_manifest["step"]) == 0
    assert (json.loads(json.dumps(manifest["config"]))
            == json.loads(json.dumps(jax_manifest["config"])))


def test_generator_export_transformer_family(tmp_path):
    cfg = _small(g_arch="transformer", g_tf_dim=32, g_tf_layers=1,
                 g_tf_heads=2)
    state = create_train_state(cfg, device="cpu")
    export_generator(cfg, state, str(tmp_path / GENERATOR_FILE))
    g = load_exported(str(tmp_path / GENERATOR_FILE))
    for b, n in [(2, 3), (1, 5)]:
        gen = torch.Generator().manual_seed(b * 7 + n)
        cond = torch.rand((b, 4), generator=gen)
        z = torch.randn((b, n, cfg.latent_dim), generator=gen)
        with torch.no_grad():
            want = gen_params(cfg, state)(cond, z)
        assert torch.equal(g(cond, z), want)


def test_mpc_export_matches_live_rollout_batch(bundle):
    cfg, state, out, manifest = bundle
    m = load_exported(str(out / MPC_CONTROLLER_FILE))
    assert m.noise_shape == (2, 8, cfg.latent_dim)
    for b in BATCHES:
        scenes, conds, seeds = _scenes(cfg, b, 3)
        got = m(conds, *_raw(scenes), seeds)
        r = mpc_rollout_batch(cfg, state, scenes, conds, total_steps=8,
                              replan_every=4, n_candidates=8,
                              z=draw_noise(seeds, m.noise_shape, "cpu"))
        _assert_bitwise(got, (r.positions, r.reached, r.collided))
        assert got[0].shape == (b, 8, 2)


@pytest.mark.parametrize("env", ["unicycle", "reacher", "quadrotor"])
def test_planner_export_is_env_family_agnostic(env, tmp_path):
    cfg = _small(env=env)
    state = create_train_state(cfg, device="cpu")
    export_planner(cfg, state, str(tmp_path / PLANNER_FILE), n_diverse=4)
    p = load_exported(str(tmp_path / PLANNER_FILE))
    for b in BATCHES:
        scenes, conds, seeds = _scenes(cfg, b, 11)
        r = plan_batch(cfg, state, scenes, conds, n_diverse=4,
                       z=draw_noise(seeds, p.noise_shape, "cpu"))
        _assert_bitwise(p(conds, *_raw(scenes), seeds),
                        (r.best_traj, r.best_score, r.best_reached,
                         r.diverse_trajs))


def test_an_artifact_refuses_another_device(bundle):
    cfg, _, out, _ = bundle
    with pytest.raises(ValueError, match="exported for device cpu, not the "
                                         "requested cuda"):
        load_exported(str(out / PLANNER_FILE), device="cuda")
    p = load_exported(str(out / PLANNER_FILE), device="cpu")
    scenes, conds, seeds = _scenes(cfg, 1, 5)
    with pytest.raises(ValueError, match="not the inputs' meta"):
        p(conds.to("meta"), *_raw(scenes), seeds)
    g = load_exported(str(out / GENERATOR_FILE))
    with pytest.raises(ValueError, match="not the inputs' meta"):
        g(torch.zeros((1, 4), device="meta"),
          torch.zeros((1, 2, cfg.latent_dim), device="meta"))
