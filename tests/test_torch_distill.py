"""The port's expert iteration (``train/distill.py``) on the CPU.

The ported behaviours of ``tests/test_distill.py``: the recording schema,
the open-loop filter, the action-mode bridge, the fine-tune's re-based
state, resume and the accept/reject rules, at small width.  Parity with
the JAX package on the same numpy inputs: the waypoint grid bitwise, the
open-loop check and the distilled actions for a kinematic family and for
arm3 in action mode, and the npz schema of a recording.  What the port
adds: its step updates in place, so a round, rejected or accepted, leaves
the caller's state bitwise as it was.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndivplanning_tpu.data.scenes import random_scene_batch as jax_scenes
from ndivplanning_tpu.train import distill as jax_distill
from ndivplanning_tpu.train.state import create_train_state as jax_create
from ndivplanning_tpu.utils.config import get_config as jax_get_config
from ndivplanning_tpu_torch.data.host_pipeline import (
    RECORD_KEYS,
    ArrayDataset,
    scenes_from_arrays,
)
from ndivplanning_tpu_torch.envs.types import Scene
from ndivplanning_tpu_torch.train import distill as distill_mod
from ndivplanning_tpu_torch.train.distill import (
    RECORD_SEED,
    _distill_actions_batch,
    _subsample_to_horizon,
    _verify_open_loop,
    expert_iteration,
    record_planner_dataset,
    reset_for_finetune,
)
from ndivplanning_tpu_torch.train.loop import _improved, train_from_dataset
from ndivplanning_tpu_torch.train.state import create_train_state
from ndivplanning_tpu_torch.utils import checkpoint as ckpt
from ndivplanning_tpu_torch.utils.config import get_config
from tests.test_torch_action_mode import (
    ARM3_ACTIONS,
    DISTILL_ATOL,
    DISTILL_RTOL,
)

SMALL = dict(batch_size=8, k=4, g_hidden=(32,), d_hidden=(32,),
             cond_embed_dim=8, horizon=16, eval_suite_scenes=16,
             eval_every=8, log_every=8, checkpoint_every=0, workdir="")
MPC = dict(n_candidates=16, replan_every=4, scene_chunk=16)


def _cfg(**kw):
    return get_config("goalcond", **{**SMALL, **kw})


def _state(cfg):
    return create_train_state(cfg, device="cpu")


def _snapshot(state) -> dict:
    """Every tensor, count and the generator of a state, copied."""
    saved = ckpt.state_dict(state)
    return {"step": saved["step"], "rng": saved["rng"]["state"].clone(),
            **{f"{part}.{k}": v.clone() for part in ("g", "d", "g_ema", "ada")
               for k, v in saved[part].items()},
            **{f"{opt}.{m}.{k}": v.clone() for opt in ("g_opt", "d_opt")
               for m in ("mu", "nu") for k, v in saved[opt][m].items()},
            "counts": (saved["g_opt"]["count"], saved["d_opt"]["count"])}


def assert_snapshot_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, b[k]), k
        else:
            assert v == b[k], k


def _scripted(monkeypatch, *metrics):
    seq = iter(metrics)
    monkeypatch.setattr(distill_mod, "_suite_metrics",
                        lambda *a, **k: next(seq))


# ------------------------------------------------- tests/test_distill.py


def test_record_seed_differs_from_eval_suite():
    from ndivplanning_tpu_torch.train.evaluate import EVAL_SUITE_SEED

    assert RECORD_SEED == jax_distill.RECORD_SEED != EVAL_SUITE_SEED


@pytest.mark.parametrize("t,h", [(8, 8), (8, 4), (64, 32), (64, 16)])
def test_subsample_grid_is_jax_bitwise(t, h):
    pos = np.random.default_rng(t + h).normal(size=(3, t, 2)).astype(
        np.float32)
    got = _subsample_to_horizon(pos, h)
    np.testing.assert_array_equal(got, jax_distill._subsample_to_horizon(
        pos, h))
    if (t, h) == (8, 4):  # waypoint i at executed step ((i+1)T)//H - 1
        np.testing.assert_array_equal(got, pos[:, [1, 3, 5, 7]])


def test_subsample_rejects_short_episodes():
    with pytest.raises(ValueError, match="total_steps"):
        _subsample_to_horizon(np.zeros((2, 8, 2), np.float32), 16)


def test_record_mpc_schema_and_filter(tmp_path):
    cfg = _cfg()
    path = str(tmp_path / "expert.npz")
    stats = record_planner_dataset(cfg, _state(cfg), 64, path,
                                   planner="mpc", **MPC)
    assert stats["kept"] + stats["dropped"] == 64
    assert 0.0 <= stats["open_loop_keep_rate"] <= 1.0
    assert stats["kept"] > 0
    ds = ArrayDataset.from_npz(path)
    assert ds.size == stats["kept"] and set(ds.arrays) == set(RECORD_KEYS)
    assert ds.arrays["real_traj"].shape[1:] == (cfg.horizon, cfg.state_dim)
    # Every kept row verifies open-loop successful against its scene.
    r, c = _verify_open_loop(cfg, scenes_from_arrays(ds.arrays, "startgoal"),
                             torch.from_numpy(ds.arrays["real_traj"]))
    assert bool((r > 0.5).all()) and bool((c < 0.5).all())


def test_record_per_scene_tiles_conditions(tmp_path):
    cfg = _cfg()
    path = str(tmp_path / "expert.npz")
    stats = record_planner_dataset(cfg, _state(cfg), 6, path, planner="mpc",
                                   per_scene=2, success_only=False, **MPC)
    assert stats["kept"] == 12
    a = ArrayDataset.from_npz(path).arrays
    for k in ("conditions", "scene_goal", "scene_obstacles"):
        np.testing.assert_array_equal(a[k][0::2], a[k][1::2])
    assert not np.array_equal(a["real_traj"][0], a["real_traj"][1])


def test_record_trajopt_and_rejects_unknown(tmp_path):
    cfg = _cfg(n_candidates=8, trajopt_steps=4)
    path = str(tmp_path / "expert_to.npz")
    stats = record_planner_dataset(cfg, _state(cfg), 8, path,
                                   planner="trajopt", n_candidates=4,
                                   scene_chunk=8)
    assert stats["kept"] + stats["dropped"] == 8
    with pytest.raises(ValueError, match="unknown planner"):
        record_planner_dataset(cfg, _state(cfg), 4, path, planner="rrt")
    with pytest.raises(ValueError, match="replan_every"):
        record_planner_dataset(cfg, _state(cfg), 4, path, planner="mpc",
                               replan_every=5)


@pytest.mark.parametrize("planner", ["ilqr", "cem+trajopt"])
def test_record_second_order_and_hybrid_teachers(tmp_path, planner):
    cfg = _cfg(n_candidates=16, trajopt_steps=2, ilqr_iters=2, cem_iters=1)
    path = str(tmp_path / "expert.npz")
    stats = record_planner_dataset(cfg, _state(cfg), 4, path, planner=planner,
                                   n_candidates=32, scene_chunk=4,
                                   success_only=False)
    assert stats["kept"] == 4 and stats["planner"] == planner
    with np.load(path) as d:
        assert d["real_traj"].shape == (4, cfg.horizon, 2)
        assert np.isfinite(d["real_traj"]).all()


def test_record_action_mode_distills_actions(tmp_path):
    cfg = _cfg(rollout_mode="actions", env="unicycle")
    path = str(tmp_path / "expert_act.npz")
    stats = record_planner_dataset(cfg, _state(cfg), 8, path, planner="mpc",
                                   n_candidates=8, replan_every=4,
                                   scene_chunk=8, success_only=False)
    ds = ArrayDataset.from_npz(path)
    assert ds.size == 8 and stats["planner"] == "mpc"
    assert ds.arrays["real_traj"].shape[1:] == (cfg.horizon, 2)
    # The rows are the distilled actions of MPC's executed positions: in
    # action mode they replay what the waypoints would.
    scenes = scenes_from_arrays(ds.arrays, "startgoal")
    acts = torch.from_numpy(ds.arrays["real_traj"])
    r, c = _verify_open_loop(cfg, scenes, acts)
    assert r.shape == c.shape == (8,)


def test_reset_for_finetune_rebases_copies():
    cfg = _cfg()
    state = _state(cfg)
    from ndivplanning_tpu_torch.train.step import train_step_fused

    for _ in range(2):
        train_step_fused(cfg, state)
    before = _snapshot(state)
    ft = reset_for_finetune(cfg, state)
    assert ft.step == 0 and ft.g_opt.count == ft.d_opt.count == 0
    assert all(float(v.abs().sum()) == 0 for v in ft.g_opt.mu.values())
    assert float(ft.ada["r"]) == 0.0
    for a, b in ((ft.g, state.g), (ft.d, state.d), (ft.g_ema, state.g_ema)):
        for (n, p), q in zip(a.state_dict().items(),
                             b.state_dict().values()):
            assert torch.equal(p, q) and p.data_ptr() != q.data_ptr(), n
    assert torch.equal(ft.rng.get_state(), state.rng.get_state())
    for _ in range(2):  # the fine-tune's steps leave the original alone
        train_step_fused(cfg, ft)
    assert_snapshot_equal(before, _snapshot(state))


def test_expert_iteration_smoke(tmp_path):
    cfg = _cfg()
    state = _state(cfg)
    before = _snapshot(state)
    out, report = expert_iteration(cfg, state, rounds=1,
                                   scenes_per_round=16, epochs=2,
                                   workdir=str(tmp_path / "distill"),
                                   suite_scenes=16, **MPC)
    assert len(report) == 1
    row = report[0]
    assert row["record"]["kept"] + row["record"]["dropped"] == 16
    assert row["record"]["kept"] > 0
    assert "after" in row and isinstance(row["accepted"], bool)
    assert row["epochs"] == 2
    rd = tmp_path / "distill" / "round_0"
    assert (rd / "expert.npz").exists() and (rd / "record.json").exists()
    assert (rd / "report_row.json").exists()
    assert (rd / "dataset_run.json").exists()
    assert_snapshot_equal(before, _snapshot(state))
    assert (out is state) != row["accepted"]


def test_train_from_dataset_eval_suite_exclusive(tmp_path):
    cfg = _cfg()
    path = str(tmp_path / "d.npz")
    record_planner_dataset(cfg, _state(cfg), 8, path, planner="mpc",
                           n_candidates=8, replan_every=4,
                           success_only=False, scene_chunk=8)
    ds = ArrayDataset.from_npz(path)
    with pytest.raises(ValueError, match="mutually exclusive"):
        train_from_dataset(cfg.replace(batch_size=4), ds, num_epochs=1,
                           state=_state(cfg), restore=False,
                           eval_dataset=ds, eval_suite=True)


@pytest.mark.parametrize("frac,accepted", [(0.5, False), (0.0, True)])
def test_diversity_guard(tmp_path, monkeypatch, frac, accepted):
    """A round whose success improves but whose mean pairwise distance
    fell below ``min_diversity_frac`` of the pre-iteration value is
    rejected; at 0 the guard is off."""
    cfg = _cfg()
    _scripted(monkeypatch,
              {"eval_success_rate": 0.3, "eval_mean_pairwise_dist": 1.0},
              {"eval_success_rate": 0.9, "eval_mean_pairwise_dist": 0.2})
    _, report = expert_iteration(cfg, _state(cfg), rounds=1,
                                 scenes_per_round=16, epochs=1,
                                 workdir=str(tmp_path / "distill"),
                                 suite_scenes=16, min_diversity_frac=frac,
                                 **MPC)
    row = report[0]
    assert row["record"]["kept"] > 0
    assert row["accepted"] is accepted
    if accepted:
        assert "rejected_for_diversity" not in row
    else:
        assert row["rejected_for_diversity"]["floor"] == 0.5


def test_rejected_rounds_leave_the_caller_state_bitwise(tmp_path,
                                                        monkeypatch):
    """The port's step updates in place: the fine-tune must run on copies,
    so two rejected rounds record from, and return, the caller's state
    bitwise as it was."""
    cfg = _cfg()
    state = _state(cfg)
    before = _snapshot(state)
    recorded = []
    real = distill_mod.record_planner_dataset

    def spy(cfg_, state_, *a, **k):
        recorded.append(_snapshot(state_))
        return real(cfg_, state_, *a, **k)

    monkeypatch.setattr(distill_mod, "record_planner_dataset", spy)
    _scripted(monkeypatch,
              {"eval_success_rate": 0.9, "eval_mean_pairwise_dist": 1.0},
              {"eval_success_rate": 0.1, "eval_mean_pairwise_dist": 1.0},
              {"eval_success_rate": 0.1, "eval_mean_pairwise_dist": 1.0})
    out, report = expert_iteration(cfg, state, rounds=2,
                                   scenes_per_round=16, epochs=1,
                                   workdir=str(tmp_path / "distill"),
                                   suite_scenes=16, **MPC)
    assert [r["accepted"] for r in report] == [False, False]
    assert out is state and len(recorded) == 2
    for snap in (*recorded, _snapshot(state)):
        assert_snapshot_equal(before, snap)


def test_expert_iteration_resumes_finished_rounds(tmp_path, monkeypatch):
    """A re-run over the same workdir skips finished rounds, restores an
    accepted round's state from its best checkpoint and records nothing."""
    cfg = _cfg()
    wd = str(tmp_path / "distill")
    calls = []
    real = distill_mod.record_planner_dataset
    monkeypatch.setattr(distill_mod, "record_planner_dataset",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    # No diversity floor: the fine-tune's tracker saves best/ at its
    # first eval point.
    _scripted(monkeypatch,
              {"eval_success_rate": 0.1, "eval_mean_pairwise_dist": 0.0},
              {"eval_success_rate": 0.9, "eval_mean_pairwise_dist": 0.0})
    first, report1 = expert_iteration(cfg, _state(cfg), rounds=1,
                                      scenes_per_round=16, epochs=1,
                                      workdir=wd, suite_scenes=16, **MPC)
    assert report1[0]["accepted"] and len(calls) == 1
    _scripted(monkeypatch,
              {"eval_success_rate": 0.1, "eval_mean_pairwise_dist": 0.0})
    again, report2 = expert_iteration(cfg, _state(cfg), rounds=1,
                                      scenes_per_round=16, epochs=1,
                                      workdir=wd, suite_scenes=16, **MPC)
    assert len(calls) == 1
    assert report2 == report1
    assert_snapshot_equal(_snapshot(first), _snapshot(again))


def test_resume_accepted_round_missing_best_raises(tmp_path):
    cfg = _cfg()
    rd = tmp_path / "distill" / "round_0"
    rd.mkdir(parents=True)
    (rd / "report_row.json").write_text(json.dumps(
        {"round": 0, "accepted": True,
         "after": {"eval_success_rate": 0.9,
                   "eval_mean_pairwise_dist": 0.5}}))
    with pytest.raises(RuntimeError, match="failed to restore"):
        expert_iteration(cfg, _state(cfg), rounds=1, scenes_per_round=16,
                         epochs=1, workdir=str(tmp_path / "distill"),
                         suite_scenes=16, **MPC)


def test_record_oneshot_teacher(tmp_path):
    cfg = _cfg()
    path = str(tmp_path / "expert.npz")
    stats = record_planner_dataset(cfg, _state(cfg), 8, path,
                                   planner="oneshot", n_candidates=16,
                                   scene_chunk=8, per_scene=2)
    assert stats["planner"] == "oneshot"
    assert stats["kept"] + stats["dropped"] == 16
    with np.load(path) as d:
        assert d["real_traj"].shape == (stats["kept"], cfg.horizon, 2)
        assert d["conditions"].shape[0] == stats["kept"]


def test_recording_is_device_independent_in_its_inputs(tmp_path):
    """Scenes and noise come from the CPU, so two recordings with one seed
    agree, and the chunking changes only which noise a row gets."""
    cfg = _cfg()
    state = _state(cfg)
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    kw = dict(planner="oneshot", n_candidates=16, success_only=False)
    record_planner_dataset(cfg, state, 8, a, scene_chunk=4, **kw)
    record_planner_dataset(cfg, state, 8, b, scene_chunk=4, **kw)
    with np.load(a) as x, np.load(b) as y:
        for k in RECORD_KEYS:
            np.testing.assert_array_equal(x[k], y[k])


def test_plan_best_score_is_lower_better():
    assert _improved("eval_plan_best_score", 0.1, 0.2)
    assert not _improved("eval_plan_best_score", 0.3, 0.2)


def test_track_planner_score_merges_ladder_metrics(tmp_path):
    cfg = _cfg(n_candidates=16)
    _, report = expert_iteration(cfg, _state(cfg), rounds=1,
                                 scenes_per_round=8, epochs=1,
                                 n_candidates=8, planner="oneshot",
                                 scene_chunk=8,
                                 workdir=str(tmp_path / "distill"),
                                 suite_scenes=8,
                                 track="eval_plan_best_score")
    row = report[0]
    assert "eval_plan_best_score" in row["before"]
    if row["record"]["kept"]:
        assert "eval_plan_best_score" in row["after"]
        want = _improved("eval_plan_best_score",
                         row["after"]["eval_plan_best_score"],
                         row["before"]["eval_plan_best_score"])
        if "rejected_for_diversity" not in row:
            assert row["accepted"] == want


def test_stale_recording_is_re_recorded(tmp_path, monkeypatch):
    cfg = _cfg()
    wd = str(tmp_path / "distill")
    calls = []
    real = distill_mod.record_planner_dataset
    monkeypatch.setattr(distill_mod, "record_planner_dataset",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    kw = dict(rounds=1, scenes_per_round=16, epochs=1, replan_every=4,
              scene_chunk=16, workdir=wd, suite_scenes=16)
    expert_iteration(cfg, _state(cfg), n_candidates=16, **kw)
    assert len(calls) == 1

    def crash_after_recording():
        os.remove(os.path.join(wd, "round_0", "report_row.json"))
        shutil.rmtree(os.path.join(wd, "round_0", "best"),
                      ignore_errors=True)

    crash_after_recording()
    expert_iteration(cfg, _state(cfg), n_candidates=16, **kw)
    assert len(calls) == 1  # the same parameters reuse the recording
    crash_after_recording()
    expert_iteration(cfg, _state(cfg), n_candidates=8, **kw)
    assert len(calls) == 2  # a changed one re-records


def test_zero_successes_are_reported_not_trained(tmp_path, monkeypatch):
    cfg = _cfg()
    monkeypatch.setattr(distill_mod, "_verify_open_loop",
                        lambda cfg_, sc, t: (torch.zeros(t.shape[0]),
                                             torch.zeros(t.shape[0])))
    state = _state(cfg)
    out, report = expert_iteration(cfg, state, rounds=1, scenes_per_round=8,
                                   epochs=1, workdir=str(tmp_path / "d"),
                                   suite_scenes=8, **MPC)
    assert out is state
    assert report[0]["accepted"] is False
    assert report[0]["error"] == "planner recorded zero successes"


def test_small_recording_shrinks_the_batch(tmp_path, monkeypatch):
    cfg = _cfg(batch_size=64)
    _scripted(monkeypatch,
              {"eval_success_rate": 0.9, "eval_mean_pairwise_dist": 1.0},
              {"eval_success_rate": 0.1, "eval_mean_pairwise_dist": 1.0})
    _, report = expert_iteration(cfg, _state(cfg), rounds=1,
                                 scenes_per_round=16, epochs=3,
                                 workdir=str(tmp_path / "d"),
                                 suite_scenes=16, **MPC)
    kept = report[0]["record"]["kept"]
    assert 0 < kept < 64 and report[0]["batch_size"] == kept
    rows = [json.loads(line) for line in open(
        tmp_path / "d" / "round_0" / "metrics.jsonl", encoding="utf-8")]
    # 3 steps, evaluated at each: the cadence is max(steps // 20, 1).
    assert [r["step"] for r in rows if r.get("kind") == "eval"] == [1, 2, 3]


# ----------------------------------------------- parity with the JAX package


def _family_inputs(env, n=8, horizon=16, seed=0):
    """JAX's random scenes and bent start -> goal paths ``[n, H, 2]``."""
    js = jax_scenes(jax.random.PRNGKey(seed), n)
    arrays = [np.asarray(getattr(js, f)) for f in
              ("start", "goal", "obstacles", "obstacle_mask")]
    rng = np.random.default_rng(seed)
    t = np.linspace(0.05, 1.0, horizon, dtype=np.float32)[None, :, None]
    side = rng.uniform(-0.4, 0.4, size=(n, 1, 1)) * np.sin(np.pi * t)
    paths = (arrays[0][:, None] + t * (arrays[1] - arrays[0])[:, None]
             + side * np.array([1.0, -1.0])).astype(np.float32)
    return js, Scene(*(torch.tensor(a) for a in arrays)), paths


@pytest.mark.parametrize("env,kw", [
    ("unicycle", {}),
    ("pointmass", {}),
    ("arm3", ARM3_ACTIONS),
])
def test_open_loop_check_and_distilled_actions_match_jax(env, kw):
    kw = {**dict(SMALL, env=env), **kw}
    cfg, jcfg = get_config("goalcond", **kw), jax_get_config("goalcond",
                                                             **kw)
    js, scenes, paths = _family_inputs(env)
    trajs = paths
    if cfg.rollout_mode == "actions":
        got = _distill_actions_batch(cfg, scenes, torch.from_numpy(paths))
        want = np.asarray(jax_distill._distill_actions_batch(
            jcfg, js, jnp.asarray(paths)))
        np.testing.assert_allclose(got.numpy(), want, rtol=DISTILL_RTOL,
                                   atol=DISTILL_ATOL)
        trajs = want
    elif env == "unicycle":
        acts = _distill_actions_batch(cfg, scenes, torch.from_numpy(paths))
        np.testing.assert_allclose(
            acts.numpy(), np.asarray(jax_distill._distill_actions_batch(
                jcfg, js, jnp.asarray(paths))),
            rtol=DISTILL_RTOL, atol=DISTILL_ATOL)
    r, c = _verify_open_loop(cfg, scenes, torch.tensor(trajs))
    jr, jc = jax_distill._verify_open_loop(jcfg, js, jnp.asarray(trajs))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert 0 < float(np.asarray(jr).sum()) or 0 < float(np.asarray(jc).sum())


@pytest.mark.parametrize("planner", ["mpc", "oneshot"])
def test_recording_schema_is_jax(tmp_path, planner):
    cfg, jcfg = _cfg(), jax_get_config("goalcond", **SMALL)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    stats = record_planner_dataset(cfg, _state(cfg), 8, ours,
                                   planner=planner, success_only=False,
                                   **MPC)
    jstats = jax_distill.record_planner_dataset(
        jcfg, jax_create(jcfg), 8, theirs, planner=planner,
        success_only=False, **MPC)
    assert stats.keys() == jstats.keys()
    for k in ("planner", "n_scenes", "per_scene", "kept", "dropped",
              "total_steps", "replan_every", "n_candidates", "seed"):
        assert stats[k] == jstats[k], k
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files) == sorted(RECORD_KEYS)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            assert a[k].shape == b[k].shape, k
