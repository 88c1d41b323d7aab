"""The torch port's CLI and client on the CPU (``--device cpu``).

The client spawns ``python -m ndivplanning_tpu_torch.cli serve`` over
pipes, as a deployment would; ``plan`` runs the committed planning512 and
env-family models at full width (1000 candidates), and arm3 goes from
``train`` to ``serve`` in action mode.  Every subcommand and option of
the JAX CLI that the port lacks exits with a message naming it.
"""

import json
import os
import re
import subprocess
import sys

import pytest

from ndivplanning_tpu_torch.cli import main
from ndivplanning_tpu_torch.planning.client import PlanningClient, ServerError
from ndivplanning_tpu_torch.train.state import create_train_state
from ndivplanning_tpu_torch.utils import checkpoint
from ndivplanning_tpu_torch.utils.config import get_config, load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANNING512 = os.path.join(REPO, "checkpoints_torch", "planning512")
SMALL_SETS = ["--set", "g_hidden=32", "--set", "d_hidden=32", "--set",
              "cond_embed_dim=8", "--set", "image_size=16", "--set",
              "n_candidates=32"]


def _serve_args(workdir):
    return ["--preset", "planning", *SMALL_SETS, "--workdir", str(workdir),
            "--device", "cpu"]


def test_client_drives_cli_serve_over_pipes(tmp_path):
    # A checkpoint at step 9 under best/, for the reload line.
    cfg = get_config("planning", g_hidden=(32,), d_hidden=(32,),
                     cond_embed_dim=8, image_size=16, n_candidates=32)
    with PlanningClient.spawn(_serve_args(tmp_path)) as c:
        resp = c.plan(start=[0.1, 0.1], goal=[0.9, 0.9],
                      obstacles=[[0.5, 0.5, 0.1]])
        assert len(resp["best_traj"]) == cfg.horizon
        assert len(resp["diverse_trajs"]) == 4 and resp["batch_size"] == 1
        before = c.stats()
        out = c.plan_batch([{"start": [0.2, 0.2], "goal": [0.8, 0.8]},
                            {"start": [0.3, 0.1], "goal": [0.7, 0.9]}])
        assert len(out) == 2 and all(r["batch_size"] == 2 for r in out)
        after = c.stats()
        assert after["dispatches"] == before["dispatches"] + 1
        assert after["requests"] == before["requests"] + 2
        with pytest.raises(ServerError, match="request 1"):
            c.plan_batch([{"start": [0.1, 0.1], "goal": [0.9, 0.9]},
                          {"goal": [0.9, 0.9]}])
        raw = c.plan_batch([{"start": [0.1, 0.1], "goal": [0.9, 0.9]},
                            {"goal": [0.9, 0.9]}], raise_on_error=False)
        assert "best_score" in raw[0] and "error" in raw[1]
        with pytest.raises(ServerError):
            c.plan(start=[0.1], goal=[0.9, 0.9])
        episode = c.mpc(start=[0.1, 0.1], goal=[0.9, 0.9])
        assert set(episode) == {"path", "reached", "collided", "n_replans",
                                "latency_ms", "batch_size"}
        assert len(episode["path"]) == 64 and episode["n_replans"] == 8
        state = create_train_state(cfg, device="cpu")
        state.step = 9
        checkpoint.save_checkpoint(str(tmp_path / "best"), state)
        assert c.reload() == {"reloaded": True, "step": 9}
        assert "best_score" in c.plan(start=[0.2, 0.1], goal=[0.9, 0.9])
        burst = c.send_lines([json.dumps({"start": [0.1 * i, 0.2],
                                          "goal": [0.9, 0.9]})
                              for i in range(1, 4)] + ["not json"])
        assert [r.get("batch_size") for r in burst] == [4, 4, 4, None]
        assert "error" in burst[3]
        assert c.close() == [{"served": 14}]  # every line but quit
    assert c.close() == []
    with pytest.raises(RuntimeError, match="closed"):
        c.plan(start=[0.1, 0.1], goal=[0.9, 0.9])
    assert c._owned[0].returncode == 0


def test_cli_serve_answers_a_burst_and_reports_served(tmp_path):
    lines = [json.dumps({"start": [0.05 * (i + 1), 0.1], "goal": [0.9, 0.9]})
             for i in range(3)] + ["not json", "stats", "quit"]
    out = subprocess.run(
        [sys.executable, "-m", "ndivplanning_tpu_torch.cli", "serve",
         *_serve_args(tmp_path), "--warmup", "--no-overlap"],
        input="\n".join(lines) + "\n", capture_output=True, text=True,
        cwd=REPO, timeout=300, check=True)
    replies = [json.loads(line) for line in out.stdout.splitlines()]
    assert [r.get("batch_size") for r in replies[:3]] == [4, 4, 4]
    assert "error" in replies[3]
    assert replies[4]["dispatches"] == len((1, 2, 4, 8, 16)) + 1
    assert replies[5] == {"served": 5}
    assert "warmup" in out.stderr and "UNTRAINED" in out.stderr


def test_cli_plan_on_planning512(capsys):
    assert main(["plan", "--workdir", PLANNING512, "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["n_candidates"] == 1000
    assert set(out) == {"best_score", "best_reached", "n_candidates"}
    assert out["best_reached"] in (0.0, 1.0) and out["best_score"] > 0


@pytest.mark.parametrize("cmd", ["viz", "record-data", "distill", "export",
                                 "doctor", "curves"])
def test_unported_subcommands_exit_with_their_name(cmd):
    with pytest.raises(SystemExit, match=f"'{cmd}' subcommand is not ported"):
        main([cmd, "--preset", "goalcond"])


@pytest.mark.parametrize("args,flag", [
    (["plan", "--refine", "trajopt"], "--refine trajopt"),
    (["plan", "--sharded"], "--sharded"),
    (["plan", "--refine", "ilqr"], "--refine ilqr"),
    (["serve", "--refine", "grad"], "--refine grad"),
    (["plan", "--profile-dir", "prof"], "--profile-dir"),
    (["serve", "--tcp", "0"], "--tcp"),
    (["serve", "--cross-batch"], "--cross-batch"),
    (["serve", "--max-pending", "4"], "--max-pending"),
    (["serve", "--deadline-ms", "50"], "--deadline-ms"),
    (["serve", "--watch-best"], "--watch-best"),
    (["serve", "--refine", "cem+trajopt"], "--refine cem+trajopt"),
    (["train", "--dataset", "data.npz"], "--dataset"),
    (["train", "--epochs", "2"], "--epochs"),
    (["train", "--eval-fraction", "0.2"], "--eval-fraction"),
    (["train", "--profile-dir", "prof"], "--profile-dir"),
    (["eval", "--dataset", "data.npz"], "--dataset"),
    (["eval", "--planner", "grad"], "--planner grad"),
    (["eval", "--planner", "trajopt"], "--planner trajopt"),
    (["eval", "--planner", "ilqr"], "--planner ilqr"),
    (["eval", "--debug-nans"], "--debug-nans"),
])
def test_unported_flags_exit_with_their_name(args, flag):
    with pytest.raises(SystemExit, match=re.escape(f"{flag} is not ported")):
        main([*args, "--device", "cpu"])


TRAIN_ARGS = ["--preset", "goalcond", "--batch-size", "8", "--k", "4",
              "--set", "g_hidden=32", "--set", "d_hidden=32",
              "--set", "cond_embed_dim=8", "--set", "log_every=5",
              "--set", "eval_every=10", "--set", "checkpoint_every=10",
              "--set", "eval_suite_scenes=16", "--set", "g_ema_decay=0.9",
              "--device", "cpu"]


def _cli_json(capsys, argv):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out)


def test_cli_train_writes_its_run_and_resumes(tmp_path, capsys):
    run = str(tmp_path / "run")
    out = _cli_json(capsys, ["train", *TRAIN_ARGS, "--steps", "10",
                             "--workdir", run])
    assert out["final_step"] == 10 and out["last"]["step"] == 10
    assert {"d_loss", "g_adv", "g_ndiv", "steps_per_sec"} <= set(out["last"])
    assert checkpoint.all_steps(run) == [10]
    assert checkpoint.latest_step(os.path.join(run, "best")) == 10
    cfg = load_config(run)
    assert (cfg.name, cfg.batch_size, cfg.k, cfg.g_hidden, cfg.steps) == (
        "goalcond", 8, 4, (32,), 10)
    with open(os.path.join(run, "metrics.jsonl"), encoding="utf-8") as f:
        rows = [json.loads(line) for line in f]
    assert [(r["step"], r.get("kind", "train")) for r in rows] == [
        (5, "train"), (10, "train"), (10, "eval")]
    # Resume from the run's own config and checkpoint to a larger --steps.
    out = _cli_json(capsys, ["train", "--workdir", run, "--steps", "15",
                             "--device", "cpu"])
    assert out["final_step"] == 15
    assert checkpoint.all_steps(run) == [10, 15]
    assert load_config(run).steps == 15


def test_cli_eval_prints_the_frozen_sampled_and_planner_metrics(tmp_path,
                                                                 capsys):
    run = str(tmp_path / "run")
    _cli_json(capsys, ["train", *TRAIN_ARGS, "--steps", "5",
                       "--workdir", run])
    keys = {"eval_mean_pairwise_dist", "eval_ndiv", "eval_endpoint_err",
            "eval_success_rate", "eval_collision_rate", "eval_mean_score"}
    base = ["eval", "--workdir", run, "--device", "cpu"]
    frozen = _cli_json(capsys, [*base, "--suite-size", "16"])
    assert set(frozen) == keys
    assert frozen == _cli_json(capsys, [*base, "--suite-size", "16"])
    sampled = _cli_json(capsys, [*base, "--sampled"])
    assert set(sampled) == keys and sampled != frozen
    planner = _cli_json(capsys, [*base, "--planner", "oneshot",
                                 "--suite-size", "6", "--scene-chunk", "4",
                                 "--set", "n_candidates=16"])
    assert set(planner) == {"eval_plan_best_score", "eval_plan_reach_rate",
                            "eval_plan_n_scenes", "eval_planner"}
    assert planner["eval_planner"] == "oneshot"
    assert planner["eval_plan_n_scenes"] == 6.0
    assert 0.0 <= planner["eval_plan_reach_rate"] <= 1.0


@pytest.mark.parametrize("name", ["unicycle150k", "reacher150k",
                                  "quadrotor150k"])
def test_cli_plan_on_the_family_models(name, capsys):
    """``--workdir checkpoints_torch/<family>``: the recorded config names
    the env, and the model plans its random scene at 1000 candidates."""
    workdir = os.path.join(REPO, "checkpoints_torch", name)
    out = _cli_json(capsys, ["plan", "--workdir", workdir, "--device", "cpu"])
    assert out["n_candidates"] == 1000 and out["best_reached"] == 1.0
    assert load_config(workdir).env == name.removesuffix("150k")


def test_cli_trains_evaluates_plans_and_serves_arm3_in_action_mode(
        tmp_path, capsys):
    """``--set env=arm3 --set rollout_mode=actions --set state_dim=3``:
    G emits 3-D joint accelerations, from train to the served answer."""
    run = str(tmp_path / "run")
    args = [*TRAIN_ARGS, "--set", "env=arm3", "--set",
            "rollout_mode=actions", "--set", "state_dim=3", "--set",
            "generator_output=linear", "--set", "n_candidates=32"]
    assert _cli_json(capsys, ["train", *args, "--steps", "10",
                              "--workdir", run])["final_step"] == 10
    cfg = load_config(run)
    assert (cfg.env, cfg.rollout_mode, cfg.state_dim) == ("arm3", "actions",
                                                          3)
    frozen = _cli_json(capsys, ["eval", "--workdir", run, "--device", "cpu",
                                "--suite-size", "16"])
    assert 0.0 <= frozen["eval_success_rate"] <= 1.0
    assert _cli_json(capsys, ["plan", "--workdir", run, "--device",
                              "cpu"])["n_candidates"] == 32
    out = subprocess.run(
        [sys.executable, "-m", "ndivplanning_tpu_torch.cli", "serve",
         "--workdir", run, "--device", "cpu"],
        input=json.dumps({"start": [0.2, 0.2], "goal": [0.8, 0.7]})
        + "\nquit\n", capture_output=True, text=True, cwd=REPO,
        timeout=300, check=True)
    reply = json.loads(out.stdout.splitlines()[0])
    assert len(reply["best_traj"]) == cfg.horizon
    assert {len(row) for row in reply["best_traj"]} == {3}


def test_bad_preset_names_the_valid_presets(tmp_path):
    with pytest.raises(ValueError, match="goalcond.*imagecond.*planning"):
        main(["plan", "--preset", "bogus", "--workdir", str(tmp_path),
              "--device", "cpu"])
    with pytest.raises(SystemExit, match="unknown config field 'bogus'"):
        main(["plan", "--set", "bogus=1", "--device", "cpu"])


def test_client_tcp_and_retries_are_not_ported_yet():
    with pytest.raises(NotImplementedError, match="serve_tcp"):
        PlanningClient.tcp("127.0.0.1", 7421)
    c = PlanningClient(None, None)
    with pytest.raises(NotImplementedError, match="serve_tcp"):
        c.plan(start=[0.1, 0.1], goal=[0.9, 0.9], retries=2)


MPC_KEYS = {"eval_mpc_success_rate", "eval_mpc_collision_rate",
            "eval_mpc_total_steps", "eval_mpc_replan_every",
            "eval_mpc_candidates"}
PLAN_MPC_KEYS = {"episodes", "success_rate", "collision_rate", "n_replans",
                 "total_steps", "replan_every", "episodes_per_sec",
                 "first_call_s"}


def test_cli_mpc_eval_and_plan_print_jax_keys(capsys):
    """``eval --mpc`` and ``plan --mpc`` on quadrotor150k (its published
    result is closed-loop) with JAX's flags and JSON keys, at a small
    suite and candidate count."""
    workdir = os.path.join(REPO, "checkpoints_torch", "quadrotor150k")
    out = _cli_json(capsys, ["eval", "--workdir", workdir, "--mpc",
                             "--suite-size", "6", "--mpc-steps", "32",
                             "--mpc-replan", "8", "--mpc-candidates", "32",
                             "--device", "cpu"])
    assert set(out) == MPC_KEYS
    assert (out["eval_mpc_total_steps"], out["eval_mpc_replan_every"],
            out["eval_mpc_candidates"]) == (32.0, 8.0, 32.0)
    assert 0.0 <= out["eval_mpc_success_rate"] <= 1.0
    plan = _cli_json(capsys, ["plan", "--workdir", workdir, "--mpc",
                              "--mpc-episodes", "3", "--mpc-candidates",
                              "32", "--device", "cpu"])
    assert set(plan) == PLAN_MPC_KEYS
    assert (plan["episodes"], plan["n_replans"], plan["total_steps"]) == (
        3, 8, 64)
    one = _cli_json(capsys, ["plan", "--workdir", workdir, "--mpc",
                             "--mpc-candidates", "32", "--device", "cpu"])
    assert set(one) == PLAN_MPC_KEYS | {"final_pos"}
    with pytest.raises(ValueError, match="64 % 7"):
        main(["plan", "--workdir", workdir, "--mpc", "--mpc-replan", "7",
              "--device", "cpu"])


def test_cli_plans_and_evaluates_with_cem(capsys):
    """``plan --refine cem`` adds the best-so-far curve (non-increasing)
    to one-shot's keys; ``eval --planner cem`` the planner ladder's keys."""
    workdir = os.path.join(REPO, "checkpoints_torch", "unicycle150k")
    out = _cli_json(capsys, ["plan", "--workdir", workdir, "--refine", "cem",
                             "--device", "cpu"])
    assert set(out) == {"best_score", "best_reached", "n_candidates",
                        "best_curve"}
    assert out["n_candidates"] == 1000 // 6 and len(out["best_curve"]) == 5
    curve = out["best_curve"]
    assert all(b <= a for a, b in zip(curve, curve[1:]))
    assert out["best_score"] <= curve[-1] + 1e-6
    ev = _cli_json(capsys, ["eval", "--workdir", workdir, "--planner", "cem",
                            "--suite-size", "4", "--device", "cpu"])
    assert ev["eval_planner"] == "cem" and ev["eval_plan_n_scenes"] == 4.0


def test_cli_serve_warms_up_mpc_and_refines_with_cem(tmp_path):
    """``serve --warmup-mpc --refine cem`` over pipes: closed-loop lines
    and CEM plans, and ``stats`` counts the closed-loop requests (the
    warm-up's too)."""
    with PlanningClient.spawn([*_serve_args(tmp_path), "--warmup-mpc",
                               "--refine", "cem"]) as c:
        resp = c.plan(start=[0.1, 0.1], goal=[0.9, 0.9])
        assert len(resp["best_traj"]) == 32 and "best_score" in resp
        out = c.plan_batch([{"start": [0.2, 0.2], "goal": [0.8, 0.8],
                             "mpc": True},
                            {"start": [0.3, 0.1], "goal": [0.7, 0.9]}])
        assert len(out[0]["path"]) == 64 and "best_traj" in out[1]
        stats = c.stats()
        assert stats["mpc_requests"] == sum((1, 2, 4, 8, 16)) + 1
