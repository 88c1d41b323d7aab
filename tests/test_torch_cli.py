"""The torch port's CLI and client on the CPU (``--device cpu``).

The client spawns ``python -m ndivplanning_tpu_torch.cli serve`` over
pipes, as a deployment would; ``plan`` runs the committed planning512 and
env-family models at full width (1000 candidates), and arm3 goes from
``train`` to ``serve`` in action mode.  The tools (viz, curves, export,
doctor, --profile-dir, --debug-nans) run on the CPU at a small size; plan
--sharded on a rank of its own matches plan bitwise, and inside two gloo
ranks' group prints from rank 0.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
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


def _small_run(tmp_path, capsys) -> str:
    """A goalcond run of 5 steps (its metrics, config and checkpoint)."""
    run = str(tmp_path / "run")
    _cli_json(capsys, ["train", *TRAIN_ARGS, "--steps", "5", "--workdir",
                       run])
    return run


def _tool_case(cmd, tmp_path, capsys):
    """Each tool subcommand on the CPU at a small size."""
    if cmd == "doctor":
        assert main(["doctor", "--no-probe"]) == 0
        report = json.loads(capsys.readouterr().out)
        assert "healthy" not in report and report["torch"]
        return
    run = _small_run(tmp_path, capsys)
    out = str(tmp_path / "out")
    if cmd == "curves":
        row = _cli_json(capsys, ["curves", "--workdir", run, "--out",
                                 out + ".png"])
        # 5-step run: train rows at 5 and its compile row; an eval at 5.
        assert (row["train_rows"], row["eval_rows"]) == (2, 1)
        assert os.path.getsize(out + ".png") > 1000
    elif cmd == "viz":
        row = _cli_json(capsys, ["viz", "--workdir", run, "--out",
                                 out + ".png", "--set", "n_candidates=16",
                                 "--device", "cpu"])
        assert row["out"] == out + ".png" and math.isfinite(
            row["best_score"])
        assert os.path.getsize(out + ".png") > 1000
    else:
        row = _cli_json(capsys, ["export", "--workdir", run, "--out", out,
                                 "--set", "n_candidates=16", "--set",
                                 "trajopt_steps=1", "--device", "cpu"])
        assert row["device"] == "cpu" and row["step"] == 5
        with open(os.path.join(out, "manifest.json"), encoding="utf-8") as f:
            manifest = json.load(f)
        assert manifest["planner"]["n_candidates"] == 16
        assert all(os.path.exists(os.path.join(out, manifest[a]["file"]))
                   for a in manifest["artifacts"])


@pytest.mark.parametrize("cmd", ["viz", "export", "doctor", "curves"])
def test_tool_subcommands_run_on_the_cpu(cmd, tmp_path, capsys):
    _tool_case(cmd, tmp_path, capsys)


def _flag_case(name, tmp_path, capsys):
    """Run one command with --profile-dir or --debug-nans; returns its
    printed JSON (or None for the server)."""
    prof = str(tmp_path / "prof")
    if name == "serve_debug_nans":
        with PlanningClient.spawn([*_serve_args(tmp_path), "--refine", "ilqr",
                                   "--set", "ilqr_iters=1",
                                   "--debug-nans"]) as c:
            assert math.isfinite(c.plan(start=[0.1, 0.1],
                                        goal=[0.9, 0.9])["best_score"])
        return None
    if name in ("train_dataset_profile", "record_data_profile"):
        data = str(tmp_path / "rec.npz")
        args = ["record-data", *TRAIN_ARGS, "--out", data, "--n-examples",
                "16"]
        if name == "train_dataset_profile":
            _cli_json(capsys, args)
            args = ["train", *TRAIN_ARGS, "--workdir", str(tmp_path / "run"),
                    "--dataset", data, "--eval-fraction", "0"]
        return _cli_json(capsys, [*args, "--profile-dir", prof]), prof
    if name == "train_profile":
        return _cli_json(capsys, ["train", *TRAIN_ARGS, "--steps", "2",
                                  "--profile-dir", prof]), prof
    run = _small_run(tmp_path, capsys)
    if name == "plan_profile":
        return _cli_json(capsys, ["plan", "--workdir", run, "--set",
                                  "n_candidates=16", "--device", "cpu",
                                  "--profile-dir", prof]), prof
    if name == "eval_trajopt_profile":
        return _cli_json(capsys, ["eval", "--workdir", run, "--planner",
                                  "trajopt", "--suite-size", "2", "--set",
                                  "trajopt_steps=2", "--set",
                                  "n_candidates=16", "--device", "cpu",
                                  "--profile-dir", prof]), prof
    if name == "eval_debug_nans":
        return _cli_json(capsys, ["eval", "--workdir", run, "--suite-size",
                                  "16", "--device", "cpu",
                                  "--debug-nans"]), None
    assert name == "distill_debug_nans"
    return _cli_json(capsys, ["distill", "--workdir", run, "--device", "cpu",
                              "--planner", "oneshot", "--scenes-per-round",
                              "16", "--epochs", "1", "--suite-size", "16",
                              "--distill-workdir", str(tmp_path / "d"),
                              "--debug-nans"]), None


FLAG_CASES = ["plan_profile", "train_profile", "eval_trajopt_profile",
              "serve_debug_nans", "eval_debug_nans", "record_data_profile",
              "distill_debug_nans", "train_dataset_profile"]


@pytest.mark.parametrize("name", FLAG_CASES)
def test_profile_dir_and_debug_nans_run_on_the_cpu(name, tmp_path, capsys):
    """--profile-dir writes a trace of the command, which runs as without
    it; --debug-nans runs a clean command through."""
    from ndivplanning_tpu_torch.utils.profiling import enable_nan_debugging

    try:
        result = _flag_case(name, tmp_path, capsys)
    finally:
        enable_nan_debugging(False)
    if result is None:
        return
    out, prof = result
    assert out and all(math.isfinite(v) for v in out.values()
                       if isinstance(v, float))
    if prof is not None:
        (trace,) = os.listdir(prof)
        with open(os.path.join(prof, trace), encoding="utf-8") as f:
            assert json.load(f)["traceEvents"]


# Small budgets for plan --sharded against plan on the CPU.
SHARDED_SETS = ["--set", "n_candidates=64", "--set", "cem_iters=3", "--set",
                "grad_refine_steps=3", "--set", "trajopt_steps=4", "--set",
                "ilqr_iters=2"]


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.parametrize("args", [
    pytest.param(["plan", "--refine", "trajopt"], id="trajopt"),
    pytest.param(["plan"], id="plain"),
    pytest.param(["plan", "--refine", "ilqr"], id="ilqr"),
    pytest.param(["plan", "--refine", "cem+trajopt"], id="cem+trajopt"),
    pytest.param(["plan", "--refine", "grad"], id="grad"),
    pytest.param(["plan", "--refine", "cem"], id="cem"),
])
def test_plan_sharded_runs_on_one_rank(args, capsys):
    """plan --sharded with no process group makes one rank of its own: it
    prints the 1x1 mesh and, bitwise, the unsharded plan of the same seed,
    and ends the group it made."""
    import torch.distributed as dist

    common = [*args, "--device", "cpu", *SHARDED_SETS]
    assert main(common) == 0
    want = _last_json(capsys.readouterr().out)
    assert main([*common, "--sharded"]) == 0
    got = _last_json(capsys.readouterr().out)
    assert got.pop("mesh") == "1x1"
    assert got == want
    assert not dist.is_initialized()


@pytest.mark.parametrize("local_rank, cards, backend", [
    pytest.param(1, 2, "nccl", id="a-card-a-rank"),
    pytest.param(1, 1, "gloo", id="ranks-share-a-card"),
])
def test_plan_sharded_under_torchrun_picks_the_rank_card_before_loading(
        monkeypatch, local_rank, cards, backend):
    """Under torchrun (WORLD_SIZE set) with a CUDA device, plan --sharded
    makes the rank's card (LOCAL_RANK modulo the cards) current and opens
    the group before the state is loaded, and loads onto that card. The
    card and the group are stubbed: nothing here touches CUDA."""
    import torch
    import torch.distributed as dist

    from ndivplanning_tpu_torch import cli

    events = []

    class Loaded(Exception):
        pass

    def load_state(cfg, device, prefer_best=True):
        events.append(("load", device))
        raise Loaded

    for name, value in [("WORLD_SIZE", "2"), ("LOCAL_WORLD_SIZE", "2"),
                        ("LOCAL_RANK", str(local_rank))]:
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(cli, "resolve_device",
                        lambda name: torch.device("cuda"))
    monkeypatch.setattr(cli, "_load_state", load_state)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda dev: events.append(("set_device", dev)))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: events.append(
                            ("init", backend, kw.get("init_method"))))
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda: events.append(("destroy",)))
    with pytest.raises(Loaded):
        main(["plan", "--sharded", "--workdir", PLANNING512])
    card = torch.device("cuda", local_rank % cards)
    assert events == [("set_device", card), ("init", backend, "env://"),
                      ("load", card), ("destroy",)]


def cli_rank_worker(argv):
    """``main(argv)`` in a rank of an existing process group: its exit code
    and what it printed."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_plan_sharded_uses_the_existing_group_and_rank_zero_prints(
        tmp_path, capsys):
    """Two gloo ranks call the CLI inside their group on a 2x1 mesh: rank 0
    prints the plan, rank 1 nothing; the plan is the unsharded one's within
    tests/test_torch_grad_refine.py's 1e-5 (the curve's sums cross ranks)."""
    from ndivplanning_tpu_torch.parallel.spawn import run_ranks

    args = ["plan", "--refine", "grad", "--device", "cpu", *SHARDED_SETS]
    (rc0, out0), (rc1, out1) = run_ranks(
        cli_rank_worker, 2, tmp_path, [*args, "--sharded", "--dp-shards",
                                       "2"])
    assert rc0 == rc1 == 0 and out1 == ""
    got = _last_json(out0)
    assert got.pop("mesh") == "2x1"
    assert main(args) == 0
    want = _last_json(capsys.readouterr().out)
    assert got["n_candidates"] == want["n_candidates"]
    np.testing.assert_allclose(got["best_score"], want["best_score"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["soft_loss_curve"],
                               want["soft_loss_curve"], rtol=1e-5,
                               atol=1e-5)


def test_viz_command(tmp_path, capsys):
    out = tmp_path / "plan.png"
    rc = main(["viz", "--preset", "pointmass2d", "--batch-size", "4", "--k",
               "4", "--workdir", str(tmp_path), "--out", str(out),
               "--device", "cpu"])
    assert rc == 0
    assert out.exists() and out.stat().st_size > 1000
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["out"] == str(out)


def test_viz_mpc_and_curves(tmp_path, capsys):
    wd = str(tmp_path / "run")
    rc = main(["train", "--preset", "pointmass2d", "--batch-size", "8",
               "--k", "4", "--steps", "60", "--set", "eval_every=30",
               "--set", "eval_suite_scenes=32", "--workdir", wd,
               "--device", "cpu"])
    assert rc == 0
    capsys.readouterr()
    png = str(tmp_path / "ep.png")
    rc = main(["viz", "--workdir", wd, "--out", png, "--mpc",
               "--mpc-steps", "8", "--mpc-replan", "4",
               "--mpc-candidates", "8", "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["out"] == png and out["n_replans"] == 2
    assert os.path.exists(png)
    curves = str(tmp_path / "curves.png")
    rc = main(["curves", "--workdir", wd, "--out", curves])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["train_rows"] > 0 and os.path.exists(curves)
    # A missing metrics.jsonl is a usage error, not a traceback.
    rc = main(["curves", "--workdir", str(tmp_path / "nope"),
               "--out", curves])
    assert rc == 2


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
        (5, "train"), (10, "train"), (10, "eval"), (10, "compile")]
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


def test_cli_record_data_then_train_and_eval_on_the_dataset(tmp_path,
                                                           capsys):
    """record-data (the task sampler's experts) -> train --dataset with a
    held-out split -> a resume to more epochs -> eval --dataset."""
    data, run = str(tmp_path / "rec.npz"), str(tmp_path / "run")
    rec = _cli_json(capsys, ["record-data", *TRAIN_ARGS, "--out", data,
                             "--n-examples", "48"])
    assert rec == {"out": data, "kept": 48, "dropped": 0}
    args = ["train", *TRAIN_ARGS, "--workdir", run, "--dataset", data,
            "--eval-fraction", "0.25"]
    out = _cli_json(capsys, [*args, "--epochs", "2"])
    assert out["final_step"] == 2 * (36 // 8)
    assert {"d_loss", "g_adv", "g_ndiv", "steps_per_sec"} <= set(out["last"])
    assert os.path.exists(os.path.join(run, "dataset_run.json"))
    assert load_config(run).name == "goalcond"
    with open(os.path.join(run, "metrics.jsonl"), encoding="utf-8") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows if r.get("kind") == "eval"] == [8]
    out = _cli_json(capsys, [*args, "--epochs", "3"])
    assert out["final_step"] == 12
    ev = _cli_json(capsys, ["eval", "--workdir", run, "--dataset", data,
                            "--suite-size", "16", "--device", "cpu"])
    assert set(ev) == {"eval_mean_pairwise_dist", "eval_ndiv",
                       "eval_endpoint_err", "eval_success_rate",
                       "eval_collision_rate", "eval_mean_score"}
    assert all(math.isfinite(v) for v in ev.values())
    assert ev == _cli_json(capsys, ["eval", "--workdir", run, "--dataset",
                                    data, "--suite-size", "16", "--device",
                                    "cpu"])


def test_cli_record_data_from_planner(tmp_path, capsys):
    run, data = str(tmp_path / "run"), str(tmp_path / "expert.npz")
    _cli_json(capsys, ["train", *TRAIN_ARGS, "--steps", "5",
                       "--workdir", run])
    out = _cli_json(capsys, ["record-data", "--workdir", run, "--out", data,
                             "--n-examples", "6", "--from-planner",
                             "oneshot", "--per-scene", "2", "--set",
                             "n_candidates=16", "--device", "cpu"])
    assert out["out"] == data and out["planner"] == "oneshot"
    assert (out["kept"] + out["dropped"], out["per_scene"]) == (12, 2)
    assert out["n_candidates"] == 256  # --from-planner's default budget
    assert out["seed"] == 0xD157
    with np.load(data) as d:
        assert d["real_traj"].shape == (out["kept"], 32, 2)


def test_cli_distill_runs_a_round(tmp_path, capsys):
    run, wd = str(tmp_path / "run"), str(tmp_path / "distill")
    _cli_json(capsys, ["train", *TRAIN_ARGS, "--steps", "5",
                       "--workdir", run])
    out = _cli_json(capsys, ["distill", "--workdir", run, "--device", "cpu",
                             "--planner", "oneshot", "--rounds", "1",
                             "--scenes-per-round", "32", "--epochs", "1",
                             "--suite-size", "16", "--mpc-candidates", "16",
                             "--distill-workdir", wd])
    (row,) = out["rounds"]
    assert row["round"] == 0 and row["record"]["planner"] == "oneshot"
    assert row["record"]["n_scenes"] == 32
    assert row["record"]["seed"] == 0xD157
    assert isinstance(row["accepted"], bool)
    if row["record"]["kept"]:
        assert {"after", "epochs"} <= set(row)
    assert os.path.exists(os.path.join(wd, "round_0", "report_row.json"))


def test_cli_distill_passes_its_flags_and_seed_rule(tmp_path, monkeypatch,
                                                    capsys):
    from ndivplanning_tpu_torch.train import distill

    seen = {}

    def fake(cfg, state, **kw):
        seen.update(kw, batch_size=cfg.batch_size)
        return state, [{"round": 0}]

    monkeypatch.setattr(distill, "expert_iteration", fake)
    out = _cli_json(capsys, ["distill", *TRAIN_ARGS, "--workdir",
                             str(tmp_path), "--seed", "3", "--rounds", "2",
                             "--scenes-per-round", "64", "--per-scene", "2",
                             "--planner", "ilqr", "--track",
                             "eval_plan_best_score", "--epochs", "7",
                             "--suite-size", "32", "--mpc-replan", "4",
                             "--mpc-candidates", "64", "--distill-workdir",
                             "dw", "--min-diversity-frac", "0.25"])
    assert out == {"rounds": [{"round": 0}]}
    assert seen == {"seed": 0xD157 + 7919 * 3, "rounds": 2,
                    "scenes_per_round": 64, "per_scene": 2, "epochs": 7,
                    "planner": "ilqr", "replan_every": 4, "n_candidates": 64,
                    "workdir": "dw", "suite_scenes": 32, "echo": True,
                    "min_diversity_frac": 0.25,
                    "track": "eval_plan_best_score", "batch_size": 8}


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


REFINE_RUNS = {
    "grad": ("unicycle150k", "grad_refine_steps", 250),
    "trajopt": ("unicycle150k", "trajopt_steps", 250),
    "ilqr": ("quadrotor_distilled_ilqr", "ilqr_iters", 62),
    "cem+trajopt": ("quadrotor150k", "trajopt_steps", 41),
}


@pytest.mark.parametrize("refine", sorted(REFINE_RUNS))
def test_cli_plans_and_evaluates_with_each_refiner(capsys, refine):
    """``plan --refine <r>`` on a vendored model at its full width (the
    refiner's steps cut by ``--set``): one-shot's keys and JAX's
    ``soft_loss_curve``, ``n_candidates`` the 2n of the union; ``eval
    --planner <r>`` the ladder's keys."""
    name, steps_field, n = REFINE_RUNS[refine]
    workdir = os.path.join(REPO, "checkpoints_torch", name)
    cut = ["--set", f"{steps_field}=3", "--device", "cpu"]
    out = _cli_json(capsys, ["plan", "--workdir", workdir, "--refine",
                             refine, *cut])
    assert set(out) == {"best_score", "best_reached", "n_candidates",
                        "soft_loss_curve"}
    assert out["n_candidates"] == 2 * n and len(out["soft_loss_curve"]) == 3
    assert all(map(math.isfinite, out["soft_loss_curve"]))
    ev = _cli_json(capsys, ["eval", "--workdir", workdir, "--planner",
                            refine, "--suite-size", "2", *cut])
    assert ev["eval_planner"] == refine and ev["eval_plan_n_scenes"] == 2.0


def test_cli_serve_refines_with_ilqr_over_pipes(tmp_path):
    """``serve --refine ilqr --warmup`` over pipes answers a plan and a
    burst as refined plans (the warm-up dispatched every bucket)."""
    with PlanningClient.spawn([*_serve_args(tmp_path), "--refine", "ilqr",
                               "--set", "ilqr_iters=2", "--warmup"]) as c:
        resp = c.plan(start=[0.1, 0.1], goal=[0.9, 0.9])
        assert len(resp["best_traj"]) == 32 and resp["batch_size"] == 1
        out = c.plan_batch([{"start": [0.2, 0.2], "goal": [0.8, 0.8]},
                            {"start": [0.3, 0.1], "goal": [0.7, 0.9]}])
        assert [r["batch_size"] for r in out] == [2, 2]
        assert all(math.isfinite(r["best_score"]) for r in out)
