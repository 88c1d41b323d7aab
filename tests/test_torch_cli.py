"""The torch port's CLI and client on the CPU (``--device cpu``).

The client spawns ``python -m ndivplanning_tpu_torch.cli serve`` over
pipes, as a deployment would; ``plan`` runs the committed planning512
model at full width (1000 candidates).  Every subcommand and option of
the JAX CLI that the port lacks exits with a message naming it.
"""

import json
import os
import subprocess
import sys

import pytest

from ndivplanning_tpu_torch.cli import main
from ndivplanning_tpu_torch.planning.client import PlanningClient, ServerError
from ndivplanning_tpu_torch.train.state import create_train_state
from ndivplanning_tpu_torch.utils import checkpoint
from ndivplanning_tpu_torch.utils.config import get_config

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
        with pytest.raises(ServerError, match="mpc"):
            c.mpc(start=[0.1, 0.1], goal=[0.9, 0.9])
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


@pytest.mark.parametrize("cmd", ["train", "eval", "viz", "record-data",
                                 "distill", "export", "doctor", "curves"])
def test_unported_subcommands_exit_with_their_name(cmd):
    with pytest.raises(SystemExit, match=f"'{cmd}' subcommand is not ported"):
        main([cmd, "--preset", "goalcond"])


@pytest.mark.parametrize("args,flag", [
    (["plan", "--mpc"], "--mpc"),
    (["plan", "--sharded"], "--sharded"),
    (["plan", "--refine", "cem"], "--refine"),
    (["serve", "--refine", "grad"], "--refine"),
    (["plan", "--profile-dir", "prof"], "--profile-dir"),
    (["serve", "--tcp", "0"], "--tcp"),
    (["serve", "--cross-batch"], "--cross-batch"),
    (["serve", "--max-pending", "4"], "--max-pending"),
    (["serve", "--deadline-ms", "50"], "--deadline-ms"),
    (["serve", "--watch-best"], "--watch-best"),
    (["serve", "--warmup-mpc"], "--warmup-mpc"),
])
def test_unported_flags_exit_with_their_name(args, flag):
    with pytest.raises(SystemExit, match=f"{flag} is not ported"):
        main([*args, "--device", "cpu"])


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
