"""Multi-rank training in the torch port on CPU gloo ranks.

The loops (``train``, ``train_from_dataset``) under a process group run
the sharded step on ``make_mesh(cfg=cfg)`` and are held against the
one-process loop of the same config; the stabiliser knobs on a mesh are
held against the JAX step, its draws replayed from its key schedule with
``tests/test_torch_stabilisers.py``'s helpers and injected, at that
file's tolerances.  Ranks are spawned processes
(``parallel/spawn.py::run_ranks``, workers in
``tests/torch_dist_workers.py``), one spawn per world size; the CLI runs
under ``torch.distributed.run``.
"""

import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndivplanning_tpu.data.tasks import make_task as jax_make_task
from ndivplanning_tpu.train.state import create_train_state as jax_create
from ndivplanning_tpu.train.step import train_step as jax_train_step
from ndivplanning_tpu.utils.config import get_config as jax_get_config
from ndivplanning_tpu_torch.data.host_pipeline import ArrayDataset
from ndivplanning_tpu_torch.data.tasks import make_task
from ndivplanning_tpu_torch.parallel.spawn import run_ranks
from ndivplanning_tpu_torch.train import loop
from ndivplanning_tpu_torch.train.state import create_train_state
from ndivplanning_tpu_torch.utils import checkpoint as ckpt
from ndivplanning_tpu_torch.utils.config import get_config
from ndivplanning_tpu_torch.utils.convert import train_state_from_flax
from tests.test_torch_parallel import STEP_TOL
from tests.test_torch_stabilisers import (
    IMAGE,
    SMALL,
    _assert_trackers_close,
    _torch_batch,
    _tree,
    jax_draws,
)
from tests.test_torch_train_step import (
    _assert_metrics_close,
    _assert_state_close,
)
from tests.torch_dist_workers import (
    draws_numpy,
    multi_rank_train_worker,
    state_from_snapshot,
    state_snapshot,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOOP_MESHES = [(2, 1), (1, 2), (2, 2)]
LOOP_STEPS = 8
# A checkpoint and an eval point inside the run, and at its end.
LOOP_EVERY = dict(log_every=2, checkpoint_every=4, eval_every=4,
                  eval_suite_scenes=8)
CLOCKS = ("wall_s", "steps_per_sec")
# One config per knob (goalcond, or imagecond for the knobs that act on
# images or need the unit box), as tests/test_torch_stabilisers.py's
# KNOB_CASES groups them; ADA's p starts at 0.5.
KNOBS = {
    "instance_noise_sigma": ("goalcond", dict(instance_noise_sigma=0.05,
                                              instance_noise_anneal=10)),
    "diffaug": ("imagecond", dict(diffaug="shift,cutout")),
    "ada_target": ("imagecond", dict(diffaug="shift,cutout",
                                     ada_target=0.6)),
    "r1_weight": ("goalcond", dict(r1_weight=0.1)),
    "lecam_weight": ("goalcond", dict(lecam_weight=0.1)),
    "topk_g_fraction": ("goalcond", dict(topk_g_fraction=0.5)),
    "feature_matching_weight": ("goalcond",
                                dict(feature_matching_weight=1.0)),
    "div_floor": ("imagecond", dict(div_floor=0.4)),
    "d_reset_every": ("goalcond", dict(d_reset_every=1)),
    "remat": ("goalcond", dict(r1_weight=0.1, feature_matching_weight=1.0,
                               remat=True)),
}
# Each knob's metrics.
KNOB_METRICS = {"instance_noise_sigma": ("d_noise_sigma",),
                "ada_target": ("ada_p",), "r1_weight": ("d_r1",),
                "lecam_weight": ("d_lecam",),
                "feature_matching_weight": ("g_fm",),
                "div_floor": ("g_divfloor",), "remat": ("d_r1", "g_fm")}
TRACKER_KNOBS = ("lecam_weight", "ada_target")  # three steps each
KNOB_MESH = (2, 2)
# The knobs whose global forms gather or sum across the mesh, on the
# uneven meshes too.
UNEVEN_KNOBS = ("topk_g_fraction", "feature_matching_weight", "div_floor")
UNEVEN_MESHES = [(4, 1), (1, 4)]


def _loop_cfg(dp=1, div=1, **kw):
    return get_config("pod_dp", batch_size=16, k=8, g_hidden=(32,),
                      d_hidden=(32,), cond_embed_dim=8, compute_dtype="f32",
                      dp_shards=dp, div_shards=div,
                      **{"steps": LOOP_STEPS, **LOOP_EVERY, **kw})


def _data_cfg(dp=1, div=1):
    return get_config("goalcond", batch_size=8, k=4, g_hidden=(32,),
                      d_hidden=(32,), cond_embed_dim=8, log_every=2,
                      checkpoint_every=4, eval_every=4, dp_shards=dp,
                      div_shards=div)


def _dataset(cfg, n, seed):
    b = make_task(cfg).sample(torch.Generator().manual_seed(seed), n)
    return ArrayDataset({"conditions": b.conditions.numpy(),
                         "real_traj": b.real_traj.numpy()})


def _rows(workdir, kind=None):
    with open(os.path.join(workdir, "metrics.jsonl"), encoding="utf-8") as f:
        rows = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k not in CLOCKS} for r in rows
            if r.get("kind") == kind]


def _assert_rows_close(got, want):
    """Metric rows at STEP_TOL, their steps and kinds equal."""
    assert [r.get("step") for r in got] == [r.get("step") for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key, value in w.items():
            if isinstance(value, str):
                assert g[key] == value, key
            else:
                np.testing.assert_allclose(g[key], value, err_msg=key,
                                           **STEP_TOL)


def _assert_snapshots_equal(a, b):
    assert a["step"] == b["step"]
    np.testing.assert_array_equal(a["rng"], b["rng"])
    for name in ("g", "d", "g_ema", "ada", "lecam_ema"):
        for key in a[name]:
            np.testing.assert_array_equal(a[name][key], b[name][key],
                                          err_msg=f"{name}.{key}")
    for name in ("g_opt", "d_opt"):
        assert a[name]["count"] == b[name]["count"]
        for part in ("mu", "nu"):
            for key in a[name][part]:
                np.testing.assert_array_equal(a[name][part][key],
                                              b[name][part][key])


def _assert_replicas_equal(outs):
    for out in outs[1:]:
        _assert_snapshots_equal(out, outs[0])


def _knob_cfgs(knob):
    preset, overrides = KNOBS[knob]
    base = IMAGE if preset == "imagecond" else SMALL
    return (jax_get_config(preset, **base, **overrides),
            get_config(preset, **base, **overrides))


def _jax_knob_run(knob, n_steps):
    """``n_steps`` JAX steps of the knob's config from its seed-0 state:
    the port's start state, each step's global inputs (its draws replayed
    from the JAX key schedule), JAX's metrics and its state after each
    step."""
    jcfg, cfg = _knob_cfgs(knob)
    jstate = jax_create(jcfg, seed=0)
    ada_p = 0.5 if knob == "ada_target" else 0.0
    jstate = jstate.replace(ada={"r": jstate.ada["r"],
                                 "p": jnp.float32(ada_p)})
    start = state_snapshot(train_state_from_flax(cfg, _tree(jstate),
                                                 device="cpu"))
    task = jax_make_task(jcfg)
    steps, jmetrics, jstates = [], [], []
    for i in range(n_steps):
        jbatch = task.sample(jax.random.PRNGKey(100 + i), cfg.batch_size)
        z, draws = jax_draws(jcfg, cfg, jstate, jbatch)
        batch = _torch_batch(jbatch)
        steps.append((batch.conditions.numpy(), batch.real_traj.numpy(),
                      z.numpy(), draws_numpy(draws)))
        jstate, jm = jax_train_step(jcfg, jstate, jbatch)
        jmetrics.append({k: float(v) for k, v in jm.items()})
        # A copy: the next step donates the state's buffers.
        jstates.append(jax.tree.map(np.array, jstate))
    return cfg, start, steps, jmetrics, jstates


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The one-process runs the meshes are held against: the loop of 8
    steps, its first 4 in a workdir of their own, and the dataset loop."""
    tmp = tmp_path_factory.mktemp("one")
    cfg = _loop_cfg()
    state, history = loop.train(cfg, workdir=str(tmp / "loop"), echo=False,
                                device="cpu")
    loop.train(cfg.replace(steps=4), workdir=str(tmp / "first4"), echo=False,
               device="cpu")
    dcfg = _data_cfg()
    data = (_dataset(dcfg, 64, 1), _dataset(dcfg, 16, 2))
    dstate, dlast = loop.train_from_dataset(
        dcfg, data[0], 2, workdir=str(tmp / "data"), eval_dataset=data[1],
        device="cpu")
    return {"tmp": tmp, "loop": (state_snapshot(state), history),
            "data": data, "data_run": (state_snapshot(dstate), dlast)}


def _two_rank_jobs(one_process, tmp):
    """Two gloo ranks' jobs: the loop at (2,1) and (1,2), a 4-step (2,1)
    run for the one process to resume, the one process's 4 steps resumed
    at (2,1), the dataset loop at (2,1) whole and as 1 + 1 epochs, and a
    (2,2) config on a world of 2."""
    shutil.copytree(one_process["tmp"] / "first4", tmp / "one_resumed")
    train_ds, eval_ds = one_process["data"]

    def data(epochs, workdir):
        return dict(dataset=train_ds, num_epochs=epochs, eval_dataset=eval_ds,
                    workdir=str(tmp / workdir))

    jobs = [(f"loop_{dp}x{div}", "train", _loop_cfg(dp, div),
             dict(workdir=str(tmp / f"loop_{dp}x{div}")))
            for dp, div in LOOP_MESHES if dp * div == 2]
    return jobs + [
        ("mesh_first4", "train", _loop_cfg(2, 1, steps=4),
         dict(workdir=str(tmp / "mesh_first4"))),
        ("one_resumed", "train", _loop_cfg(2, 1),
         dict(workdir=str(tmp / "one_resumed"))),
        ("data", "dataset", _data_cfg(2, 1), data(2, "data")),
        ("data_first", "dataset", _data_cfg(2, 1), data(1, "data_r")),
        ("data_resumed", "dataset", _data_cfg(2, 1), data(2, "data_r")),
        ("misfit", "train", _loop_cfg(2, 2), dict(workdir=""))]


def _four_rank_jobs(tmp):
    """Four gloo ranks' jobs: the loop at (2,2), and as 4 + 4 steps."""
    return [("loop_2x2", "train", _loop_cfg(2, 2),
             dict(workdir=str(tmp / "loop_2x2"))),
            ("first4", "train", _loop_cfg(2, 2, steps=4),
             dict(workdir=str(tmp / "resumed"))),
            ("resumed", "train", _loop_cfg(2, 2),
             dict(workdir=str(tmp / "resumed")))]


@pytest.fixture(scope="module")
def ranks(one_process, tmp_path_factory):
    """Both spawns: the two ranks' jobs run in a thread while JAX's knob
    steps compile here; then four ranks take the (2,2) loop jobs, every
    knob's JAX steps on the (2,2) mesh, and the global knobs' first step
    on (4,1) and (1,4)."""
    two_tmp, four_tmp = (tmp_path_factory.mktemp(name)
                         for name in ("two", "four"))
    with ThreadPoolExecutor(1) as pool:
        two = pool.submit(run_ranks, multi_rank_train_worker, 2, two_tmp,
                          _two_rank_jobs(one_process, two_tmp), [],
                          timeout=300)
        refs, runs = {}, []
        for knob in KNOBS:
            n = 3 if knob in TRACKER_KNOBS else 1
            cfg, start, steps, jmetrics, jstates = _jax_knob_run(knob, n)
            refs[knob] = (cfg, jmetrics, jstates)
            meshes = [KNOB_MESH] + (UNEVEN_MESHES if knob in UNEVEN_KNOBS
                                    else [])
            runs += [(knob, cfg, mesh, start, steps if mesh == KNOB_MESH
                      else steps[:1]) for mesh in meshes]
        four = run_ranks(multi_rank_train_worker, 4, four_tmp,
                         _four_rank_jobs(four_tmp), runs, timeout=300)
        two = two.result()
    return {"two": (two_tmp, [out["train"] for out in two]),
            "four": (four_tmp, [out["train"] for out in four],
                     [out["knobs"] for out in four], refs)}


@pytest.fixture(scope="module")
def two_ranks(ranks):
    return ranks["two"]


@pytest.fixture(scope="module")
def four_ranks(ranks):
    return ranks["four"]


# ------------------------------------------------------------ the loop


def _mesh_loop(two_ranks, four_ranks, dp, div):
    tmp, outs = four_ranks[:2] if dp * div == 4 else two_ranks
    return tmp / f"loop_{dp}x{div}", [out[f"loop_{dp}x{div}"] for out in outs]


@pytest.mark.parametrize("mesh", LOOP_MESHES)
def test_loop_on_a_mesh_matches_one_process(one_process, two_ranks,
                                            four_ranks, mesh):
    """8 steps with a checkpoint and an eval point inside: every rank's
    history within STEP_TOL of the one-process loop's, the replicas
    bitwise, and the workdir written by rank 0 alone."""
    workdir, outs = _mesh_loop(two_ranks, four_ranks, *mesh)
    _, history = one_process["loop"]
    want = [{k: v for k, v in r.items() if k not in CLOCKS} for r in history]
    for rows, _, _ in outs:
        _assert_rows_close(rows, want)
    _assert_replicas_equal([snap for _, snap, _ in outs])
    one_dir = one_process["tmp"] / "loop"
    _assert_rows_close(_rows(workdir), _rows(one_dir))
    _assert_rows_close(_rows(workdir, "eval"), _rows(one_dir, "eval"))
    assert ckpt.all_steps(str(workdir)) == [4, 8]
    assert os.path.exists(workdir / "config.json")
    assert outs[0][2]["save_checkpoint"] >= 2 and outs[0][2]["save_config"]
    assert all(not calls for _, _, calls in outs[1:])


def test_a_resumed_mesh_run_is_bitwise_the_whole_one(four_ranks):
    """(2,2): 4 steps, then a restart from the workdir to 8, bitwise the
    8-step run: the rows after step 4 and every tensor of the state."""
    tmp, outs = four_ranks[:2]
    for out in outs:
        whole, resumed = out["loop_2x2"], out["resumed"]
        assert resumed[0] == [r for r in whole[0] if r["step"] > 4]
        _assert_snapshots_equal(resumed[1], whole[1])
    assert _rows(tmp / "resumed") == _rows(tmp / "loop_2x2")


def test_a_mesh_checkpoint_resumes_in_one_process(one_process, two_ranks):
    """A (2,1) run's step-4 checkpoint restores in one process to the
    ranks' state, bitwise, and trains on to the one-process run's rows."""
    tmp, outs = two_ranks
    workdir = str(tmp / "mesh_first4")
    restored = ckpt.restore_latest(workdir, create_train_state(
        _loop_cfg(), device="cpu"))
    for out in outs:
        _assert_snapshots_equal(state_snapshot(restored),
                                out["mesh_first4"][1])
    state, history = loop.train(_loop_cfg(), workdir=workdir, echo=False,
                                device="cpu")
    assert state.step == LOOP_STEPS
    want = [r for r in one_process["loop"][1] if r["step"] > 4]
    _assert_rows_close([{k: v for k, v in r.items() if k not in CLOCKS}
                        for r in history],
                       [{k: v for k, v in r.items() if k not in CLOCKS}
                        for r in want])


def test_a_one_process_checkpoint_resumes_on_a_mesh(one_process, two_ranks):
    """The one process's step-4 checkpoint, resumed by two ranks to 8:
    the rows within STEP_TOL of the one-process run's, the replicas
    bitwise."""
    _, outs = two_ranks
    want = [{k: v for k, v in r.items() if k not in CLOCKS}
            for r in one_process["loop"][1] if r["step"] > 4]
    for rows, _, _ in (out["one_resumed"] for out in outs):
        _assert_rows_close(rows, want)
    _assert_replicas_equal([out["one_resumed"][1] for out in outs])


def test_train_from_dataset_on_a_mesh_matches_one_process(one_process,
                                                          two_ranks):
    """train_from_dataset at (2,1), 2 epochs with the held-out eval: the
    last row within STEP_TOL of the one-process run's, the replicas
    bitwise."""
    tmp, outs = two_ranks
    _, want = one_process["data_run"]
    for (last,), _, _ in (out["data"] for out in outs):
        _assert_rows_close([last], [{k: v for k, v in want.items()
                                     if k not in CLOCKS}])
    _assert_replicas_equal([out["data"][1] for out in outs])
    _assert_rows_close(_rows(tmp / "data", "eval"),
                       _rows(one_process["tmp"] / "data", "eval"))


def test_train_from_dataset_on_a_mesh_resumes_bitwise(two_ranks):
    """1 epoch, then a restart to 2: bitwise the 2-epoch run."""
    tmp, outs = two_ranks
    for out in outs:
        _assert_snapshots_equal(out["data_resumed"][1], out["data"][1])
        assert out["data_resumed"][0] == out["data"][0]
    steps = [r["step"] for r in _rows(tmp / "data")]
    assert [r for r in _rows(tmp / "data_r") if r["step"] > steps[-1] // 2] \
        == [r for r in _rows(tmp / "data") if r["step"] > steps[-1] // 2]


def test_train_from_dataset_on_a_mesh_writes_once(two_ranks):
    """Rank 0 writes the dataset marker, the config and the checkpoints;
    rank 1 writes nothing, and each metrics row appears once."""
    tmp, outs = two_ranks
    calls0, calls1 = outs[0]["data"][2], outs[1]["data"][2]
    assert calls0["_write_dataset_marker"] == 1 and calls0["save_config"] == 1
    assert calls0["save_checkpoint"] >= 2
    assert calls1 == {}
    steps = [r["step"] for r in _rows(tmp / "data")]
    assert steps == sorted(set(steps))
    assert os.path.exists(tmp / "data" / "dataset_run.json")


def test_a_world_that_does_not_fit_the_mesh_raises(two_ranks):
    """A (2,2) config on two ranks: ValueError naming both shapes, on
    every rank, before any step."""
    _, outs = two_ranks
    for out in outs:
        kind, message = out["misfit"]
        assert kind == "error"
        assert "(2x2) needs 4 ranks" in message and "has 2" in message


# --------------------------------------------------------- the knobs


def _knob_outs(four_ranks, knob, mesh):
    return [out[knob, *mesh] for out in four_ranks[2]]


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_knob_on_a_mesh_matches_jax(four_ranks, knob):
    """One step of the knob's config on four ranks at (2,2) against JAX's
    unsharded step on the same draws: every metric (the knob's own
    included), params, EMA, Adam moments and the trackers, on every rank;
    the replicas bitwise."""
    cfg, jmetrics, jstates = four_ranks[3][knob]
    outs = _knob_outs(four_ranks, knob, KNOB_MESH)
    for metrics, snaps in outs:
        assert set(metrics[0]) == set(jmetrics[0])
        assert set(KNOB_METRICS.get(knob, ())) <= set(metrics[0])
        _assert_metrics_close(metrics[0], jmetrics[0], metrics[0].keys())
        state = state_from_snapshot(cfg, snaps[0])
        _assert_state_close(jstates[0], state, 1)
        _assert_trackers_close(jstates[0], state)
    _assert_replicas_equal([snaps[0] for _, snaps in outs])
    if knob == "d_reset_every":
        assert outs[0][1][0]["d_opt"]["count"] == 0


@pytest.mark.parametrize("knob", TRACKER_KNOBS)
def test_tracker_knobs_three_steps_on_a_mesh_match_jax(four_ranks, knob):
    """LeCam's anchors and ADA's p feed the next step: three steps at
    (2,2), the losses step by step and the state and trackers at the
    end, against JAX's."""
    cfg, jmetrics, jstates = four_ranks[3][knob]
    outs = _knob_outs(four_ranks, knob, KNOB_MESH)
    for metrics, snaps in outs:
        for got, want in zip(metrics, jmetrics):
            _assert_metrics_close(got, want, set(got) - {"g_ndiv",
                                                         "g_total"})
        state = state_from_snapshot(cfg, snaps[-1])
        _assert_state_close(jstates[-1], state, 3)
        _assert_trackers_close(jstates[-1], state)
    _assert_replicas_equal([snaps[-1] for _, snaps in outs])
    if knob == "ada_target":
        assert [m["ada_p"] for m in outs[0][0]] == pytest.approx(
            [m["ada_p"] for m in jmetrics])
    else:
        assert float(outs[0][1][-1]["lecam_ema"]["real"]) != 0.0


@pytest.mark.parametrize("mesh", UNEVEN_MESHES)
@pytest.mark.parametrize("knob", UNEVEN_KNOBS)
def test_global_knobs_on_uneven_meshes_match_jax(four_ranks, knob, mesh):
    """Top-k over every fake, the feature means and the floor across the
    div axis, on (4,1) and (1,4): one step against JAX's."""
    cfg, jmetrics, jstates = four_ranks[3][knob]
    outs = _knob_outs(four_ranks, knob, mesh)
    for metrics, snaps in outs:
        _assert_metrics_close(metrics[0], jmetrics[0], metrics[0].keys())
        _assert_state_close(jstates[0], state_from_snapshot(cfg, snaps[0]),
                            1)
    _assert_replicas_equal([snaps[0] for _, snaps in outs])


# ------------------------------------------------------------ the CLI


def test_cli_train_under_torchrun(tmp_path):
    """`cli train --device cpu` on two torchrun ranks (gloo): one JSON line
    from rank 0 naming the mesh and the backend, one metrics.jsonl, and a
    one-process `cli eval` reads the workdir."""
    workdir = str(tmp_path / "run")
    small = ["--preset", "pod_dp", "--device", "cpu", "--batch-size", "16",
             "--k", "8", "--set", "g_hidden=32", "--set", "d_hidden=32",
             "--set", "cond_embed_dim=8", "--set", "compute_dtype=f32",
             "--set", "eval_suite_scenes=8", "--workdir", workdir]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "ndivplanning_tpu_torch.cli",
         "train", *small, "--dp-shards", "2", "--steps", "4"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1, out.stdout
    assert lines[0]["final_step"] == 4
    assert (lines[0]["mesh"], lines[0]["backend"], lines[0]["world"]) == (
        "2x1", "gloo", 2)
    rows = _rows(workdir)
    assert [r["step"] for r in rows] == [4]
    assert ckpt.all_steps(workdir) == [4]
    ev = subprocess.run(
        [sys.executable, "-m", "ndivplanning_tpu_torch.cli", "eval",
         *small], capture_output=True, text=True, timeout=300, env=env,
        cwd=REPO)
    assert ev.returncode == 0, ev.stderr[-3000:]
    assert "eval_success_rate" in json.loads(ev.stdout.splitlines()[-1])
