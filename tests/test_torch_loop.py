"""The torch port's train loop, chunked steps and metrics writer on the CPU.

The ported behaviours of the JAX package's ``tests/test_loop.py``,
``tests/test_train_chunk.py``, ``tests/test_metrics.py`` and
``test_determinism.py::test_run_steps_helper_matches_loop``, then what the
port adds: a resumed run bitwise equal to an uninterrupted one, the
interrupt save of an in-place state, and the one-process rule.  The two
packages' random streams never agree, so these hold the port to itself;
``tests/test_torch_evaluate.py`` holds its metrics to JAX's.
"""

import json
import os
import sys

import pytest
import torch

from ndivplanning_tpu_torch.train import loop as loop_mod
from ndivplanning_tpu_torch.train.loop import _track_best, run_steps, train
from ndivplanning_tpu_torch.train.state import create_train_state
from ndivplanning_tpu_torch.train.step import train_chunk, train_step_fused
from ndivplanning_tpu_torch.utils import checkpoint as ckpt
from ndivplanning_tpu_torch.utils.config import get_config, load_config
from ndivplanning_tpu_torch.utils.metrics import MetricsWriter, host_floats

SMALL = dict(batch_size=8, k=4, g_hidden=(32,), d_hidden=(32,),
             cond_embed_dim=8)


def _cfg(tmp, **kw):
    d = dict(SMALL, workdir=str(tmp), log_every=5, checkpoint_every=10,
             eval_every=10, steps=17)
    d.update(kw)
    return get_config("pointmass2d", **d)


def _train(cfg, **kw):
    return train(cfg, echo=False, device="cpu", **kw)


def _rows(workdir):
    with open(os.path.join(workdir, "metrics.jsonl"), encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def _restore(workdir, cfg):
    return ckpt.restore_latest(workdir, create_train_state(cfg, device="cpu"))


def _tensors(state):
    """Every tensor of a state by name: params, EMA, Adam moments, ADA."""
    out = {}
    for name, module in (("g", state.g), ("d", state.d), ("g_ema",
                                                           state.g_ema)):
        out.update({f"{name}.{k}": v for k, v in module.state_dict().items()})
    for name, opt in (("g_opt", state.g_opt), ("d_opt", state.d_opt)):
        out.update({f"{name}.mu.{k}": v for k, v in opt.mu.items()})
        out.update({f"{name}.nu.{k}": v for k, v in opt.nu.items()})
    out.update({f"ada.{k}": v for k, v in state.ada.items()})
    return out


def assert_states_bitwise_equal(a, b):
    assert (a.step, a.g_opt.count, a.d_opt.count) == (
        b.step, b.g_opt.count, b.d_opt.count)
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for name, t in ta.items():
        assert torch.equal(t, tb[name]), name
    assert torch.equal(a.rng.get_state(), b.rng.get_state())


# ------------------------------------------------------- tests/test_loop.py


def test_train_loop_boundaries_and_artifacts(tmp_path):
    cfg = _cfg(tmp_path)
    state, history = _train(cfg)
    assert state.step == 17
    # Log rows at 5, 10, 15, 17 (final).
    assert [h["step"] for h in history] == [5, 10, 15, 17]
    rows = _rows(cfg.workdir)
    kinds = {r.get("kind", "train") for r in rows}
    assert kinds == {"train", "eval"}  # no compile row: not ported
    assert [r["step"] for r in rows if r.get("kind") == "eval"] == [10, 17]
    assert os.path.isdir(os.path.join(cfg.workdir, "checkpoints"))
    assert ckpt.all_steps(cfg.workdir) == [10, 17]
    assert load_config(cfg.workdir) == cfg
    train_row = rows[0]
    assert set(train_row) == {"step", "wall_s", "d_loss", "g_adv", "g_ndiv",
                              "g_total", "d_rt", "d_rt_ema", "steps_per_sec"}


def test_train_loop_restores(tmp_path):
    cfg = _cfg(tmp_path, steps=10)
    _train(cfg)
    # A second call restores from step 10 and continues to 15.
    state, history = _train(cfg.replace(steps=15))
    assert state.step == 15
    assert history[0]["step"] == 15  # only the new window logged
    # restore=False starts over.
    state, history = _train(cfg.replace(steps=5), restore=False)
    assert state.step == 5


def test_best_checkpoint_tracking(tmp_path):
    """train() keeps <workdir>/best at the eval point with the highest
    tracked metric; the CLI's loader prefers it over the latest."""
    cfg = get_config("pointmass2d", **SMALL, log_every=5, eval_every=5,
                     checkpoint_every=10, eval_suite_scenes=32, steps=15)
    _train(cfg, workdir=str(tmp_path))
    best_dir = os.path.join(str(tmp_path), "best")
    assert ckpt.latest_step(best_dir) is not None
    best = _restore(best_dir, cfg)
    # The best checkpoint is from one of the eval boundaries (final too).
    assert best.step in (5, 10, 15)
    evs = [r for r in _rows(str(tmp_path)) if r.get("kind") == "eval"]
    assert evs and "eval_success_rate" in evs[0]
    marker = json.load(open(os.path.join(best_dir, "best_path.json"),
                            encoding="utf-8"))
    assert marker["metric"] == "eval_success_rate"
    assert marker["step"] == best.step
    assert marker["value"] == max(r["eval_success_rate"] for r in evs
                                  if r["step"] <= best.step)


def _goalcond_ema(**kw):
    return get_config("goalcond", **SMALL, log_every=5, eval_every=5,
                      checkpoint_every=10, eval_suite_scenes=16, steps=15,
                      g_ema_decay=0.9, **kw)


def test_best_of_both_selects_raw_winner(tmp_path, monkeypatch):
    """With EMA tracking on, both generator paths are evaluated; a raw win
    saves <workdir>/best with the raw weights in the EMA slot, and
    best_path.json says 'raw'."""
    cfg = _goalcond_ema()

    def fake_eval(cfg_, state_, n_scenes=0, seed=0, use_ema=True):
        return {"eval_success_rate": 0.2 if use_ema else 0.9}

    monkeypatch.setattr(loop_mod, "evaluate_fixed", fake_eval)
    state, _ = _train(cfg, workdir=str(tmp_path))

    best_dir = os.path.join(str(tmp_path), "best")
    marker = json.load(open(os.path.join(best_dir, "best_path.json"),
                            encoding="utf-8"))
    assert marker["eval_path"] == "raw" and marker["value"] == 0.9
    best = _restore(best_dir, cfg)
    # The EMA slot holds the raw winner's weights, not a trailing EMA.
    for name, t in best.g.state_dict().items():
        assert torch.equal(t, best.g_ema.state_dict()[name]), name
    # The shallow copy left the live run's EMA generator alone.
    assert state.g_ema is not state.g
    assert not all(torch.equal(a, b) for a, b in zip(
        state.g.parameters(), state.g_ema.parameters()))
    evs = [r for r in _rows(str(tmp_path)) if r.get("kind") == "eval"]
    assert evs and evs[0]["raw_eval_success_rate"] == 0.9
    assert evs[0]["eval_success_rate"] == 0.2


def test_best_of_both_ema_winner_keeps_ema(tmp_path, monkeypatch):
    """When the EMA path wins, best keeps the genuine EMA weights and the
    marker says 'ema'."""
    cfg = _goalcond_ema()

    def fake_eval(cfg_, state_, n_scenes=0, seed=0, use_ema=True):
        return {"eval_success_rate": 0.9 if use_ema else 0.2}

    monkeypatch.setattr(loop_mod, "evaluate_fixed", fake_eval)
    _train(cfg, workdir=str(tmp_path))
    best_dir = os.path.join(str(tmp_path), "best")
    marker = json.load(open(os.path.join(best_dir, "best_path.json"),
                            encoding="utf-8"))
    assert marker["eval_path"] == "ema"
    best = _restore(best_dir, cfg)
    live = next(iter(best.g.state_dict().values()))
    ema = next(iter(best.g_ema.state_dict().values()))
    assert not torch.allclose(live, ema)


def test_best_metric_survives_resume(tmp_path, monkeypatch):
    """A resumed run's tracker continues from best/best_path.json: a worse
    post-resume eval does not overwrite a better saved best."""
    cfg = get_config("pointmass2d", **SMALL, log_every=5, eval_every=5,
                     checkpoint_every=10, eval_suite_scenes=16, steps=10)
    monkeypatch.setattr(loop_mod, "evaluate_fixed",
                        lambda *a, **k: {"eval_success_rate": 0.8})
    _train(cfg, workdir=str(tmp_path))
    best_dir = os.path.join(str(tmp_path), "best")
    saved_step = ckpt.latest_step(best_dir)
    assert saved_step is not None

    # Resume to step 20 with WORSE eval everywhere: best must not move.
    monkeypatch.setattr(loop_mod, "evaluate_fixed",
                        lambda *a, **k: {"eval_success_rate": 0.1})
    _train(cfg.replace(steps=20), workdir=str(tmp_path))
    marker = json.load(open(os.path.join(best_dir, "best_path.json"),
                            encoding="utf-8"))
    assert marker["value"] == 0.8
    assert ckpt.latest_step(best_dir) == saved_step

    # And a resumed IMPROVEMENT still lands.
    monkeypatch.setattr(loop_mod, "evaluate_fixed",
                        lambda *a, **k: {"eval_success_rate": 0.9})
    _train(cfg.replace(steps=30), workdir=str(tmp_path))
    marker = json.load(open(os.path.join(best_dir, "best_path.json"),
                            encoding="utf-8"))
    assert marker["value"] == 0.9


def test_nan_eval_never_wins_best(tmp_path, monkeypatch):
    """A NaN tracked metric neither saves a best checkpoint nor freezes the
    tracker."""
    cfg = get_config("pointmass2d", **SMALL, log_every=5, eval_every=5,
                     checkpoint_every=10, eval_suite_scenes=16, steps=12)
    vals = iter([float("nan"), 0.5, 0.4])  # evals at 5, 10, 12 (final)
    monkeypatch.setattr(loop_mod, "evaluate_fixed",
                        lambda *a, **k: {"eval_success_rate": next(vals)})
    _train(cfg, workdir=str(tmp_path))
    marker = json.load(open(
        os.path.join(str(tmp_path), "best", "best_path.json"),
        encoding="utf-8"))
    # The NaN eval at step 5 was skipped; the 0.5 at step 10 won.
    assert marker["value"] == 0.5
    assert marker["step"] == 10


def test_best_tracker_diversity_disqualifier(tmp_path):
    """best_min_diversity: a collapsed candidate cannot become best even
    with a better metric; healthy candidates still win; the knob off keeps
    the old behaviour."""
    cfg = get_config("pointmass2d", batch_size=8, k=4, g_hidden=(16,),
                     d_hidden=(16,), cond_embed_dim=8,
                     best_min_diversity=0.5, workdir="")
    state = create_train_state(cfg, device="cpu")
    wd = str(tmp_path / "run")

    # Collapsed high-success candidate: skipped entirely (no save).
    best = _track_best(cfg, wd, 10, [("ema", 0.9, state, 0.04)], None)
    assert best is None
    assert not os.path.exists(os.path.join(wd, "best"))

    # Healthy lower-success candidate: becomes best.
    best = _track_best(cfg, wd, 20, [("ema", 0.6, state, 0.7)], best)
    assert best == 0.6
    assert os.path.exists(os.path.join(wd, "best", "best_path.json"))

    # Mixed candidates at one eval point: the healthy one wins though the
    # collapsed one has the higher metric.
    best = _track_best(cfg, wd, 30, [("ema", 0.95, state, 0.1),
                                     ("raw", 0.7, state, 0.8)], best)
    assert best == 0.7

    # Knob off: the collapsed candidate wins again.
    cfg_off = cfg.replace(best_min_diversity=0.0)
    assert _track_best(cfg_off, str(tmp_path / "off"), 10,
                       [("ema", 0.9, state, 0.04)], None) == 0.9


@pytest.mark.parametrize("metric,values,want", [
    ("eval_success_rate", [0.3, 0.5, 0.4], 0.5),
    ("eval_endpoint_err", [0.3, 0.1, 0.2], 0.1),  # lower is better
])
def test_tracker_direction_follows_the_metric(tmp_path, metric, values, want):
    cfg = get_config("pointmass2d", **SMALL, workdir="",
                     track_best_metric=metric)
    state = create_train_state(cfg, device="cpu")
    best = None
    for step, v in enumerate(values, 1):
        best = _track_best(cfg, str(tmp_path), step,
                           [("raw", v, state, None)], best)
    assert best == want


# ------------------------------------------------- tests/test_train_chunk.py


def _chunk_cfg(**kw):
    return get_config("pointmass2d", **SMALL, **kw)


def test_chunk_matches_sequential_bitwise():
    """The port runs a chunk's steps one by one: bitwise the sequential
    steps (the JAX scan matches them at float tolerance only)."""
    cfg = _chunk_cfg()
    s_seq = create_train_state(cfg, device="cpu")
    seq = []
    for _ in range(8):
        s_seq, m = train_step_fused(cfg, s_seq)
        seq.append(m)
    s_chunk, metrics = train_chunk(cfg, create_train_state(cfg,
                                                           device="cpu"), 8)
    for key, v in metrics.items():
        assert torch.equal(v, torch.stack([m[key] for m in seq])), key
    assert_states_bitwise_equal(s_chunk, s_seq)


def test_chunk_bitwise_self_consistent():
    cfg = _chunk_cfg()

    def run():
        return train_chunk(cfg, create_train_state(cfg, device="cpu"),
                           8)[1]["g_ndiv"]

    assert torch.equal(run(), run())


def test_chunks_compose():
    cfg = _chunk_cfg(g_ema_decay=0.9, lr_schedule="cosine", steps=6)
    s1, m1 = train_chunk(cfg, create_train_state(cfg, device="cpu"), 6)
    s2, a = train_chunk(cfg, create_train_state(cfg, device="cpu"), 3)
    s2, b = train_chunk(cfg, s2, 3)
    for key in m1:
        assert torch.equal(m1[key], torch.cat([a[key], b[key]])), key
    assert_states_bitwise_equal(s1, s2)


def test_chunk_metrics_shape():
    cfg = _chunk_cfg()
    _, metrics = train_chunk(cfg, create_train_state(cfg, device="cpu"), 5)
    assert set(metrics) == {"d_loss", "g_adv", "g_ndiv", "g_total", "d_rt",
                            "d_rt_ema"}
    for key, v in metrics.items():
        assert v.shape == (5,) and v.dtype == torch.float32, key
        assert torch.isfinite(v).all(), key
    with pytest.raises(ValueError, match="n_steps must be >= 1"):
        train_chunk(cfg, create_train_state(cfg, device="cpu"), 0)


def test_run_steps_helper_matches_loop():
    cfg = _chunk_cfg(seed=11)
    s_a, m_a = run_steps(cfg, create_train_state(cfg, device="cpu"), 10)
    s_b = create_train_state(cfg, device="cpu")
    for _ in range(10):
        s_b, m_b = train_step_fused(cfg, s_b)
    assert torch.equal(m_a["g_ndiv"], m_b["g_ndiv"])
    assert_states_bitwise_equal(s_a, s_b)


# ---------------------------------------------------- resume, interrupt, ranks


def test_resumed_run_is_bitwise_the_uninterrupted_one(tmp_path):
    """0 -> 6 in one call against 0 -> 4 and a fresh state resuming from
    the workdir to 6: the final states are bitwise equal (params, EMA, Adam,
    ADA, the generator's state), and so are the metric rows from step 4 on
    but for their clocks."""
    cfg = get_config("goalcond", **SMALL, g_ema_decay=0.9,
                     lr_schedule="cosine", steps=6, log_every=2,
                     checkpoint_every=2, eval_every=2, eval_suite_scenes=16)
    run_a, run_b = str(tmp_path / "a"), str(tmp_path / "b")
    state_a, _ = _train(cfg, workdir=run_a)
    _train(cfg, workdir=run_b, num_steps=4)
    state_b, history = _train(cfg, workdir=run_b)
    assert [h["step"] for h in history] == [6]
    assert_states_bitwise_equal(state_a, state_b)
    clocks = ("wall_s", "steps_per_sec")

    def rows(run):
        return [{k: v for k, v in r.items() if k not in clocks}
                for r in _rows(run) if r["step"] >= 4]

    assert rows(run_a) == rows(run_b)
    assert len(rows(run_a)) == 4  # train and eval rows at 4 and 6
    assert_states_bitwise_equal(_restore(run_a, cfg), _restore(run_b, cfg))


def test_interrupt_between_steps_saves_the_state(tmp_path, monkeypatch):
    cfg = _cfg(tmp_path, log_every=2, checkpoint_every=100, eval_every=0)
    calls = []

    def chunk(cfg_, state, n):
        calls.append(n)
        if len(calls) == 3:
            raise KeyboardInterrupt
        return train_chunk(cfg_, state, n)

    monkeypatch.setattr(loop_mod, "train_chunk", chunk)
    with pytest.raises(KeyboardInterrupt):
        _train(cfg)
    assert ckpt.all_steps(cfg.workdir) == [4]
    assert _restore(cfg.workdir, cfg).g_opt.count == 4


def test_interrupt_inside_a_step_saves_nothing(tmp_path, monkeypatch):
    """The step updates the state in place: an interrupt after D's update
    and before G's leaves a half-updated state, which is not saved."""
    cfg = _cfg(tmp_path, log_every=2, checkpoint_every=100, eval_every=0)
    calls = []

    def chunk(cfg_, state, n):
        calls.append(n)
        if len(calls) == 3:
            def interrupted(module, grads):
                raise KeyboardInterrupt
            state.g_opt.step = interrupted
        return train_chunk(cfg_, state, n)

    monkeypatch.setattr(loop_mod, "train_chunk", chunk)
    with pytest.raises(KeyboardInterrupt):
        _train(cfg)
    assert ckpt.all_steps(cfg.workdir) == []


def test_sharded_config_trains_in_one_process_over_the_global_batch():
    """dp_shards * div_shards > 1 runs without a mesh: bitwise the
    unsharded run of the same config."""
    cfg = _chunk_cfg(steps=3, log_every=3, checkpoint_every=0, eval_every=0)
    plain, _ = _train(cfg, workdir="")
    for shards in (dict(dp_shards=2), dict(div_shards=2)):
        sharded, _ = _train(cfg.replace(**shards), workdir="")
        assert_states_bitwise_equal(sharded, plain)


def test_multi_rank_loop_is_not_ported_yet(monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="multi-rank loop"):
        _train(_chunk_cfg(), workdir="")


# ------------------------------------------------------ tests/test_metrics.py


def test_jsonl_rows(tmp_path, capsys):
    w = MetricsWriter(str(tmp_path), echo=True)
    w.write(1, {"loss": 0.5})
    w.write(2, {"loss": torch.tensor(0.25)}, kind="eval")
    w.close()
    rows = _rows(str(tmp_path))
    assert rows[0]["step"] == 1 and rows[0]["loss"] == 0.5
    assert rows[1]["kind"] == "eval" and rows[1]["loss"] == 0.25
    assert "wall_s" in rows[0]
    err = capsys.readouterr().err.splitlines()
    assert err == ["[metrics] step=1 loss=0.5",
                   "[metrics] step=2 loss=0.25 kind=eval"]


def test_no_workdir_is_fine(tmp_path):
    for workdir in (None, ""):
        w = MetricsWriter(workdir, echo=False)
        w.write(1, {"x": 1.0})
        w.close()


def test_tensorboard_backend(tmp_path):
    pytest.importorskip("tensorboard")
    w = MetricsWriter(str(tmp_path), echo=False, tensorboard=True)
    w.write(1, {"loss": 0.5})
    w.close()
    assert os.path.isdir(tmp_path / "tb")
    assert any(os.scandir(tmp_path / "tb"))


def test_tensorboard_without_its_package_raises_naming_it(tmp_path,
                                                          monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="'tensorboard' package"):
        MetricsWriter(str(tmp_path), echo=False, tensorboard=True)
    assert not os.path.exists(tmp_path / "metrics.jsonl")


def test_host_floats_reads_tensors_and_numbers():
    out = host_floats({"a": torch.tensor(0.5), "b": 2, "c": torch.tensor(
        1.5, dtype=torch.float64)})
    assert out == {"a": 0.5, "b": 2.0, "c": 1.5}
    assert list(out) == ["a", "b", "c"]
    assert host_floats({}) == {}


def test_the_loop_and_eval_default_to_the_card(monkeypatch):
    """train, the frozen suite and the CLI's train and eval run on the card
    unless asked for the CPU: without one they raise, never fall back."""
    from ndivplanning_tpu_torch.cli import main
    from ndivplanning_tpu_torch.train.evaluate import make_eval_suite

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _chunk_cfg()
    for call in (lambda: train(cfg, workdir="", echo=False),
                 lambda: make_eval_suite(cfg, 4),
                 lambda: main(["train", "--preset", "pointmass2d",
                               "--workdir", ""]),
                 lambda: main(["eval", "--preset", "pointmass2d",
                               "--workdir", ""])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
