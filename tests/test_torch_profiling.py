"""The port's profiling, NaN debugging and compile counting
(``utils/profiling.py``, ``utils/compile_guard.py``) on the CPU, against
the JAX package's ``utils/profiling.py`` and its loop's compile row."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndivplanning_tpu.data.tasks import make_task as jax_make_task
from ndivplanning_tpu.train.loop import train as jax_train
from ndivplanning_tpu.train.state import create_train_state as jax_create
from ndivplanning_tpu.train.step import train_step as jax_train_step
from ndivplanning_tpu.utils.config import get_config as jax_get_config
from ndivplanning_tpu.utils.profiling import (
    enable_nan_debugging as jax_enable_nan_debugging,
)
from ndivplanning_tpu_torch.data.tasks import make_task
from ndivplanning_tpu_torch.train.loop import train
from ndivplanning_tpu_torch.train.state import create_train_state
from ndivplanning_tpu_torch.train.step import train_step_impl
from ndivplanning_tpu_torch.utils import compile_guard
from ndivplanning_tpu_torch.utils.config import get_config
from ndivplanning_tpu_torch.utils.profiling import (
    StepTimer,
    check_finite,
    device_sync,
    enable_nan_debugging,
    trace,
)

SMALL = dict(batch_size=8, k=4, g_hidden=(32,), d_hidden=(32,),
             cond_embed_dim=8)


@pytest.fixture(autouse=True)
def _nan_debugging_off():
    yield
    enable_nan_debugging(False)
    jax_enable_nan_debugging(False)


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with trace(str(tmp_path)):
        (torch.ones((8, 8)) @ torch.ones((8, 8))).sum()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_trace_writes_its_trace_when_the_region_raises(tmp_path):
    with pytest.raises(ValueError):
        with trace(str(tmp_path)):
            torch.ones(3).sum()
            raise ValueError("inside")
    assert len(os.listdir(tmp_path)) == 1


def test_step_timer_and_device_sync():
    x = torch.ones((8, 8))
    timer = StepTimer()
    timer.start(sync_on=x)
    for _ in range(5):
        x = x * 1.0000001
        timer.lap()
    assert timer.rate(sync_on=x) > 0
    device_sync(x)
    device_sync({"a": x, "b": [x, 3]})
    device_sync([])


def test_nan_debugging_toggles_anomaly_mode_as_jax_toggles_debug_nans():
    enable_nan_debugging(True)
    jax_enable_nan_debugging(True)
    assert torch.is_anomaly_enabled()
    assert jax.config.jax_debug_nans
    enable_nan_debugging(False)
    jax_enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()
    assert not jax.config.jax_debug_nans


def test_check_finite_names_the_first_non_finite_tensor():
    good, bad = torch.ones(3), torch.tensor([1.0, float("nan")])
    check_finite("off", {"x": bad})  # a no-op while debugging is off
    enable_nan_debugging(True)
    check_finite("clean", {"x": good, "i": torch.arange(3)})
    with pytest.raises(FloatingPointError, match="where: .*'y'"):
        check_finite("where", {"x": good, "y": bad, "z": bad})


def _nan_batch_steps(preset):
    """One step of each package on a batch whose trajectories are NaN."""
    jcfg = jax_get_config(preset, **SMALL)
    jbatch = jax_make_task(jcfg).sample(jax.random.PRNGKey(0), 8)
    jbatch = dataclasses.replace(jbatch, real_traj=jnp.full_like(
        jbatch.real_traj, jnp.nan))
    cfg = get_config(preset, **SMALL)
    state = create_train_state(cfg, device="cpu")
    batch = make_task(cfg).sample(state.rng, 8)
    batch = dataclasses.replace(batch, real_traj=torch.full_like(
        batch.real_traj, float("nan")))
    return (lambda: jax_train_step(jcfg, jax_create(jcfg), jbatch),
            lambda: train_step_impl(cfg, state, batch))


@pytest.mark.parametrize("preset", ["goalcond", "pointmass2d"])
def test_a_nan_batch_raises_under_nan_debugging_as_in_jax(preset):
    """With NaN debugging on, a step fed NaN trajectories raises
    FloatingPointError in both packages; off, both run through to NaN
    losses.  (Debugging first: JAX checks only a jit call that compiles
    under it.)"""
    jax_step, step = _nan_batch_steps(preset)
    jax_enable_nan_debugging(True)
    with pytest.raises(FloatingPointError):
        jax.block_until_ready(jax_step())
    enable_nan_debugging(True)
    with pytest.raises(FloatingPointError, match="D's forward"):
        step()
    jax_enable_nan_debugging(False)
    enable_nan_debugging(False)
    jax_step, step = _nan_batch_steps(preset)
    _, jm = jax_step()
    _, m = step()
    assert np.isnan(float(jm["d_loss"])) and np.isnan(float(m["d_loss"]))


def test_a_clean_run_is_bitwise_the_same_with_nan_debugging():
    cfg = get_config("goalcond", **SMALL, lr_schedule="cosine", steps=5)
    runs = []
    for debug in (False, True):
        enable_nan_debugging(debug)
        state, _ = train(cfg, workdir="", echo=False, device="cpu")
        runs.append(state)
    a, b = ({**dict(s.g.named_parameters()), **{
        f"d.{k}": v for k, v in s.d.named_parameters()}} for s in runs)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_count_compiles_counts_builds_and_dynamo_graphs():
    with compile_guard.count_compiles() as rec:
        compile_guard.record_compile("cuda_build", "libndiv_x.so", 1.5)
        compile_guard.record_compile("native_build", "libndivhost_y.so",
                                     0.25)
        fn = torch.compile(lambda x: x * 2 + 1, backend="eager")
        fn(torch.ones(3))
    compile_guard.record_compile("cuda_build", "after.so", 9.0)
    assert rec.row() == {"compiles": 3, "cuda_builds": 1, "native_builds": 1,
                         "dynamo_graphs": 1, "compile_secs": 1.75}
    assert rec.names == ["libndiv_x.so", "libndivhost_y.so"]


def test_the_loop_writes_its_compile_row_where_jax_does(tmp_path):
    """Both loops end their metrics with one ``kind="compile"`` row at the
    final step, after the last train and eval rows (under each package's
    own keys)."""
    over = dict(**SMALL, steps=4, log_every=2, eval_every=4,
                checkpoint_every=4, eval_suite_scenes=16)
    jax_train(jax_get_config("goalcond", **over),
              workdir=str(tmp_path / "jax"), echo=False)
    train(get_config("goalcond", **over), workdir=str(tmp_path / "torch"),
          echo=False, device="cpu")
    kinds = {}
    for name in ("jax", "torch"):
        with open(tmp_path / name / "metrics.jsonl", encoding="utf-8") as f:
            rows = [json.loads(line) for line in f]
        kinds[name] = [(r["step"], r.get("kind", "train")) for r in rows]
    assert kinds["torch"] == kinds["jax"] == [
        (2, "train"), (4, "train"), (4, "eval"), (4, "compile")]
