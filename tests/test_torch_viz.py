"""The port's plots (``utils/viz.py``) against the JAX package's: the
same scene and arrays through both give the same rendered RGBA buffers
(the port's taking torch tensors, with autograd history), and
``plot_run_curves`` counts the same rows of one ``metrics.jsonl``.  On a
host without matplotlib the port draws with Pillow."""

import json

import numpy as np
import pytest
import torch

pytest.importorskip("matplotlib")

from ndivplanning_tpu.envs.types import Scene as JaxScene  # noqa: E402
from ndivplanning_tpu.utils import viz as jax_viz  # noqa: E402
from ndivplanning_tpu_torch.envs.types import Scene  # noqa: E402
from ndivplanning_tpu_torch.train.loop import train  # noqa: E402
from ndivplanning_tpu_torch.utils import viz  # noqa: E402
from ndivplanning_tpu_torch.utils.config import get_config  # noqa: E402

START, GOAL = [0.1, 0.15], [0.9, 0.85]
OBSTACLES = [[0.5, 0.5, 0.1], [0.3, 0.7, 0.08]]


def _rgba(fig) -> np.ndarray:
    import matplotlib.pyplot as plt

    fig.canvas.draw()
    out = np.asarray(fig.canvas.buffer_rgba()).copy()
    plt.close(fig)
    return out


def _scenes():
    return (JaxScene.create(START, GOAL, OBSTACLES),
            Scene.create(START, GOAL, OBSTACLES, device="cpu"))


def _tensor(a):
    """A float32 tensor with autograd history, as a planner's output may
    carry."""
    return torch.tensor(a, dtype=torch.float32, requires_grad=True) * 1.0


def _arrays():
    rng = np.random.default_rng(0)
    return (rng.uniform(0, 1, (8, 32, 2)).astype(np.float32),
            rng.uniform(size=(8,)).astype(np.float32))


@pytest.mark.parametrize("with_scores", [True, False])
def test_plot_trajectories_renders_as_jax(with_scores):
    jscene, scene = _scenes()
    taus, scores = _arrays()
    want = jax_viz.plot_trajectories(
        jscene, taus, scores if with_scores else None, title="t",
        highlight=taus[0])
    got = viz.plot_trajectories(
        scene, _tensor(taus), _tensor(scores) if with_scores else None,
        title="t", highlight=_tensor(taus[0]))
    np.testing.assert_array_equal(_rgba(got), _rgba(want))


def test_plot_loss_curves_renders_as_jax():
    history = [{"step": s, "d_loss": 1.0 / (s + 1), "g_adv": 0.5,
                "g_ndiv": 0.1} for s in range(10)]
    np.testing.assert_array_equal(_rgba(viz.plot_loss_curves(history)),
                                  _rgba(jax_viz.plot_loss_curves(history)))


def test_plot_mpc_episode_renders_as_jax():
    jscene, scene = _scenes()
    positions = np.linspace(START, GOAL, 64).astype(np.float32)
    want = jax_viz.plot_mpc_episode(jscene, positions, reached=1.0,
                                    collided=0.0, replan_every=8, title="e")
    got = viz.plot_mpc_episode(scene, _tensor(positions),
                               reached=torch.tensor(1.0),
                               collided=torch.tensor(0.0), replan_every=8,
                               title="e")
    np.testing.assert_array_equal(_rgba(got), _rgba(want))


def test_plot_run_curves_renders_and_counts_as_jax(tmp_path):
    """One metrics.jsonl of the port's loop (train, eval and compile rows)
    through both."""
    cfg = get_config("goalcond", batch_size=8, k=4, g_hidden=(32,),
                     d_hidden=(32,), cond_embed_dim=8, steps=6, log_every=2,
                     eval_every=3, checkpoint_every=0, eval_suite_scenes=16)
    train(cfg, workdir=str(tmp_path), echo=False, device="cpu")
    with open(tmp_path / "metrics.jsonl", encoding="utf-8") as f:
        rows = [json.loads(line) for line in f]
    assert {r.get("kind") for r in rows} == {None, "eval", "compile"}
    fig, n_train, n_eval = viz.plot_run_curves(rows, title="run")
    jfig, jn_train, jn_eval = jax_viz.plot_run_curves(rows, title="run")
    assert (n_train, n_eval) == (jn_train, jn_eval) == (4, 2)
    np.testing.assert_array_equal(_rgba(fig), _rgba(jfig))


def test_plots_save_pngs(tmp_path):
    _, scene = _scenes()
    taus, scores = _arrays()
    viz.plot_trajectories(scene, taus, scores, path=str(tmp_path / "t.png"))
    viz.plot_mpc_episode(scene, taus[0], replan_every=4,
                         path=str(tmp_path / "m.png"))
    for name in ("t", "m"):
        assert (tmp_path / f"{name}.png").stat().st_size > 1000


def test_without_matplotlib_pillow_draws_every_plot(tmp_path, monkeypatch):
    from PIL import Image

    monkeypatch.setattr(viz, "_mpl", lambda: None)
    _, scene = _scenes()
    taus, scores = _arrays()
    rows = [{"step": s, "d_loss": 1.0, "g_adv": 0.5, "g_ndiv": 0.1,
             "g_total": 0.6} for s in range(0, 500, 50)]
    rows += [{"step": s, "kind": "eval", "eval_success_rate": 0.5}
             for s in (200, 400)]
    outs = {
        "t": viz.plot_trajectories(scene, _tensor(taus), _tensor(scores),
                                   highlight=taus[0],
                                   path=str(tmp_path / "t.png")),
        "l": viz.plot_loss_curves(rows[:10], path=str(tmp_path / "l.png")),
        "m": viz.plot_mpc_episode(scene, taus[0], replan_every=4,
                                  path=str(tmp_path / "m.png")),
    }
    img, n_train, n_eval = viz.plot_run_curves(rows,
                                               path=str(tmp_path / "c.png"))
    assert (n_train, n_eval) == (10, 2)
    outs["c"] = img
    for name, image in outs.items():
        assert isinstance(image, Image.Image)
        with Image.open(tmp_path / f"{name}.png") as png:
            assert png.size == image.size
            # Something beyond the white background was drawn.
            assert len(png.getcolors(1 << 16)) > 2
