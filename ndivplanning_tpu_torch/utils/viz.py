"""Trajectory, scene and training-curve plots; counterpart of ``ndivplanning_tpu/utils/viz.py``.

The plot functions are the JAX package's, drawing with matplotlib (Agg,
imported lazily), and take torch tensors on any device as well as arrays:
every input goes to the host through :func:`_host` first.  On a host
without matplotlib they draw the same content with Pillow instead (no
colormap, no legend, not pixel-identical) and return a ``PIL.Image`` where
matplotlib's versions return the figure.
"""

from __future__ import annotations

import numpy as np


def _host(x) -> np.ndarray:
    """An array on the host: a tensor leaves its device (and its graph)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _mpl():
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_scene(ax, scene) -> None:
    """Draw bounds, obstacles, start (o) and goal (*) for one Scene."""
    obstacles = _host(scene.obstacles)
    mask = _host(scene.obstacle_mask)
    from matplotlib.patches import Circle

    for row, live in zip(obstacles, mask):
        if live > 0.5:
            ax.add_patch(Circle((row[0], row[1]), row[2], color="0.7"))
    start, goal = _host(scene.start), _host(scene.goal)
    ax.plot(*start, "go", markersize=9, label="start")
    ax.plot(*goal, "r*", markersize=13, label="goal")
    ax.set_xlim(-0.02, 1.02)
    ax.set_ylim(-0.02, 1.02)
    ax.set_aspect("equal")


def plot_trajectories(scene, taus, scores=None, path: str | None = None,
                      title: str = "", highlight=None):
    """Plot candidate trajectories ``taus: [N, H, 2]`` over a scene.

    If ``scores`` is given, colors run best (dark) to worst (light).
    ``highlight``: optional single ``[H, 2]`` trajectory drawn bold on
    top (e.g. the planner's best candidate).
    Returns the figure; saves to ``path`` if given.
    """
    plt = _mpl()
    taus = _host(taus)
    if plt is None:
        canvas = _SceneCanvas(scene)
        n = taus.shape[0]
        order = (np.argsort(_host(scores))[::-1] if scores is not None
                 else np.arange(n))
        for rank, i in enumerate(order):  # worst first, best on top
            canvas.line(taus[i], _ramp(1.0 - rank / max(n - 1, 1)))
        if highlight is not None:
            canvas.line(_host(highlight), (220, 20, 60), width=4)
        return canvas.finish(path)
    fig, ax = plt.subplots(figsize=(5, 5))
    plot_scene(ax, scene)
    n = taus.shape[0]
    if scores is not None:
        order = np.argsort(_host(scores))
        colors = plt.cm.viridis(np.linspace(0, 0.9, n))
        for rank, i in enumerate(order[::-1]):  # worst first, best on top
            ax.plot(taus[i, :, 0], taus[i, :, 1], "-",
                    color=colors[n - 1 - rank], lw=1, alpha=0.6)
    else:
        for i in range(n):
            ax.plot(taus[i, :, 0], taus[i, :, 1], "-", lw=1, alpha=0.6)
    if highlight is not None:
        h = _host(highlight)
        ax.plot(h[:, 0], h[:, 1], "-", color="crimson", lw=2.5,
                label="best")
        ax.legend(loc="lower right")
    ax.set_title(title)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_loss_curves(history, path: str | None = None):
    """history: list of dict rows with 'step' and loss scalars."""
    plt = _mpl()
    steps = [h["step"] for h in history]
    keys = [key for key in ("d_loss", "g_adv", "g_ndiv")
            if history and key in history[0]]
    if plt is None:
        canvas = _CurveCanvas(1)
        canvas.panel(0, [(steps, [h[key] for h in history]) for key in keys])
        return canvas.finish(path)
    fig, ax = plt.subplots(figsize=(6, 4))
    for key in keys:
        ax.plot(steps, [h[key] for h in history], label=key)
    ax.set_xlabel("step")
    ax.legend()
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_mpc_episode(scene, positions, reached=None, collided=None,
                     replan_every: int | None = None,
                     path: str | None = None, title: str = ""):
    """Render one closed-loop MPC episode: the executed path colored by
    time, with replan points marked.

    ``positions: [T, 2]`` executed states; ``replan_every`` marks every
    k-th state (where a new plan was drawn).  Returns the figure; saves
    to ``path`` if given.
    """
    plt = _mpl()
    pos = _host(positions)
    if plt is None:
        canvas = _SceneCanvas(scene)
        t = np.linspace(0.0, 1.0, len(pos))
        for i in range(len(pos) - 1):
            canvas.line(pos[i:i + 2], _ramp(t[i]), width=3)
        if replan_every:
            for p in pos[::replan_every]:
                canvas.marker(p, (0, 0, 0), 4, fill=False)
        return canvas.finish(path)
    fig, ax = plt.subplots(figsize=(5, 5))
    plot_scene(ax, scene)
    t = np.linspace(0.0, 1.0, len(pos))
    for i in range(len(pos) - 1):
        ax.plot(pos[i:i + 2, 0], pos[i:i + 2, 1], "-",
                color=plt.cm.plasma(t[i]), lw=2)
    if replan_every:
        marks = pos[::replan_every]
        ax.plot(marks[:, 0], marks[:, 1], "o", color="k", markersize=4,
                fillstyle="none", label="replan")
        ax.legend(loc="lower right")
    bits = [title] if title else []
    if reached is not None:
        bits.append(f"reached={float(reached):.0f}")
    if collided is not None:
        bits.append(f"collided={float(collided):.0f}")
    ax.set_title("  ".join(bits))
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


_LOSS_KEYS = ("d_loss", "g_adv", "g_ndiv", "g_total")
_EVAL_KEYS = ("eval_success_rate", "eval_collision_rate",
              "eval_mean_pairwise_dist", "raw_eval_success_rate")


def plot_run_curves(rows, path: str | None = None, title: str = ""):
    """Two-panel training report from metrics.jsonl rows: losses over
    steps (log y) and the eval-metric curves (rows with kind='eval').

    Returns (figure, n_train_rows, n_eval_rows); saves to ``path`` if
    given.
    """
    plt = _mpl()
    train = [r for r in rows if r.get("kind") != "eval" and "step" in r]
    evals = [r for r in rows if r.get("kind") == "eval"]
    steps = [r["step"] for r in train]
    esteps = [r["step"] for r in evals]
    if plt is None:
        canvas = _CurveCanvas(2)
        canvas.panel(0, [(steps, [r[key] for r in train if key in r])
                         for key in _LOSS_KEYS])
        canvas.panel(1, [(esteps, [r[key] for r in evals if key in r])
                         for key in _EVAL_KEYS], ylim=(-0.02, 1.05))
        return canvas.finish(path), len(train), len(evals)
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    ax = axes[0]
    for key in _LOSS_KEYS:
        vals = [r[key] for r in train if key in r]
        if vals:
            ax.plot(steps[:len(vals)], vals, label=key, lw=1)
    ax.set_xlabel("step")
    ax.set_title("losses")
    ax.legend(fontsize=8)
    ax = axes[1]
    for key in _EVAL_KEYS:
        vals = [r[key] for r in evals if key in r]
        if vals:
            ax.plot(esteps[:len(vals)], vals, "-o", label=key,
                    lw=1, markersize=3)
    ax.set_xlabel("step")
    ax.set_ylim(-0.02, 1.05)
    ax.set_title("frozen-suite eval")
    ax.legend(fontsize=8)
    fig.suptitle(title)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig, len(train), len(evals)


# ------------------------------------------- Pillow, without matplotlib


def _ramp(t: float) -> tuple:
    """Dark blue (t = 0) to yellow (t = 1)."""
    t = float(np.clip(t, 0.0, 1.0))
    return (int(68 + 185 * t), int(1 + 230 * t), int(84 - 48 * t))


_SERIES = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40))


class _Canvas:
    """A Pillow image over data coordinates ``xlim`` x ``ylim`` (y up)."""

    def __init__(self, size, xlim, ylim, origin=(0, 0)):
        from PIL import Image, ImageDraw

        self.image = Image.new("RGB", size, "white")
        self.draw = ImageDraw.Draw(self.image)
        self.box = (origin, size)
        self.xlim, self.ylim = xlim, ylim

    def at(self, xlim, ylim, origin, size):
        """A view of this image's region ``origin``/``size`` over new
        data limits."""
        view = object.__new__(_Canvas)
        view.image, view.draw = self.image, self.draw
        view.box, view.xlim, view.ylim = (origin, size), xlim, ylim
        return view

    def px(self, x, y) -> tuple:
        (ox, oy), (w, h) = self.box
        (x0, x1), (y0, y1) = self.xlim, self.ylim
        return (ox + (x - x0) / max(x1 - x0, 1e-12) * (w - 1),
                oy + (1.0 - (y - y0) / max(y1 - y0, 1e-12)) * (h - 1))

    def line(self, points, color, width=2):
        self.draw.line([self.px(*p) for p in np.asarray(points)[:, :2]],
                       fill=color, width=width)

    def marker(self, p, color, radius, fill=True):
        x, y = self.px(p[0], p[1])
        box = (x - radius, y - radius, x + radius, y + radius)
        self.draw.ellipse(box, fill=color if fill else None, outline=color)

    def finish(self, path):
        if path:
            self.image.save(path)
        return self.image


class _SceneCanvas(_Canvas):
    """The unit square with one scene's obstacles, start and goal."""

    def __init__(self, scene, size=600):
        super().__init__((size, size), (-0.02, 1.02), (-0.02, 1.02))
        for row, live in zip(_host(scene.obstacles),
                             _host(scene.obstacle_mask)):
            if live > 0.5:
                (x0, y1), (x1, y0) = (self.px(row[0] - row[2], row[1] - row[2]),
                                      self.px(row[0] + row[2], row[1] + row[2]))
                self.draw.ellipse((x0, y0, x1, y1), fill=(178, 178, 178))
        self.marker(_host(scene.start), (0, 128, 0), 8)
        self.marker(_host(scene.goal), (255, 0, 0), 9)


class _CurveCanvas(_Canvas):
    """``n`` side-by-side panels of line series, each autoscaled."""

    def __init__(self, n, size=(560, 400)):
        super().__init__((size[0] * n, size[1]), (0, 1), (0, 1))
        self.size = size

    def panel(self, i, series, ylim=None):
        series = [(xs[:len(ys)], ys) for xs, ys in series if ys]
        w, h = self.size
        origin, inner = (i * w + 40, 20), (w - 60, h - 50)
        xs = [x for s, _ in series for x in s] or [0, 1]
        ys = [y for _, s in series for y in s] or [0, 1]
        view = self.at((min(xs), max(xs)),
                       ylim or (min(ys), max(ys)), origin, inner)
        self.draw.rectangle((origin[0], origin[1], origin[0] + inner[0],
                             origin[1] + inner[1]), outline=(0, 0, 0))
        for j, (sx, sy) in enumerate(series):
            view.line(np.stack([sx, sy], axis=1).astype(float),
                      _SERIES[j % len(_SERIES)], width=2)
