"""Configs and workload presets; counterpart of ``ndivplanning_tpu/utils/config.py``.

The port keeps its own copy, field for field, so that it never imports the
JAX package.  ``tests/test_torch_config.py`` pins every preset to the JAX
one.  Field meanings are documented beside the JAX definitions.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Config:
    """All hyperparameters for one NDiv-GAN workload."""

    # Identity
    name: str = "pointmass2d"
    seed: int = 0

    # Task / conditioning
    conditioning: str = "none"  # none | startgoal | image
    env: str = "pointmass"
    image_size: int = 32
    horizon: int = 32
    state_dim: int = 2

    # Diversity sampling
    batch_size: int = 64  # global batch of conditions
    k: int = 8  # diversity samples per condition
    latent_dim: int = 2

    # Models
    g_arch: str = "mlp"  # mlp | transformer
    g_hidden: Tuple[int, ...] = (256, 256)
    g_tf_dim: int = 128
    g_tf_layers: int = 2
    g_tf_heads: int = 4
    d_hidden: Tuple[int, ...] = (256, 256)
    cond_embed_dim: int = 64
    encoder_features: Tuple[int, ...] = (16, 32, 64)  # conv channels
    generator_output: str = "linear"  # linear | sigmoid
    compute_dtype: str = "f32"  # f32 | bf16

    # Losses
    gan_loss: str = "bce"  # bce | lsgan | hinge
    ndiv_alpha: float = 0.8
    ndiv_weight: float = 1.0
    ndiv_impl: str = "auto"  # auto | pallas (the fused kernel) | jnp (reference)
    feature_matching_weight: float = 0.0
    r1_weight: float = 0.0
    instance_noise_sigma: float = 0.0
    instance_noise_anneal: int = 0
    diffaug: str = ""
    diffaug_shift: float = 0.125
    ada_target: float = 0.0
    ada_step: float = 0.002
    ada_decay: float = 0.99
    ada_p_max: float = 0.8
    d_reset_every: int = 0
    d_reset_start: int = 0
    best_min_diversity: float = 0.0
    topk_g_fraction: float = 0.0
    d_spectral_norm: bool = False
    div_floor: float = 0.0
    div_floor_weight: float = 1.0
    lecam_weight: float = 0.0
    lecam_decay: float = 0.99
    remat: bool = False

    # Optimization
    g_lr: float = 1e-3
    d_lr: float = 1e-3
    adam_b1: float = 0.5  # GAN-standard beta1
    adam_b2: float = 0.999
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    lr_final_ratio: float = 0.0
    g_ema_decay: float = 0.0
    steps: int = 10_000

    # Planning / eval
    rollout_mode: str = "waypoints"  # waypoints | actions
    n_candidates: int = 1000
    cem_iters: int = 5
    grad_refine_steps: int = 12
    trajopt_steps: int = 60
    trajopt_lr: float = 0.05
    ilqr_iters: int = 36
    eval_every: int = 500
    eval_suite_scenes: int = 128
    track_best_metric: str = "eval_success_rate"

    # Parallelism
    dp_shards: int = 1
    div_shards: int = 1

    # Bookkeeping
    log_every: int = 50
    checkpoint_every: int = 1000
    workdir: str = "/tmp/ndivplanning_tpu"

    @property
    def traj_dim(self) -> int:
        return self.horizon * self.state_dim

    def replace(self, **kw) -> "Config":
        # List-valued overrides of tuple fields become tuples, so the frozen
        # Config stays hashable.
        for name, value in kw.items():
            if isinstance(value, list):
                kw[name] = tuple(value)
        return dataclasses.replace(self, **kw)


PRESETS = {
    "pointmass2d": Config(
        name="pointmass2d", conditioning="none", batch_size=64, k=8,
        latent_dim=2,
    ),
    "goalcond": Config(
        name="goalcond", conditioning="startgoal", batch_size=256, k=8,
        latent_dim=2, horizon=32, generator_output="sigmoid",
        g_ema_decay=0.999,
    ),
    "imagecond": Config(
        name="imagecond", conditioning="image", batch_size=512, k=8,
        latent_dim=2, generator_output="sigmoid", g_ema_decay=0.999,
    ),
    "planning": Config(
        name="planning", conditioning="image", batch_size=64, k=8,
        latent_dim=2, n_candidates=1000, generator_output="sigmoid",
        g_ema_decay=0.999,
    ),
    "pod_dp": Config(
        name="pod_dp", conditioning="startgoal", batch_size=8192, k=32,
        latent_dim=2, dp_shards=8, generator_output="sigmoid",
        compute_dtype="bf16", g_ema_decay=0.999,
    ),
}


def get_config(preset: str, **overrides) -> Config:
    """Fetch a preset by name with field overrides.

    The default workdir is namespaced per preset, as in the JAX package."""
    try:
        cfg = PRESETS[preset]
    except KeyError:
        raise ValueError(
            f"unknown preset {preset!r}; choose from {sorted(PRESETS)}"
        ) from None
    if "workdir" not in overrides and cfg.workdir == Config.workdir:
        overrides = {**overrides,
                     "workdir": os.path.join(cfg.workdir, preset)}
    return cfg.replace(**overrides) if overrides else cfg


def config_from_dict(d: dict) -> Config:
    """Rebuild a Config from its JSON dict (tuples arrive as lists); unknown
    fields are ignored, as the JAX package ignores them."""
    names = {f.name for f in dataclasses.fields(Config)}
    return Config(**{name: tuple(v) if isinstance(v, list) else v
                     for name, v in d.items() if name in names})


def _config_path(workdir: str) -> str:
    return os.path.join(workdir, "config.json")


def save_config(cfg: Config, workdir: str) -> None:
    """Record the run's config as ``<workdir>/config.json``, in the JAX
    package's format, so plan and serve rebuild the same models."""
    os.makedirs(workdir, exist_ok=True)
    with open(_config_path(workdir), "w", encoding="utf-8") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1, sort_keys=True)


def load_config(workdir: str) -> Config | None:
    """The config recorded in ``workdir`` (by either package), or None."""
    path = _config_path(workdir)
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return config_from_dict(json.load(f))
