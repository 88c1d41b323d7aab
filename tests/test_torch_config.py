"""The torch port's config copy against the JAX package's, field for field."""

import dataclasses
import os

import pytest

from ndivplanning_tpu.utils import config as jax_config
from ndivplanning_tpu_torch.utils import config


def test_config_fields_and_defaults_match_jax():
    assert ([(f.name, f.default) for f in dataclasses.fields(config.Config)]
            == [(f.name, f.default)
                for f in dataclasses.fields(jax_config.Config)])


@pytest.mark.parametrize("preset", sorted(jax_config.PRESETS))
def test_preset_matches_jax(preset):
    assert set(config.PRESETS) == set(jax_config.PRESETS)
    assert (dataclasses.asdict(config.get_config(preset))
            == dataclasses.asdict(jax_config.get_config(preset)))
    assert (config.get_config(preset).traj_dim
            == jax_config.get_config(preset).traj_dim)


def test_overrides_and_errors_match_jax():
    kw = dict(batch_size=8, g_hidden=[32, 32], workdir="/tmp/x")
    got = config.get_config("goalcond", **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jax_config.get_config("goalcond", **kw))
    assert isinstance(got.g_hidden, tuple)
    hash(got)
    with pytest.raises(ValueError, match="unknown preset"):
        config.get_config("bogus")


PLANNING512 = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "checkpoints", "planning512")


def test_load_config_of_planning512_matches_jax():
    got, want = config.load_config(PLANNING512), jax_config.load_config(
        PLANNING512)
    assert got.lr_schedule == "cosine" and got.g_hidden == (256, 256)
    for field in dataclasses.fields(want):
        assert getattr(got, field.name) == getattr(want, field.name), field.name


def test_saved_config_loads_in_both_packages(tmp_path):
    cfg = config.get_config("planning", g_hidden=(64, 32),
                            lr_schedule="linear", workdir=str(tmp_path))
    config.save_config(cfg, str(tmp_path))
    assert config.load_config(str(tmp_path)) == cfg
    assert (dataclasses.asdict(jax_config.load_config(str(tmp_path)))
            == dataclasses.asdict(cfg))
    assert config.load_config(str(tmp_path / "empty")) is None
