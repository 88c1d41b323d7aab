"""The torch port's G, D and condition encoders against the JAX modules on converted weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndivplanning_tpu.models.conditioning import (
    ConditionEncoder as JaxConditionEncoder,
)
from ndivplanning_tpu.train.state import build_models as jax_build_models
from ndivplanning_tpu.train.state import create_train_state as jax_create
from ndivplanning_tpu.utils.config import get_config as jax_get_config
from ndivplanning_tpu_torch.models.conditioning import ConditionEncoder
from ndivplanning_tpu_torch.train.state import (
    build_models,
    create_train_state,
)
from ndivplanning_tpu_torch.utils.config import get_config
from ndivplanning_tpu_torch.utils.convert import params_from_flax

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def goalcond():
    """Full-width goalcond G and D in both packages, same weights."""
    jcfg = jax_get_config("goalcond")
    jstate = jax_create(jcfg, seed=3)
    g, d = build_models(get_config("goalcond"))
    g.load_state_dict(params_from_flax(_np(jstate.g_params)))
    d.load_state_dict(params_from_flax(_np(jstate.d_params)))
    rng = np.random.default_rng(0)
    inputs = dict(
        cond=rng.uniform(0, 1, (6, 4)).astype(np.float32),
        z=rng.normal(size=(6, 8, 2)).astype(np.float32),
        traj=rng.uniform(0, 1, (6, 32, 2)).astype(np.float32),
        trajk=rng.uniform(0, 1, (6, 8, 32, 2)).astype(np.float32),
    )
    return jcfg, jstate, g, d, inputs


def test_param_trees_convert_to_every_module_weight(goalcond):
    _, jstate, g, d, _ = goalcond
    for tree, module in ((jstate.g_params, g), (jstate.d_params, d)):
        sd = params_from_flax(_np(tree))
        assert set(sd) == set(module.state_dict())
        for name, value in module.state_dict().items():
            assert tuple(sd[name].shape) == tuple(value.shape), name


def test_generator_matches_jax(goalcond):
    jcfg, jstate, g, _, inp = goalcond
    jg, _ = jax_build_models(jcfg)
    want = jg.apply(jstate.g_params, jnp.asarray(inp["cond"]),
                    jnp.asarray(inp["z"]))
    with torch.no_grad():
        got = g(torch.from_numpy(inp["cond"]), torch.from_numpy(inp["z"]))
    assert got.shape == (6, 8, 32, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("key", ["traj", "trajk"])
def test_discriminator_logits_and_features_match_jax(goalcond, key):
    jcfg, jstate, _, d, inp = goalcond
    _, jd = jax_build_models(jcfg)
    want_logit, want_feats = jd.apply(
        jstate.d_params, jnp.asarray(inp["cond"]), jnp.asarray(inp[key]),
        return_features=True)
    with torch.no_grad():
        logit, feats = d(torch.from_numpy(inp["cond"]),
                         torch.from_numpy(inp[key]), return_features=True)
        plain = d(torch.from_numpy(inp["cond"]), torch.from_numpy(inp[key]))
    np.testing.assert_allclose(logit.numpy(), np.asarray(want_logit), **TOL)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats), **TOL)
    np.testing.assert_array_equal(plain.numpy(), logit.numpy())


def test_unconditioned_models_match_jax():
    """pointmass2d: a [B, 0] embedding and the linear head."""
    jcfg = jax_get_config("pointmass2d", horizon=8, g_hidden=(16,),
                          d_hidden=(16,))
    jstate = jax_create(jcfg, seed=1)
    g, d = build_models(get_config("pointmass2d", horizon=8, g_hidden=(16,),
                                   d_hidden=(16,)))
    g.load_state_dict(params_from_flax(_np(jstate.g_params)))
    d.load_state_dict(params_from_flax(_np(jstate.d_params)))
    rng = np.random.default_rng(5)
    cond = np.zeros((3, 0), np.float32)
    z = rng.normal(size=(3, 4, 2)).astype(np.float32)
    jg, jd = jax_build_models(jcfg)
    tau = np.array(jg.apply(jstate.g_params, jnp.asarray(cond),
                            jnp.asarray(z)))
    with torch.no_grad():
        got = g(torch.from_numpy(cond), torch.from_numpy(z))
        logit = d(torch.from_numpy(cond), torch.from_numpy(tau))
    np.testing.assert_allclose(got.numpy(), tau, **TOL)
    np.testing.assert_allclose(
        logit.numpy(),
        np.asarray(jd.apply(jstate.d_params, jnp.asarray(cond),
                            jnp.asarray(tau))), **TOL)


def test_init_matches_flax_scale():
    """Weights follow flax's truncated lecun-normal init: std ~ 1/sqrt(fan_in)."""
    g, _ = build_models(get_config("goalcond"), torch.Generator().manual_seed(0))
    w = g.generator.trunk.layers[1].weight.detach()
    np.testing.assert_allclose(float(w.std()), 1.0 / np.sqrt(256), rtol=0.05)
    assert float(w.abs().max()) <= 2.0 / np.sqrt(256) / 0.87962566103423978
    assert torch.count_nonzero(g.generator.trunk.layers[1].bias) == 0


def test_unported_knobs_raise():
    """Every model knob is ported: the transformer family and spectral
    norm build, and an unknown generator family raises ValueError where
    the modules are built, with the JAX package's message.  bf16 compute is
    ported; an unknown compute dtype raises ValueError, as in the JAX
    package.  LR schedules are ported (their Adam chains take a schedule);
    an unknown schedule raises ValueError where the optimizers are built,
    with the JAX package's message."""
    g, d = build_models(get_config("goalcond", g_arch="transformer",
                                   d_spectral_norm=True))
    assert type(g.generator).__name__ == "TrajectoryTransformer"
    assert type(d.discriminator.head).__name__ == "SNDense"
    with pytest.raises(ValueError, match="unknown g_arch 'rnn'"):
        build_models(get_config("goalcond", g_arch="rnn"))
    build_models(get_config("goalcond", compute_dtype="bf16"))
    with pytest.raises(ValueError, match="compute_dtype"):
        build_models(get_config("goalcond", compute_dtype="fp8"))
    for kw in (dict(lr_schedule="cosine"), dict(warmup_steps=10)):
        build_models(get_config("imagecond", **kw))
        state = create_train_state(get_config("goalcond", **kw),
                                   device="cpu")
        assert callable(state.g_opt.lr) and callable(state.d_opt.lr)
    build_models(get_config("imagecond", lr_schedule="step"))
    with pytest.raises(ValueError, match="unknown lr_schedule 'step'"):
        create_train_state(get_config("goalcond", lr_schedule="step"),
                           device="cpu")


# The image encoder at the smaller sizes the module takes: 16 and an odd
# 15 (flax "SAME" pads (1, 1) at stride 2 there, (0, 1) at even sizes).
@pytest.mark.parametrize("size", [16, 15])
def test_image_condition_encoder_matches_jax(size):
    rng = np.random.default_rng(size)
    images = rng.uniform(0, 1, (4, size, size, 3)).astype(np.float32)
    jenc = JaxConditionEncoder(mode="image", embed_dim=64,
                               encoder_features=(16, 32, 64))
    params = jenc.init(jax.random.PRNGKey(size), jnp.zeros((1, size, size, 3)))
    enc = ConditionEncoder("image", 64, image_size=size)
    sd = params_from_flax(_np(params))
    assert set(sd) == set(enc.state_dict())
    enc.load_state_dict(sd)
    want = np.asarray(jenc.apply(params, jnp.asarray(images)))
    with torch.no_grad():
        got = enc(torch.from_numpy(images))
        # The conv encoder alone, as the JAX SceneEncoderCNN computes it.
        alone = enc.cnn(torch.from_numpy(images))
    np.testing.assert_array_equal(alone.numpy(), got.numpy())
    assert got.shape == (4, 64)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_imagecond_models_match_jax():
    """Both image-conditioned modules, full widths at 16 x 16 images."""
    jcfg = jax_get_config("imagecond", image_size=16)
    jstate = jax_create(jcfg, seed=2)
    g, d = build_models(get_config("imagecond", image_size=16))
    for module, tree in ((g, jstate.g_params), (d, jstate.d_params)):
        sd = params_from_flax(_np(tree))
        assert set(sd) == set(module.state_dict())
        module.load_state_dict(sd)
    rng = np.random.default_rng(1)
    cond = rng.uniform(0, 1, (3, 16, 16, 3)).astype(np.float32)
    z = rng.normal(size=(3, 8, 2)).astype(np.float32)
    jg, jd = jax_build_models(jcfg)
    tau = np.array(jg.apply(jstate.g_params, jnp.asarray(cond),
                            jnp.asarray(z)))
    want_logit, want_feats = jd.apply(jstate.d_params, jnp.asarray(cond),
                                      jnp.asarray(tau), return_features=True)
    with torch.no_grad():
        got = g(torch.from_numpy(cond), torch.from_numpy(z))
        logit, feats = d(torch.from_numpy(cond), torch.from_numpy(tau),
                         return_features=True)
    assert got.shape == (3, 8, 32, 2)
    np.testing.assert_allclose(got.numpy(), tau, **TOL)
    np.testing.assert_allclose(logit.numpy(), np.asarray(want_logit), **TOL)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats), **TOL)
