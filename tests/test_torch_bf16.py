"""bf16 compute in the torch port against the JAX package's bf16.

G, D and the encoders compute in bf16 as flax's ``Dense(dtype=bf16)`` and
``Conv(dtype=bf16)`` do (input, kernel and bias cast, the product rounded,
then the bias added), with float32 params and float32 outputs.  The NDiv
wrappers take bf16 inputs as the JAX kernels do: upcast inside, grads cast
back to bf16.  Tolerances are counted in bf16 ulps (2^-8 of a value):
the two packages' bf16 products may sum in other orders, so a value can
round one ulp apart, and a metric averages many such values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndivplanning_tpu.data.tasks import make_task as jax_make_task
from ndivplanning_tpu.ops.ndiv_pallas import ndiv_loss_fused as jax_fused
from ndivplanning_tpu.train.state import build_models as jax_build_models
from ndivplanning_tpu.train.state import create_train_state as jax_create
from ndivplanning_tpu.train.step import train_step as jax_train_step
from ndivplanning_tpu.utils.config import get_config as jax_get_config
from ndivplanning_tpu_torch.ops.ndiv_cuda import ndiv_loss_fused
from ndivplanning_tpu_torch.train.state import build_models, create_train_state
from ndivplanning_tpu_torch.train.step import train_step_fused, train_step_impl
from ndivplanning_tpu_torch.utils.config import get_config
from ndivplanning_tpu_torch.utils.convert import (
    params_from_flax,
    train_state_from_flax,
)
from tests.test_torch_train_step import _jax_tree, _torch_batch

# A bf16 ulp is 2^-8 to 2^-7 of a value (8 significant bits).
BF16_ULP = 2.0 ** -8
SMALL = dict(batch_size=8, k=4, g_hidden=(32, 32), d_hidden=(32, 32),
             cond_embed_dim=8, compute_dtype="bf16")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("preset,extra", [("goalcond", {}),
                                          ("imagecond", {"image_size": 16})])
def test_bf16_models_match_flax(preset, extra):
    """ConditionedGenerator and ConditionedDiscriminator (encoder, trunk,
    head) at bf16 on converted weights: within two bf16 ulps."""
    jcfg = jax_get_config(preset, **SMALL, **extra)
    jstate = jax_create(jcfg, seed=1)
    g, d = build_models(get_config(preset, **SMALL, **extra))
    g.load_state_dict(params_from_flax(_np(jstate.g_params)))
    d.load_state_dict(params_from_flax(_np(jstate.d_params)))
    rng = np.random.default_rng(0)
    cond = rng.uniform(0, 1, (6, 4) if preset == "goalcond"
                       else (6, 16, 16, 3)).astype(np.float32)
    z = rng.normal(size=(6, 4, 2)).astype(np.float32)
    jg, jd = jax_build_models(jcfg)
    tau = np.asarray(jg.apply(jstate.g_params, jnp.asarray(cond),
                              jnp.asarray(z)))
    want_logit, want_feats = jd.apply(jstate.d_params, jnp.asarray(cond),
                                      jnp.asarray(tau), return_features=True)
    with torch.no_grad():
        got = g(torch.tensor(cond), torch.tensor(z))
        logit, feats = d(torch.tensor(cond), torch.tensor(tau),
                         return_features=True)
    for a, b in ((got, tau), (logit, want_logit), (feats, want_feats)):
        assert a.dtype == torch.float32
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=2 * BF16_ULP,
                                   atol=2 * BF16_ULP * np.abs(b).max())


def test_bf16_params_optimizer_and_ema_stay_f32():
    cfg = get_config("pod_dp", **SMALL, dp_shards=1)
    state = create_train_state(cfg, device="cpu")
    state, metrics = train_step_fused(cfg, state)
    for module in (state.g, state.d, state.g_ema):
        assert all(p.dtype == torch.float32 for p in module.parameters())
    for opt in (state.g_opt, state.d_opt):
        assert all(m.dtype == torch.float32 for m in opt.mu.values())
        assert all(v.dtype == torch.float32 for v in opt.nu.values())
    assert all(m.dtype == torch.float32 for m in metrics.values())


@pytest.mark.parametrize("variant", ["block", "packed"])
def test_ndiv_bf16_inputs_match_jax_kernel(variant):
    """bf16 z and x through the fused wrappers (block: the joint kernel's
    unit grads cast to bf16, scaled in f32 and cast again; packed: the
    forward, then the backward at g, cast to bf16) against JAX's
    interpret-mode kernels: a float32 loss, bf16 grads within an ulp."""
    rng = np.random.default_rng(3)
    jz = jnp.asarray(rng.normal(size=(8, 8, 2)), jnp.bfloat16)
    jx = jnp.asarray(rng.normal(size=(8, 8, 64)), jnp.bfloat16)
    want, want_grads = jax.value_and_grad(
        lambda a, b: 3.0 * jax_fused(a, b, 0.8, variant=variant),
        argnums=(0, 1))(jz, jx)
    z = torch.tensor(np.asarray(jz.astype(jnp.float32))).bfloat16()
    x = torch.tensor(np.asarray(jx.astype(jnp.float32))).bfloat16()
    z.requires_grad_(True)
    x.requires_grad_(True)
    loss = 3.0 * ndiv_loss_fused(z, x, 0.8, variant=variant)
    grads = torch.autograd.grad(loss, (z, x))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-6)
    for got, ref in zip(grads, want_grads):
        assert got.dtype == torch.bfloat16
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), ref,
                                   rtol=2 * BF16_ULP, atol=0.0)


def test_pod_dp_bf16_step_matches_jax_and_stays_finite():
    """A shrunk pod_dp step in bf16 (B=32, k=8, hidden 32) from one state
    on JAX's own batch and z, then four more steps: the metrics of the
    first within four bf16 ulps of JAX's, all five finite."""
    kw = dict(SMALL, batch_size=32, k=8, dp_shards=1)
    jcfg, cfg = jax_get_config("pod_dp", **kw), get_config("pod_dp", **kw)
    jstate = jax_create(jcfg, seed=0)
    state = train_state_from_flax(cfg, _jax_tree(jstate), device="cpu")
    jbatch = jax_make_task(jcfg).sample(jax.random.PRNGKey(7),
                                        cfg.batch_size)
    z = jax.random.normal(jax.random.split(jstate.rng)[1],
                          (cfg.batch_size, cfg.k, cfg.latent_dim),
                          jnp.float32)
    _, jm = jax_train_step(jcfg, jstate, jbatch)
    state, m = train_step_impl(cfg, state, _torch_batch(jbatch),
                               z=torch.tensor(np.asarray(z)))
    assert set(m) == set(jm)
    for key in jm:
        np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                   rtol=4 * BF16_ULP, atol=1e-6, err_msg=key)
    for _ in range(4):
        state, m = train_step_fused(cfg, state)
        assert all(bool(torch.isfinite(v)) for v in m.values())
