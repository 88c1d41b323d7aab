"""The train step's stabiliser knobs in the torch port against the JAX step.

Both packages start from one JAX state (weights, Adam moments, EMA and
trackers converted) and see one batch.  The JAX step's draws are replayed
from its key schedule (``split(state.rng)`` for the latents, then four
ways for the instance noise, four for the three DiffAugment passes, each
split again for its ADA mask, shift and cutout, then one for the fresh D)
and injected into the port through ``train_step_impl(z=, draws=)``, since
the two packages' random streams never agree.  Tolerances are
``tests/test_torch_train_step.py``'s.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndivplanning_tpu.data.tasks import make_task as jax_make_task
from ndivplanning_tpu.models.mlp import Discriminator as JaxDiscriminator
from ndivplanning_tpu.models.mlp import SNDense as JaxSNDense
from ndivplanning_tpu.train.state import build_models as jax_build_models
from ndivplanning_tpu.train.state import create_train_state as jax_create
from ndivplanning_tpu.train.step import _cutout_images as jax_cutout
from ndivplanning_tpu.train.step import _shift_images as jax_shift
from ndivplanning_tpu.train.step import train_step as jax_train_step
from ndivplanning_tpu.utils.config import get_config as jax_get_config
from ndivplanning_tpu_torch.data.tasks import make_task
from ndivplanning_tpu_torch.models.mlp import Discriminator, SNDense
from ndivplanning_tpu_torch.train.state import create_train_state
from ndivplanning_tpu_torch.train.step import (
    AugDraws,
    StepDraws,
    _diffaug,
    cutout_images,
    reset_due,
    shift_images,
    train_step_fused,
    train_step_impl,
)
from ndivplanning_tpu_torch.utils.config import get_config
from ndivplanning_tpu_torch.utils.convert import (
    params_from_flax,
    train_state_from_flax,
)
from tests.test_torch_train_step import (
    METRIC_TOL,
    _assert_metrics_close,
    _assert_state_close,
    _np,
    _torch_batch,
)

SMALL = dict(batch_size=8, k=4, horizon=8, g_hidden=(32, 32),
             d_hidden=(32, 32))
IMAGE = dict(SMALL, image_size=16)
# One step of every knob, grouped into four configs (one JAX compile
# each): on goalcond the knobs that leave D in place, R1 and feature
# matching under remat (bitwise the same step without it:
# test_remat_is_bitwise_no_remat), and D restarts alone (the restart
# replaces D's update); on imagecond the knobs that act on images or
# their samples: DiffAugment's shift and cutout, ADA (its p set to 0.5),
# the diversity floor (a sigmoid generator in the unit box, where the
# floor's Gram-form distances hold parity) and spectral norm.
KNOB_CASES = {
    "noise_diffaug_lecam_topk": ("goalcond", dict(
        instance_noise_sigma=0.05, instance_noise_anneal=10,
        diffaug="shift", lecam_weight=0.1, topk_g_fraction=0.5)),
    "r1_fm_remat": ("goalcond", dict(r1_weight=0.1,
                                     feature_matching_weight=1.0,
                                     remat=True)),
    "d_reset_every": ("goalcond", dict(d_reset_every=1)),
    "sn_diffaug_ada_floor": ("imagecond", dict(
        d_spectral_norm=True, diffaug="shift,cutout", ada_target=0.6,
        div_floor=0.4)),
}


def _tensor(a):
    return torch.tensor(np.asarray(a))


def _jax_aug(jcfg, key, b, p, size):
    """The draws of the JAX ``_diffaug`` from its pass key."""
    kinds = set(jcfg.diffaug.split(","))
    out = AugDraws()
    if jcfg.ada_target > 0:
        key, k_m = jax.random.split(key)
        out.mask = _tensor(jax.random.bernoulli(k_m, p, (b,)).astype(
            jnp.float32))
    if "shift" in kinds:
        key, k_s = jax.random.split(key)
        out.shift = _tensor(jax.random.uniform(
            k_s, (b, 2), minval=-jcfg.diffaug_shift,
            maxval=jcfg.diffaug_shift))
    if "cutout" in kinds and jcfg.conditioning == "image":
        key, k_c = jax.random.split(key)
        out.cutout = _tensor(jax.random.randint(k_c, (b, 2), 0,
                                                size - size // 2 + 1))
    return out


def jax_draws(jcfg, cfg, jstate, jbatch):
    """(z, StepDraws) of the JAX step from ``jstate`` on ``jbatch``."""
    rng, k_z = jax.random.split(jstate.rng)
    real = jbatch.real_traj
    b = real.shape[0]
    z = _tensor(jax.random.normal(k_z, (b, jcfg.k, jcfg.latent_dim),
                                  jnp.float32))
    draws = StepDraws()
    if jcfg.instance_noise_sigma > 0:
        rng, *keys = jax.random.split(rng, 4)
        fake = (b, jcfg.k) + real.shape[1:]
        draws.noise = tuple(
            _tensor(jax.random.normal(key, shape, jnp.float32))
            for key, shape in zip(keys, (real.shape, fake, fake)))
    if jcfg.diffaug:
        rng, *keys = jax.random.split(rng, 4)
        size = jbatch.conditions.shape[1]
        draws.aug = tuple(_jax_aug(jcfg, key, b, jstate.ada["p"], size)
                          for key in keys)
    if jcfg.d_reset_every > 0:
        rng, k_dr = jax.random.split(rng)
        if reset_due(cfg, int(jstate.step)):
            fresh = jax_build_models(jcfg)[1].init(k_dr, jbatch.conditions,
                                                   real)
            draws.fresh_d = params_from_flax(_np(fresh))
    return z, draws


def _tree(jstate):
    return _np({
        "step": jstate.step, "g_params": jstate.g_params,
        "d_params": jstate.d_params, "g_ema_params": jstate.g_ema_params,
        "ada": jstate.ada, "lecam_ema": jstate.lecam_ema,
        "g_adam": jstate.g_opt_state, "d_adam": jstate.d_opt_state})


def run_both(preset, n_steps, ada_p=0.0, **overrides):
    """n_steps of each package from one JAX state (its ADA p set to
    ``ada_p``), the JAX draws injected into the port; returns the per-step
    metrics and the final states."""
    base = IMAGE if preset == "imagecond" else SMALL
    jcfg = jax_get_config(preset, **base, **overrides)
    cfg = get_config(preset, **base, **overrides)
    jstate = jax_create(jcfg, seed=0)
    jstate = jstate.replace(ada={"r": jstate.ada["r"],
                                 "p": jnp.float32(ada_p)})
    state = train_state_from_flax(cfg, _tree(jstate), device="cpu")
    task = jax_make_task(jcfg)
    jmetrics, metrics = [], []
    for i in range(n_steps):
        jbatch = task.sample(jax.random.PRNGKey(100 + i), cfg.batch_size)
        z, draws = jax_draws(jcfg, cfg, jstate, jbatch)
        jstate, jm = jax_train_step(jcfg, jstate, jbatch)
        state, m = train_step_impl(cfg, state, _torch_batch(jbatch), z=z,
                                   draws=draws)
        jmetrics.append({k: float(v) for k, v in jm.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return jmetrics, metrics, jstate, state


def _assert_trackers_close(jstate, state):
    for field in ("ada", "lecam_ema"):
        for key, value in getattr(jstate, field).items():
            np.testing.assert_allclose(
                float(getattr(state, field)[key]), float(value),
                err_msg=f"{field}.{key}", **METRIC_TOL)


@pytest.mark.parametrize("case", sorted(KNOB_CASES))
def test_one_knob_step_matches_jax(case):
    """Params, EMA, Adam moments, the trackers and every metric after one
    step; ``g_lr`` (reported under an LR schedule) at rtol 1e-6."""
    preset, overrides = KNOB_CASES[case]
    ada_p = 0.5 if "ada_target" in overrides else 0.0
    jm, m, jstate, state = run_both(preset, 1, ada_p=ada_p, **overrides)
    assert set(m[0]) == set(jm[0])
    _assert_metrics_close(m[0], jm[0], m[0].keys())
    if "g_lr" in jm[0]:
        np.testing.assert_allclose(m[0]["g_lr"], jm[0]["g_lr"], rtol=1e-6)
    _assert_state_close(jstate, state, 1)
    _assert_trackers_close(jstate, state)
    assert state.d_opt.count == int(jstate.d_opt_state[0].count)
    if case == "d_reset_every":
        assert state.d_opt.count == 0
        assert all(float(v.abs().max()) == 0.0
                   for v in state.d_opt.mu.values())


@pytest.mark.parametrize("case", ["noise_diffaug_lecam_topk",
                                  "sn_diffaug_ada_floor"])
def test_tracker_knobs_three_steps_match_jax(case):
    """The LeCam anchors and ADA's p feed the next step: three steps of
    their configs, the losses step by step and the state at the end."""
    preset, overrides = KNOB_CASES[case]
    ada_p = 0.5 if "ada_target" in overrides else 0.0
    jm, m, jstate, state = run_both(preset, 3, ada_p=ada_p, **overrides)
    for step in range(3):
        _assert_metrics_close(m[step], jm[step],
                              set(m[step]) - {"g_ndiv", "g_total"})
    _assert_state_close(jstate, state, 3)
    _assert_trackers_close(jstate, state)
    if "ada_target" in overrides:
        assert [s["ada_p"] for s in m] == pytest.approx(
            [s["ada_p"] for s in jm])
        assert m[-1]["ada_p"] != 0.5
    else:
        assert float(state.lecam_ema["real"]) != 0.0


def test_sn_dense_sigma_and_discriminator_logits_match_jax():
    """``W / sigma`` of one SNDense (as its output on the identity with a
    zero bias) and an SN discriminator's logits and features on converted
    weights."""
    rng = np.random.default_rng(0)
    layer = JaxSNDense(24)
    jparams = layer.init(jax.random.PRNGKey(1), jnp.zeros((1, 40)))
    want = np.asarray(layer.apply(jparams, jnp.eye(40)))
    torch_layer = SNDense(40, 24)
    torch_layer.load_state_dict(
        {name.split(".")[-1]: v for name, v in params_from_flax(
            {"Discriminator_0": {"SNDense_0": _np(jparams["params"])}}
        ).items()})
    got = torch_layer.normalized_weight().detach().numpy().T
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    kernel = np.asarray(jparams["params"]["kernel"])
    sigma = np.linalg.norm(kernel, 2)
    np.testing.assert_allclose(kernel[0, 0] / got[0, 0], sigma, rtol=1e-2)

    jd = JaxDiscriminator(hidden=(32, 32), spectral_norm=True)
    cond = rng.normal(size=(6, 8)).astype(np.float32)
    traj = rng.normal(size=(6, 4, 8, 2)).astype(np.float32)
    jp = jd.init(jax.random.PRNGKey(2), jnp.asarray(cond), jnp.asarray(traj))
    want_logit, want_feats = jd.apply(jp, jnp.asarray(cond),
                                      jnp.asarray(traj), return_features=True)
    d = Discriminator(8, 16, (32, 32), spectral_norm=True)
    d.load_state_dict({name.removeprefix("discriminator."): v
                       for name, v in params_from_flax(
                           {"Discriminator_0": _np(jp["params"])}).items()})
    with torch.no_grad():
        logit, feats = d(torch.tensor(cond), torch.tensor(traj),
                         return_features=True)
    np.testing.assert_allclose(logit.numpy(), np.asarray(want_logit),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats),
                               rtol=1e-5, atol=1e-6)


def test_shift_and_cutout_match_jax_bitwise():
    """The zero-padded shift at offsets inside, on and past the image's
    edge, and the cutout at the JAX draw's corners."""
    rng = np.random.default_rng(3)
    images = rng.uniform(size=(6, 16, 16, 3)).astype(np.float32)
    px = np.asarray([[2, -1], [0, 0], [-3, 3], [16, 0], [-17, 5], [1, 15]],
                    np.int32)
    want = jax_shift(jnp.asarray(images), jnp.asarray(px), max_px=17)
    got = shift_images(torch.tensor(images), torch.tensor(px))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    key = jax.random.PRNGKey(4)
    pos = jax.random.randint(key, (6, 2), 0, 16 - 8 + 1)
    want = jax_cutout(key, jnp.asarray(images))
    got = cutout_images(torch.tensor(images), _tensor(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((got == 0).sum()) == 6 * 8 * 8 * 3


def test_ada_at_p_zero_is_the_identity_and_needs_diffaug():
    cfg = get_config("imagecond", **IMAGE, diffaug="shift,cutout",
                     ada_target=0.6)
    gen = torch.Generator().manual_seed(0)
    cond = torch.rand((8, 16, 16, 3), generator=gen)
    traj = torch.rand((8, 4, 8, 2), generator=gen)
    draws = AugDraws(mask=torch.zeros(8),
                     shift=torch.rand((8, 2), generator=gen) * 0.25 - 0.125,
                     cutout=torch.randint(0, 9, (8, 2), generator=gen))
    got_cond, got_traj = _diffaug(cfg, draws, cond, traj)
    assert torch.equal(got_cond, cond) and torch.equal(got_traj, traj)
    draws.mask = torch.ones(8)
    assert not torch.equal(_diffaug(cfg, draws, cond, traj)[0], cond)

    kw = dict(SMALL, ada_target=0.6)
    jcfg = jax_get_config("goalcond", **kw)
    jstate = jax_create(jcfg, seed=0)
    jbatch = jax_make_task(jcfg).sample(jax.random.PRNGKey(0), 8)
    with pytest.raises(ValueError, match="ada_target > 0 needs a diffaug"):
        jax_train_step(jcfg, jstate, jbatch)
    cfg = get_config("goalcond", **kw)
    with pytest.raises(ValueError, match="ada_target > 0 needs a diffaug"):
        train_step_fused(cfg, create_train_state(cfg, device="cpu"))


def test_d_reset_fires_on_the_boundary_only_and_start_gates_it():
    """d_reset_every=2 from d_reset_start=4: D restarts after steps 4 and
    6 only (its Adam count drops to 0 there), G's chain never; the
    predicate is the JAX step's."""
    cfg = get_config("pointmass2d", batch_size=8, k=4, horizon=8,
                     g_hidden=(16,), d_hidden=(16,), d_reset_every=2,
                     d_reset_start=4)
    state = create_train_state(cfg, seed=0, device="cpu")
    counts = []
    for _ in range(7):
        state, _ = train_step_fused(cfg, state)
        counts.append((state.g_opt.count, state.d_opt.count))
    assert counts == [(1, 1), (2, 2), (3, 3), (4, 0), (5, 1), (6, 0),
                      (7, 1)]
    for step in range(12):
        new = step + 1
        want = new % 2 == 0 and new >= max(4, 1)
        assert reset_due(cfg, step) == want
    assert not any(reset_due(get_config("goalcond"), s) for s in range(12))


def test_remat_is_bitwise_no_remat():
    """Two steps with R1, feature matching and SN, recomputed in the
    backward or not: every tensor of the state and every metric equal."""
    out = []
    for remat in (False, True):
        cfg = get_config("goalcond", **SMALL, remat=remat, r1_weight=0.1,
                         feature_matching_weight=1.0, d_spectral_norm=True)
        state = create_train_state(cfg, seed=2, device="cpu")
        rows = [train_step_fused(cfg, state)[1] for _ in range(2)]
        out.append((state, rows))
    (a, ra), (b, rb) = out
    for x, y in zip([*a.g.parameters(), *a.d.parameters(),
                     *a.g_ema.parameters(), *a.g_opt.mu.values(),
                     *a.d_opt.nu.values()],
                    [*b.g.parameters(), *b.d.parameters(),
                     *b.g_ema.parameters(), *b.g_opt.mu.values(),
                     *b.d_opt.nu.values()]):
        assert torch.equal(x, y)
    for m, n in zip(ra, rb):
        assert m.keys() == n.keys()
        assert all(torch.equal(m[key], n[key]) for key in m)


def test_knobs_off_draw_only_the_batch_and_latents():
    """A step with every knob off leaves the generator where drawing the
    batch and z alone leaves it (the stream of every config before the
    knobs), and injecting empty draws changes nothing."""
    cfg = get_config("imagecond", **IMAGE)
    state = create_train_state(cfg, seed=4, device="cpu")
    twin = copy.deepcopy(dataclasses.replace(state, rng=None))
    twin.rng = torch.Generator().manual_seed(0)
    twin.rng.set_state(state.rng.get_state())
    batch = make_task(cfg).sample(twin.rng, cfg.batch_size)
    z = torch.randn((cfg.batch_size, cfg.k, cfg.latent_dim),
                    generator=twin.rng)
    _, m = train_step_fused(cfg, state)
    assert torch.equal(state.rng.get_state(), twin.rng.get_state())
    _, n = train_step_impl(cfg, twin, batch, z=z, draws=StepDraws())
    assert all(torch.equal(m[key], n[key]) for key in m)
    assert all(torch.equal(p, q) for p, q in zip(state.g.parameters(),
                                                 twin.g.parameters()))
