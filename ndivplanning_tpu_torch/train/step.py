"""The NDiv-GAN train step; counterpart of ``ndivplanning_tpu/train/step.py``.

Alternating updates as in the JAX step: D updates on detached fakes, then
G updates against the already-updated D with the adversarial loss plus
``ndiv_weight`` x NDiv, whose fused kernel runs once per step on the card.
Covers every preset, unsharded or over a (dp, div) mesh of
torch.distributed ranks, in float32 or bf16 compute, with the JAX step's
stabiliser knobs: instance noise, DiffAugment and ADA, R1, LeCam, D
warm restarts, feature matching, the top-k G update, the diversity floor
and rematerialisation.  On a mesh every knob keeps its global form, as
GSPMD gives the JAX step: the draws are sliced to each rank's block, the
means behind LeCam's trackers, feature matching and the floor are summed
over the world, and the top-k G update keeps the global top-k.

Every draw of a step comes from ``state.rng`` in the JAX step's order:
the latents, then the three instance-noise tensors, then each DiffAugment
pass's (D's real, D's fake, G's) ADA mask, shift and cutout, then on a
reset step the fresh D's seed.  A knob that is off draws nothing, so the
stream of a config without knobs is the latents alone.  ``z`` and
``draws`` inject them instead (the JAX package's threefry streams cannot
be drawn in torch).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ndivplanning_tpu_torch.data.tasks import Batch, make_task
from ndivplanning_tpu_torch.ops.gan_losses import get_gan_losses
from ndivplanning_tpu_torch.ops.ndiv import ndiv_loss
from ndivplanning_tpu_torch.ops.pairwise import pairwise_l2
from ndivplanning_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_cat,
    all_reduce_sum_,
    flat_,
)
from ndivplanning_tpu_torch.train.state import (
    Adam,
    ConditionedDiscriminator,
    TrainState,
    bias_correction,
    check_model_knobs,
    check_optimizer_knobs,
    lr_schedule,
)
from ndivplanning_tpu_torch.utils.config import Config
from ndivplanning_tpu_torch.utils.profiling import check_finite, nan_debugging

_F32_TINY = torch.finfo(torch.float32).tiny


def check_step_knobs(cfg: Config) -> None:
    """Raise ``ValueError`` for a config the JAX step refuses."""
    check_model_knobs(cfg)
    check_optimizer_knobs(cfg)
    if cfg.ada_target > 0 and not cfg.diffaug:
        raise ValueError("ada_target > 0 needs a diffaug transform set "
                         "(e.g. --set diffaug=shift) — ADA modulates the "
                         "APPLICATION PROBABILITY of those transforms")


@dataclasses.dataclass
class AugDraws:
    """One DiffAugment pass's draws."""

    mask: torch.Tensor | None = None  # [B] 0/1 float: ADA applies it here
    shift: torch.Tensor | None = None  # [B, 2] uniform in +-diffaug_shift
    cutout: torch.Tensor | None = None  # [B, 2] int corner (x, y) of the hole


@dataclasses.dataclass
class StepDraws:
    """A step's draws beyond its latents."""

    # Unit normals: D's reals [B, H, S], D's fakes and G's pass [B, k, H, S].
    noise: tuple = ()
    # AugDraws of D's real pass, D's fake pass and G's pass.
    aug: tuple = ()
    # The fresh D's state_dict, read on a reset step only.
    fresh_d: dict | None = None


def reset_due(cfg: Config, step: int) -> bool:
    """Whether the step taken from ``step`` restarts D (``d_reset_every``;
    ``d_reset_start`` gates the first restart)."""
    new_step = step + 1
    return (cfg.d_reset_every > 0 and new_step % cfg.d_reset_every == 0
            and new_step >= max(cfg.d_reset_start, 1))


def _fresh_discriminator(cfg: Config, rng: torch.Generator) -> dict:
    """A fresh D's state_dict, its weights drawn on the CPU from a seed
    drawn from ``rng`` (the one host read of a reset step)."""
    seed = int(torch.randint(2 ** 62, (), generator=rng, device=rng.device))
    return ConditionedDiscriminator(
        cfg, torch.Generator().manual_seed(seed)).state_dict()


def _draw_aug(cfg: Config, state: TrainState, b: int,
              image_size: int) -> AugDraws:
    rng, device = state.rng, state.rng.device
    kinds = set(cfg.diffaug.split(","))
    out = AugDraws()
    if cfg.ada_target > 0:
        out.mask = (torch.rand(b, generator=rng, device=device)
                    < state.ada["p"]).float()
    if "shift" in kinds:
        out.shift = torch.empty((b, 2), device=device).uniform_(
            -cfg.diffaug_shift, cfg.diffaug_shift, generator=rng)
    if "cutout" in kinds and cfg.conditioning == "image":
        out.cutout = torch.randint(0, image_size - image_size // 2 + 1,
                                   (b, 2), generator=rng, device=device)
    return out


def draw_step(cfg: Config, state: TrainState, batch: Batch) -> StepDraws:
    """The step's draws beyond its latents, from ``state.rng`` in order."""
    rng, device = state.rng, state.rng.device
    b, traj = batch.real_traj.shape[0], batch.real_traj.shape[1:]
    draws = StepDraws()
    if cfg.instance_noise_sigma > 0:
        draws.noise = tuple(
            torch.randn(shape, generator=rng, device=device)
            for shape in ((b, *traj), (b, cfg.k, *traj), (b, cfg.k, *traj)))
    if cfg.diffaug:
        size = batch.conditions.shape[1] if cfg.conditioning == "image" else 0
        draws.aug = tuple(_draw_aug(cfg, state, b, size) for _ in range(3))
    if reset_due(cfg, state.step):
        draws.fresh_d = _fresh_discriminator(cfg, rng)
    return draws


def shift_images(images: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """Per-sample zero-padded pixel shift of ``[B, S, S, C]`` images by
    ``px [B, 2]`` (dx, dy): ``I'(iy, ix) = I(iy - dy, ix - dx)``, two
    gathers and a validity mask, as the JAX ``_shift_images``."""
    b, s, _, c = images.shape
    grid = torch.arange(s, device=images.device)
    src_y = grid[None, :] - px[:, 1:2]  # [B, S]
    src_x = grid[None, :] - px[:, 0:1]
    valid = (((src_y >= 0) & (src_y < s))[:, :, None]
             & ((src_x >= 0) & (src_x < s))[:, None, :])
    cy, cx = src_y.clamp(0, s - 1), src_x.clamp(0, s - 1)
    rows = torch.gather(images, 1, cy[:, :, None, None].expand(b, s, s, c))
    out = torch.gather(rows, 2, cx[:, None, :, None].expand(b, s, s, c))
    return torch.where(valid[..., None], out, torch.zeros((), dtype=out.dtype,
                                                          device=out.device))


def cutout_images(images: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Zero one ``(S/2)^2`` square of each ``[B, S, S, C]`` image, its
    corner at ``pos [B, 2]`` (x, y), as the JAX ``_cutout_images``."""
    s = images.shape[1]
    c = s // 2
    grid = torch.arange(s, device=images.device)[None, :]
    in_x = (grid >= pos[:, 0:1]) & (grid < pos[:, 0:1] + c)
    in_y = (grid >= pos[:, 1:2]) & (grid < pos[:, 1:2] + c)
    hole = in_y[:, :, None] & in_x[:, None, :]
    return images * (1.0 - hole[..., None].to(images.dtype))


def _diffaug(cfg: Config, draws: AugDraws, conditions: torch.Tensor,
             traj: torch.Tensor):
    """DiffAugment of one (condition, trajectory) pair-batch D is about to
    see, ``traj`` ``[B, H, S]`` or ``[B, k, H, S]``: a condition's k fakes
    share its draws.  Differentiable in ``traj``.  Under ADA a condition
    row is augmented where its mask is 1: a zeroed shift and an un-blended
    cutout are identities."""
    kinds = set(cfg.diffaug.split(","))
    b = traj.shape[0]
    if "shift" in kinds:
        delta = draws.shift
        if draws.mask is not None:
            delta = delta * draws.mask[:, None]
        traj = traj + delta.reshape(b, *(1,) * (traj.dim() - 2), 2)
        if cfg.conditioning == "image":
            size = conditions.shape[1]
            max_px = max(int(cfg.diffaug_shift * size) + 1, 1)
            px = torch.clamp(torch.round(delta * size).to(torch.int32),
                             -max_px, max_px)
            conditions = shift_images(conditions, px)
        elif cfg.conditioning == "startgoal":
            conditions = conditions + delta.repeat(1, 2)
    if "cutout" in kinds and cfg.conditioning == "image":
        cut = cutout_images(conditions, draws.cutout)
        if draws.mask is not None:
            cut = torch.where(draws.mask[:, None, None, None] > 0.5, cut,
                              conditions)
        conditions = cut
    return conditions, traj


def _noise_sigma(cfg: Config, step: int) -> float:
    """The instance-noise sigma at ``step`` in float32, annealed linearly
    to 0 over ``instance_noise_anneal`` steps when that is set."""
    sigma = np.float32(cfg.instance_noise_sigma)
    if cfg.instance_noise_anneal > 0:
        sigma = sigma * np.clip(
            np.float32(1.0) - np.float32(step)
            / np.float32(cfg.instance_noise_anneal),
            np.float32(0.0), np.float32(1.0))
    return float(sigma)


def _remat(cfg: Config, module):
    """``module``, recomputed in the backward instead of keeping its
    activations under ``cfg.remat`` (the model calls inside the
    differentiated losses only)."""
    if not cfg.remat:
        return module
    return functools.partial(checkpoint, module, use_reentrant=False,
                             preserve_rng_state=False)


def _ndiv(cfg: Config, z: torch.Tensor, traj: torch.Tensor,
          mesh: Mesh | None = None) -> torch.Tensor:
    """NDiv loss on ``[B, k, ...]`` latents and trajectories.

    With a mesh (authoritative, even a 1x1 one) the inputs are this rank's
    blocks and the result is this rank's share of the global loss, from
    ``parallel/sharded_step.py``: "pallas", and "auto" on CUDA tensors, go
    through the fused kernel's call site, and "jnp" (and "auto" on the CPU)
    through the row-block strategy, as the JAX package dispatches.
    Without a mesh the inputs are the global batch, whatever dp_shards and
    div_shards say, and ``ndiv_loss`` serves it: the fused kernel on the
    card, the reference on the CPU (the JAX step takes the reference for
    such a config on every backend).
    """
    b, k = z.shape[:2]
    x = traj.reshape(b, k, -1)
    if mesh is None:
        return ndiv_loss(z, x, cfg.ndiv_alpha, impl=cfg.ndiv_impl)
    from ndivplanning_tpu_torch.parallel.sharded_step import (
        ndiv_share_sharded,
    )

    if cfg.ndiv_impl not in ("auto", "pallas", "jnp"):
        raise ValueError(f"unknown ndiv_impl {cfg.ndiv_impl!r}; choose from "
                         "'auto', 'pallas', 'jnp'")
    fused = cfg.ndiv_impl == "pallas" or (cfg.ndiv_impl == "auto"
                                          and z.is_cuda)
    return ndiv_share_sharded(z, x, cfg.ndiv_alpha, mesh,
                              impl="pallas" if fused else "jnp")


def _local_block(batch: Batch, z: torch.Tensor, draws: StepDraws,
                 mesh: Mesh):
    """This rank's conditions and reals ``[dp slice]``, latents ``[dp slice,
    div slice]`` and draws of the global batch, z and draws: the reals'
    noise and each DiffAugment pass's draws by dp rows (a condition's k
    fakes share its draw), the fakes' noise by dp rows and div columns."""
    b, k = z.shape[:2]
    if b % mesh.dp or k % mesh.div:
        raise ValueError(f"batch {b} and k={k} must divide over the "
                         f"({mesh.dp}x{mesh.div}) mesh")
    bl, kl = b // mesh.dp, k // mesh.div
    rows = slice(mesh.dp_index * bl, (mesh.dp_index + 1) * bl)
    cols = slice(mesh.div_index * kl, (mesh.div_index + 1) * kl)
    noise = tuple(n[rows] if i == 0 else n[rows, cols]
                  for i, n in enumerate(draws.noise))
    aug = tuple(AugDraws(*(None if t is None else t[rows]
                           for t in (a.mask, a.shift, a.cutout)))
                for a in draws.aug)
    return (batch.conditions[rows], batch.real_traj[rows],
            z[rows, cols].contiguous(),
            StepDraws(noise=noise, aug=aug, fresh_d=draws.fresh_d))


def _global_topk(g_logits: torch.Tensor, n_keep: int,
                 mesh: Mesh) -> torch.Tensor:
    """This rank's logits among the global top ``n_keep`` of every rank's
    ``[B/dp, k/div]`` block, picked from the logits gathered into the
    unsharded ``[B, k]`` row-major order, so that ties break as there."""
    bl, kl = g_logits.shape
    blocks = all_gather_cat(g_logits.detach()[None], mesh.world, dim=0)
    full = blocks.reshape(mesh.dp, mesh.div, bl, kl).permute(0, 2, 1, 3)
    kept = torch.zeros(full.numel(), dtype=torch.bool, device=full.device)
    kept[torch.topk(full.reshape(-1), n_keep).indices] = True
    mine = kept.reshape(mesh.dp, bl, mesh.div, kl)[mesh.dp_index, :,
                                                   mesh.div_index]
    return g_logits[mine]


def _floor_partial(tau: torch.Tensor, k: int, mesh: Mesh) -> torch.Tensor:
    """The off-diagonal pairwise distances of this rank's samples to every
    sample of their condition, summed: the div group's samples gathered
    (differentiably), this rank's rows of the ``[b, k, k]`` distances."""
    from ndivplanning_tpu_torch.parallel.sharded_step import gather_k

    b, kl = tau.shape[:2]
    full = gather_k(tau.reshape(b, kl, -1), mesh)
    lo = mesh.div_index * kl
    own = torch.arange(kl, device=tau.device)[:, None] + lo
    off = own != torch.arange(k, device=tau.device)[None, :]
    return torch.sum(torch.where(off, pairwise_l2(full)[:, lo:lo + kl], 0.0))


def train_step_impl(cfg: Config, state: TrainState, batch: Batch,
                    z: torch.Tensor | None = None, mesh: Mesh | None = None,
                    draws: StepDraws | None = None):
    """One G+D+NDiv update of ``state`` in place.

    ``z [B, k, zdim]`` replaces the latent draw from ``state.rng``, and
    ``draws`` the stabiliser knobs' draws (:func:`draw_step`).
    With a ``mesh`` (``parallel/mesh.py``) this is the explicit form of the
    JAX step under GSPMD: ``batch``, ``z`` and ``draws`` are global and
    every rank keeps its block of them; its losses are its shares of the
    global ones, which sum over the ranks to the unsharded objective.  The
    blocks divide the batch and k evenly, so a mean's share is its local
    mean over the world size (a real logit, replicated over the div group,
    counts 1/div on each of its ranks): the GAN terms, R1 and LeCam's;
    NDiv's is the call site's partial over the global pair count.  Feature
    matching and the diversity floor are functions of global means, which
    every rank sums over the world (differentiably) and holds whole.  D's
    and G's grads are summed over the world before every rank's identical
    Adam step, and every metric is the global value.
    Returns (state, metrics), metrics a dict of 0-d float32 tensors.
    """
    check_step_knobs(cfg)
    d_loss_fn, g_loss_fn = get_gan_losses(cfg.gan_loss)
    b = batch.real_traj.shape[0]
    if z is None:
        z = torch.randn((b, cfg.k, cfg.latent_dim), generator=state.rng,
                        device=state.rng.device)
    if draws is None:
        draws = draw_step(cfg, state, batch)
    if mesh is None:
        conditions, real = batch.conditions, batch.real_traj
    else:
        from ndivplanning_tpu_torch.parallel.sharded_step import world_sum

        conditions, real, z, draws = _local_block(batch, z, draws, mesh)

    def share(loss):
        return loss if mesh is None else loss / (mesh.dp * mesh.div)

    def world_mean(local_mean):
        """The global mean from this rank's local one, the same bits on
        every rank; differentiable."""
        if mesh is None:
            return local_mean
        return world_sum(share(local_mean), mesh.world)

    def world_sum_(tensors):
        if mesh is not None:
            flat_(tensors, lambda t: all_reduce_sum_(t, mesh.world))
        return tensors

    gen, disc = _remat(cfg, state.g), _remat(cfg, state.d)
    metrics = {}

    # ---------------- D update on detached fakes ----------------
    with torch.no_grad():
        tau_fake = state.g(conditions, z)
    real_d, fake_d = real, tau_fake
    if cfg.instance_noise_sigma > 0:
        # Instance noise on everything D sees, G's pass too.
        sigma = _noise_sigma(cfg, state.step)
        real_d = real_d + sigma * draws.noise[0]
        fake_d = fake_d + sigma * draws.noise[1]
        metrics["d_noise_sigma"] = torch.full((), sigma, device=real.device)
    if cfg.diffaug:
        cond_real_d, real_d = _diffaug(cfg, draws.aug[0], conditions, real_d)
        cond_fake_d, fake_d = _diffaug(cfg, draws.aug[1], conditions, fake_d)
    else:
        cond_real_d = cond_fake_d = conditions
    if cfg.r1_weight > 0:
        real_d = real_d.detach().requires_grad_(True)
    real_logits = disc(cond_real_d, real_d)
    fake_logits = disc(cond_fake_d, fake_d)
    d_loss = share(d_loss_fn(real_logits, fake_logits))
    if cfg.lecam_weight > 0:
        # LeCam: each class' logits pinned to the other class' tracked
        # mean, bias-corrected after state.step tracker updates.
        if state.step > 0:
            corr = max(bias_correction(cfg.lecam_decay, state.step),
                       _F32_TINY)
            anchor = {key: v / corr for key, v in state.lecam_ema.items()}
        else:
            anchor = {key: torch.zeros_like(v)
                      for key, v in state.lecam_ema.items()}
        lecam = (torch.mean(torch.square(real_logits - anchor["fake"]))
                 + torch.mean(torch.square(fake_logits - anchor["real"])))
        d_loss = d_loss + share(cfg.lecam_weight * lecam)
        metrics["d_lecam"] = share(lecam.detach())
    if cfg.r1_weight > 0:
        # R1: the squared gradient of D's summed real logits with respect
        # to the trajectory D saw, summed per sample, batch mean.
        (g_traj,) = torch.autograd.grad(real_logits.sum(), real_d,
                                        create_graph=True)
        r1 = torch.mean(torch.sum(torch.square(g_traj.float()), dim=(1, 2)))
        d_loss = d_loss + share(0.5 * cfg.r1_weight * r1)
        metrics["d_r1"] = share(r1.detach())
    check_finite("train step: D's forward", {"d_loss": d_loss})
    d_grads = torch.autograd.grad(d_loss, list(state.d.parameters()))
    state.d_opt.step(state.d, world_sum_(list(d_grads)))
    if reset_due(cfg, state.step):
        # D warm restart: a fresh D and a fresh Adam chain at count 0 (its
        # LR schedule starts over); G keeps its momentum.  The fresh D's
        # seed came from the replicated state.rng: every rank's is alike.
        with torch.no_grad():
            for name, p in state.d.named_parameters():
                p.copy_(draws.fresh_d[name])
        state.d_opt = Adam(state.d, lr_schedule(cfg, cfg.d_lr), cfg.adam_b1,
                           cfg.adam_b2)
    if cfg.lecam_weight > 0:
        # One tracker update a step, on the means D saw before its update.
        lc_d = cfg.lecam_decay
        means = {"real": torch.mean(real_logits.detach()),
                 "fake": torch.mean(fake_logits.detach())}
        if mesh is not None:
            summed = world_mean(torch.stack([means["real"], means["fake"]]))
            means = dict(zip(means, summed.unbind()))
        state.lecam_ema = {key: lc_d * state.lecam_ema[key]
                           + (1.0 - lc_d) * means[key]
                           for key in ("real", "fake")}

    # ---------------- G update against the updated D ----------------
    tau = gen(conditions, z)
    tau_d = tau
    if cfg.instance_noise_sigma > 0:
        tau_d = tau_d + sigma * draws.noise[2]
    if cfg.diffaug:
        # G's gradients arrive through the augmented view, at ADA's p.
        cond_g, tau_d = _diffaug(cfg, draws.aug[2], conditions, tau_d)
    else:
        cond_g = conditions
    fm_w = cfg.feature_matching_weight
    if fm_w > 0:
        # Match the first moments of D's last hidden features between the
        # reals D saw and the B*k fakes.
        g_logits, fake_feats = disc(cond_g, tau_d, return_features=True)
        with torch.no_grad():
            _, real_feats = state.d(cond_real_d, real_d.detach(),
                                    return_features=True)
        real_mean = torch.mean(real_feats, dim=0)
        fake_mean = torch.mean(fake_feats.reshape(-1, fake_feats.shape[-1]),
                               dim=0)
        if mesh is not None:
            real_mean, fake_mean = world_mean(
                torch.stack([real_mean, fake_mean])).unbind()
        fm = torch.mean(torch.square(real_mean - fake_mean))
    else:
        g_logits = disc(cond_g, tau_d)
    if cfg.topk_g_fraction > 0:
        # Adversarial gradients only through the fakes D scores most real;
        # the rest still get NDiv's.  Python's round, as the JAX step; on a
        # mesh the global top-k, each rank's share its own kept logits'
        # loss over the global count.
        n_all = g_logits.numel() * (1 if mesh is None
                                    else mesh.dp * mesh.div)
        n_keep = max(int(round(cfg.topk_g_fraction * n_all)), 1)
        if mesh is None:
            g_adv = g_loss_fn(torch.topk(g_logits.reshape(-1), n_keep).values)
        else:
            kept = _global_topk(g_logits.reshape(tau.shape[:2]), n_keep, mesh)
            g_adv = (g_loss_fn(kept) * (kept.numel() / n_keep)
                     if kept.numel() else 0.0 * g_logits.sum())
    else:
        g_adv = share(g_loss_fn(g_logits))
    g_ndiv = _ndiv(cfg, z, tau, mesh)
    # The objective takes whole the terms every rank holds whole (feature
    # matching, the floor): each rank's grads of them are its own samples'
    # part, so the world sum counts them once.  The g_total metric, a
    # world sum, takes their shares.
    g_obj = g_total = g_adv + cfg.ndiv_weight * g_ndiv
    whole = []
    if fm_w > 0:
        whole.append(fm_w * fm)
        metrics["g_fm"] = fm.detach()
    if cfg.div_floor > 0:
        # A hinge on the absolute mean pairwise distance of a condition's k
        # samples, which NDiv's row normalisation cannot see.
        if mesh is None:
            flat = tau.reshape(tau.shape[0], cfg.k, -1)
            off = ~torch.eye(cfg.k, dtype=torch.bool, device=tau.device)
            mpd = torch.sum(torch.where(off, pairwise_l2(flat), 0.0)) / (
                flat.shape[0] * cfg.k * (cfg.k - 1))
        else:
            mpd = world_sum(_floor_partial(tau, cfg.k, mesh), mesh.world) / (
                b * cfg.k * (cfg.k - 1))
        dfloor = F.relu(cfg.div_floor - mpd)
        whole.append(cfg.div_floor_weight * dfloor)
        metrics["g_divfloor"] = dfloor.detach()
    for term in whole:
        g_obj = g_obj + term
        g_total = g_obj if mesh is None else g_total + share(term)
    check_finite("train step: G's forward", {"g_total": g_obj})
    g_grads = torch.autograd.grad(g_obj, list(state.g.parameters()))
    state.g_opt.step(state.g, world_sum_(list(g_grads)))

    # EMA of G (decay 0 reduces to a copy).
    with torch.no_grad():
        ema = list(state.g_ema.parameters())
        torch._foreach_mul_(ema, cfg.g_ema_decay)
        torch._foreach_add_(ema, torch._foreach_mul(
            list(state.g.parameters()), 1.0 - cfg.g_ema_decay))

    # ADA overfitting heuristic r_t, tracked by every run.  Its centre is
    # the loss variant's decision boundary (0.5 for lsgan's scores).
    rt_center = 0.5 if cfg.gan_loss == "lsgan" else 0.0
    rt = share(torch.mean(torch.sign(real_logits.detach() - rt_center)))
    shared = {"d_loss": d_loss.detach(), "g_adv": g_adv.detach(),
              "g_ndiv": g_ndiv.detach(), "g_total": g_total.detach(),
              "d_rt": rt}
    if mesh is not None:
        # The shares summed: R1's and LeCam's too.
        shared.update({key: metrics.pop(key) for key in ("d_lecam", "d_r1")
                       if key in metrics})
        summed = world_sum_([torch.stack(list(shared.values()))])[0]
        shared = dict(zip(shared, summed.unbind()))
    metrics.update(shared)
    a_d = cfg.ada_decay
    ada_r = a_d * state.ada["r"] + (1.0 - a_d) * metrics["d_rt"]
    a_corr = bias_correction(a_d, state.step + 1)
    metrics["d_rt_ema"] = ada_r / max(a_corr, _F32_TINY)
    ada_p = state.ada["p"]
    if cfg.ada_target > 0:
        # Karras et al.'s feedback rule: raise p while D is too sure of the
        # reals (r above target), lower it otherwise.
        ada_p = torch.clamp(
            ada_p + torch.sign(metrics["d_rt_ema"] - cfg.ada_target)
            * cfg.ada_step, 0.0, cfg.ada_p_max)
        metrics["ada_p"] = ada_p
    state.ada = {"r": ada_r, "p": ada_p}
    g_sched = lr_schedule(cfg, cfg.g_lr)
    if callable(g_sched):
        # The LR of this step's G update (one a step, so its position is
        # the step), made on the device by a fill: no copy, no host wait.
        metrics["g_lr"] = torch.full((), g_sched(state.step),
                                     device=real.device)
    if nan_debugging():
        check_finite("train step", {**metrics, **{
            f"{net}.{name}": p for net in ("g", "d")
            for name, p in getattr(state, net).named_parameters()}})
    state.step += 1
    return state, metrics


def train_step_fused(cfg: Config, state: TrainState):
    """Sample a batch on the device from ``state.rng``, then one update."""
    batch = make_task(cfg).sample(state.rng, cfg.batch_size)
    return train_step_impl(cfg, state, batch)


def train_chunk(cfg: Config, state: TrainState, n_steps: int):
    """``n_steps`` steps of :func:`train_step_fused`; returns (state, the
    metrics stacked ``[n_steps]`` as device tensors).

    Nothing here reads a value on the host, so the host queues the chunk's
    steps without waiting for the card; the caller reads the metrics once,
    at a boundary.  The steps run one by one, so a chunk is bitwise the
    same steps taken singly."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    rows = []
    for _ in range(n_steps):
        state, metrics = train_step_fused(cfg, state)
        rows.append(metrics)
    return state, {key: torch.stack([m[key] for m in rows]) for key in rows[0]}
