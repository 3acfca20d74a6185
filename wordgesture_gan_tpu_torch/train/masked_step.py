"""The two-cycle WGAN step on variable-length (masked) batches, its scanned
epoch and its epoch batching (the port of the JAX package's
``train/masked_step.py``).

Batches carry a per-point validity mask. The generator is the transformer
(its attention and time head take the mask), its outputs are zeroed on the
padding, the critics and the encoder see the real traces with the padding
zeroed, and the reconstruction and timing losses count valid points only.
The masked step has no diversity terms (``lambda_ms``, ``lambda_div``), as
in the JAX package. Gradient flow, power-iteration order, the in-place
update, the scanned epoch (``gan_train_epoch_masked``: a captured CUDA graph
replayed once per batch on a CUDA device; the batches are padded to one L,
so every replay has the same shapes) and data parallelism are
``gan_step``'s, with one difference under a process group: the masked
reconstruction loss is a mean over the batch's valid points, so a rank's
share of it is its fraction of the global batch's valid points, not of its
rows.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs import ModelConfig, TrainingConfig
from ..losses import (feature_matching_loss, kl_divergence_loss, latent_encoding_loss,
                      masked_speed_profile_loss, masked_time_delta_corr_loss,
                      masked_time_delta_loss, wgan_generator_loss)
from ..models.gan import disc_apply, encoder_apply
from ..models.generators import transformer_generator_apply
from ..models.layers import jax_products
from ..utils.tree import tree_leaves
from ..parallel.mesh import Mesh, all_reduce_gradients
from .gan_step import _active, critic_update, keep_in_place, shuffle_batches
from .state import apply_update
from .step_graph import StepGraph, run_epoch, step_draws, step_keys

# The step's metrics, in order; a zero-batch epoch records each at 0.0.
METRIC_KEYS = ("d1_loss", "d2_loss", "cycle1_total", "cycle2_total", "cycle2_rec")


def masked_reconstruction_loss(real: torch.Tensor, fake: torch.Tensor,
                               mask: torch.Tensor) -> torch.Tensor:
    """Mean L1 over valid (unpadded) points only; mask (B, L) in {0, 1}."""
    diff = (fake - real).abs() * mask[:, :, None]
    return diff.sum() / torch.clamp(mask.sum() * real.shape[-1], min=1.0)


@jax_products()
def gan_train_step_masked(state: Dict, batch: Dict[str, torch.Tensor], lr: float,
                          model_config: ModelConfig, training_config: TrainingConfig,
                          noise: Optional[Dict[str, torch.Tensor]] = None,
                          mesh: Optional[Mesh] = None) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """One two-cycle step on one masked batch (``gesture``, ``prototype``:
    (B, L, 3); ``mask``: (B, L)), transformer generator only.

    Without ``noise`` the step draws from ``state["rng"]``'s key chain as
    the JAX step does. ``noise`` injects every random draw, with the names
    ``gan_train_step`` uses: ``z_rand``/``eps_enc`` (n_critic, B, Z) for the
    critic loop, ``z1``/``eps_rec``/``eps2`` (B, Z) for the joint step; or
    the step's keys as ``{"keys": (n, 2)}``. With a process
    group in ``mesh``: the global batch and noise, this rank's rows trained
    on, the global metrics returned."""
    if model_config.generator_type != "transformer":
        raise ValueError("variable-length training uses the transformer generator "
                         "(ModelConfig.generator_type='transformer')")
    tc = training_config
    mesh = _active(mesh)
    B, Z, device = batch["gesture"].shape[0], model_config.latent_dim, batch["gesture"].device
    rows = mesh.rows(B) if mesh is not None else slice(0, B)
    real, proto, mask = batch["gesture"][rows], batch["prototype"][rows], batch["mask"][rows]
    b, share = real.shape[0], real.shape[0] / B
    g_params, e_params = state["g"]["params"], state["e"]["params"]
    d1, d2 = state["d1"], state["d2"]
    real_m = real * mask[:, :, None]
    noise = step_draws(noise, state, B, Z, tc.n_critic, False, device)

    def draw(name, axis=0):
        x = noise[name]
        return x if mesh is None else x.narrow(axis, rows.start, b)

    def gen(params, prototype, z, pad_mask):
        out = transformer_generator_apply(params, prototype, z, model_config, pad_mask=pad_mask)
        return out * pad_mask[:, :, None]

    # -- critic loop: G and E frozen; the encoder runs once on the masked real
    # traces, with fresh ε per iteration; both fakes come from one 2B call.
    n_c = tc.n_critic
    d1_loss = d2_loss = torch.zeros((), device=device)
    if n_c > 0:
        z_rands = draw("z_rand", axis=1)
        eps_encs = draw("eps_enc", axis=1)
        with torch.no_grad():
            _, mu_c, log_var_c = encoder_apply(e_params, real_m, model_config, eps=eps_encs[0])
            z_encs = mu_c[None] + eps_encs * torch.exp(0.5 * log_var_c)[None]
        proto2, mask2 = torch.cat([proto, proto]), torch.cat([mask, mask])
        for i in range(n_c):
            with torch.no_grad():
                fakes = gen(g_params, proto2, torch.cat([z_rands[i], z_encs[i]]), mask2)
            d1_loss = critic_update(d1, real_m, fakes[:b], lr, model_config, tc.grad_clip_norm,
                                    mesh=mesh, share=share)
            d2_loss = critic_update(d2, real_m, fakes[b:], lr, model_config, tc.grad_clip_norm,
                                    mesh=mesh, share=share)

    # -- joint G + E step.
    z = draw("z1")
    eps_rec = draw("eps_rec")
    eps2 = draw("eps2")

    # Cycle 1: z → X' → z'.
    fake1 = gen(g_params, proto, z, mask)
    fake1_scores, fake1_feats, d1_sn = disc_apply(d1["params"], d1["sn"], fake1, True,
                                                  model_config)
    with torch.no_grad():
        _, real1_feats, d1_sn = disc_apply(d1["params"], d1_sn, real_m, True, model_config)
        z_rec, _, _ = encoder_apply(e_params, fake1.detach(), model_config, eps=eps_rec)
    c1_total = (wgan_generator_loss(fake1_scores)
                + tc.lambda_feat * feature_matching_loss(real1_feats, fake1_feats)
                + tc.lambda_lat * latent_encoding_loss(z, z_rec))

    # Cycle 2: X → z → X'.
    z_enc, mu, log_var = encoder_apply(e_params, real_m, model_config, eps=eps2)
    fake2 = gen(g_params, proto, z_enc, mask)
    fake2_scores, fake2_feats, d2_sn = disc_apply(d2["params"], d2["sn"], fake2, True,
                                                  model_config)
    with torch.no_grad():
        _, real2_feats, d2_sn = disc_apply(d2["params"], d2_sn, real_m, True, model_config)
    c2_rec = masked_reconstruction_loss(real, fake2, mask)
    # The cycle-2 terms that are means over rows; c2_rec is a mean over points.
    c2_rows = (wgan_generator_loss(fake2_scores)
               + tc.lambda_feat * feature_matching_loss(real2_feats, fake2_feats)
               + tc.lambda_kld * kl_divergence_loss(mu, log_var))
    if tc.lambda_dt:
        c2_rows = c2_rows + tc.lambda_dt * masked_time_delta_loss(real, fake2, mask)
    if tc.lambda_speed:
        c2_rows = c2_rows + tc.lambda_speed * masked_speed_profile_loss(real, fake2, mask)
    if tc.lambda_dtc:
        c2_rows = c2_rows + tc.lambda_dtc * masked_time_delta_corr_loss(real, fake2, mask)
    c2_total = c2_rows + tc.lambda_rec * c2_rec

    objective, extra = c1_total + c2_total, None
    if mesh is not None:
        # This rank's share of the valid points, with the loss's own clamp.
        points = torch.clamp(mask.sum() * real.shape[-1], min=1.0) / torch.clamp(
            batch["mask"].sum() * real.shape[-1], min=1.0)
        rec = c2_rec * points
        c2_share = c2_rows * share + tc.lambda_rec * rec
        objective = c1_total * share + c2_share
        extra = torch.stack([c1_total.detach() * share, c2_share.detach(), rec.detach()])
    g_leaves, e_leaves = tree_leaves(g_params), tree_leaves(e_params)
    grads = torch.autograd.grad(objective, g_leaves + e_leaves)
    grads, totals = all_reduce_gradients(mesh, grads, extra)
    apply_update(g_params, grads[:len(g_leaves)], state["g"]["opt"], lr, tc.grad_clip_norm)
    apply_update(e_params, grads[len(g_leaves):], state["e"]["opt"], lr, tc.grad_clip_norm)
    keep_in_place(d1["sn"], d1_sn)
    keep_in_place(d2["sn"], d2_sn)

    joint = (c1_total, c2_total, c2_rec) if totals is None else totals.unbind()
    values = (d1_loss, d2_loss, *joint)
    return state, {k: v.detach().to(torch.float32) for k, v in zip(METRIC_KEYS, values)}


def gan_train_epoch_masked(state: Dict, epoch_batches: Dict[str, torch.Tensor], lr: float,
                           model_config: ModelConfig, training_config: TrainingConfig,
                           noise: Optional[Dict[str, torch.Tensor]] = None,
                           mesh: Optional[Mesh] = None, graph: Optional[StepGraph] = None
                           ) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """A whole variable-length epoch of ``gan_train_step_masked`` over
    stacked batches (``gesture``, ``prototype`` (n_batches, B, L, 3),
    ``mask`` (n_batches, B, L)): the masked twin of
    ``gan_step.gan_train_epoch``, with the same arguments and results."""
    def step(s, batch, lr_, noise_):
        return gan_train_step_masked(s, batch, lr_, model_config, training_config,
                                     noise=noise_, mesh=mesh)

    return run_epoch(step, state, epoch_batches, lr,
                     lambda rng: step_keys(rng, training_config.n_critic), METRIC_KEYS, noise,
                     graph, key=("gan_train_step_masked", model_config, training_config, mesh),
                     mesh=mesh)


def make_epoch_batches_masked(key: torch.Tensor, gestures: torch.Tensor,
                              prototypes: torch.Tensor, masks: torch.Tensor,
                              batch_size: int) -> Dict[str, torch.Tensor]:
    """``shuffle_batches`` of (``gesture``, ``prototype``, ``mask``) arrays:
    the JAX package's ``make_epoch_batches_masked(key, ...)``."""
    return shuffle_batches(key, {"gesture": gestures, "prototype": prototypes,
                                 "mask": masks}, batch_size)
