"""The two-cycle WGAN train step, the scanned epoch and epoch batching (the
port of the JAX package's ``train/gan_step.py``).

Gradient-flow rules, as in the JAX step:
  * critics train on detached fakes;
  * cycle-1 latent recovery runs the encoder without gradient, so nothing
    flows to E, or back into G, through z';
  * cycle 2's critic scores and features backpropagate into G and E, but the
    joint step takes gradients for G and E only (``torch.autograd.grad`` on
    their leaves), so D1 and D2 get no update and no leftover ``.grad``;
  * the real side's critic features are detached in feature matching;
  * each model is clipped to its own global norm before its Adam step.

Spectral-norm power iteration advances once per critic forward: twice per
critic update (real, then fake) unless ``fused_critic_forward``, and twice per
critic in the joint step, whose advanced u's are kept.

The step updates ``state`` in place (parameters, Adam moments and the
critics' u vectors are overwritten, so every tensor of the state keeps its
address, as a CUDA graph of the step needs) and returns it with its metrics
as 0-d float32 tensors on the device, so no step waits for the host.

``gan_train_epoch`` runs the step over every batch of an epoch, the
counterpart of the JAX package's ``lax.scan`` epoch: on a CUDA device as one
captured CUDA graph replayed once per batch (``step_graph.py``), on the CPU
as a loop.

Random draws follow the JAX step's key chain (``step_graph.step_keys``):
the keys are split off ``state["rng"]`` on the host, and each step's noise
is one threefry draw on the batch's device (``utils/prng.py``), so a state
drawn from a seed trains on the JAX package's numbers.

Data parallelism (``mesh`` with a process group, ``parallel/mesh.py``): every
rank gets the global batch, draws the global batch's noise from its copy of
the key (the same on every rank), and keeps its own contiguous rows of
both. Each loss is a mean over rows, so a rank's share of the global
loss is its local loss times its share of the rows; each gradient
computation (one per critic update, one for G and E together) ends in one
all-reduce of one flat buffer that sums those shares, the metrics riding
along. Clipping and Adam then see the global gradient, so every rank applies
the same update and the step equals the single-process step on the global
batch. The critics' u vectors depend on the weights alone and stay
replicated.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs import ModelConfig, TrainingConfig
from ..losses import (diversity_hinge_loss, feature_matching_loss, kl_divergence_loss,
                      latent_encoding_loss, mode_seeking_loss, reconstruction_loss,
                      speed_profile_loss, time_delta_corr_loss, time_delta_loss,
                      wgan_critic_loss, wgan_generator_loss)
from ..models.gan import disc_apply, encoder_apply, generator_apply
from ..models.layers import jax_products
from ..parallel.mesh import Mesh, all_reduce_gradients
from ..utils import prng
from ..utils.tree import tree_leaves
from .state import apply_update
from .step_graph import StepGraph, run_epoch, step_draws, step_keys


# The step's metrics, in order; a zero-batch epoch records each at 0.0.
METRIC_KEYS = ("d1_loss", "d2_loss", "cycle1_total", "cycle1_wgan", "cycle1_feat", "cycle1_lat",
               "cycle2_total", "cycle2_wgan", "cycle2_feat", "cycle2_rec", "cycle2_kld")


def _active(mesh: Optional[Mesh]) -> Optional[Mesh]:
    return mesh if mesh is not None and mesh.active else None


def keep_in_place(tree, new) -> None:
    """Copy the tensors of ``new`` into those of ``tree`` (the critics'
    advanced u vectors into the state's own), so that the state keeps its
    addresses: a replayed CUDA graph reads the addresses its capture saw."""
    with torch.no_grad():
        torch._foreach_copy_(tree_leaves(tree), tree_leaves(new))


def critic_update(disc: Dict, real: torch.Tensor, fake: torch.Tensor, lr: float,
                  model_config: ModelConfig, grad_clip_norm: float,
                  fused: bool = False, mesh: Optional[Mesh] = None,
                  share: float = 1.0) -> torch.Tensor:
    """One critic step on (real, detached fake): WGAN loss, clip, Adam.
    Updates ``disc`` (``{"params", "opt", "sn"}``) in place; returns the loss.
    Real and fake are two critic forwards, real first, unless ``fused``
    scores them in one. With a process group in ``mesh``, ``real`` and
    ``fake`` are this rank's rows, ``share`` its fraction of the global
    batch, and the gradient and the returned loss are the global ones."""
    fake = fake.detach()
    params, sn = disc["params"], disc["sn"]
    if fused:
        scores, _, sn = disc_apply(params, sn, torch.cat([real, fake]), True, model_config)
        real_scores, fake_scores = scores[:real.shape[0]], scores[real.shape[0]:]
    else:
        real_scores, _, sn = disc_apply(params, sn, real, True, model_config)
        fake_scores, _, sn = disc_apply(params, sn, fake, True, model_config)
    loss = wgan_critic_loss(real_scores, fake_scores)
    mesh = _active(mesh)
    if mesh is not None:
        loss = loss * share
    grads = torch.autograd.grad(loss, tree_leaves(params))
    grads, total = all_reduce_gradients(mesh, grads, None if mesh is None else loss.detach()[None])
    apply_update(params, grads, disc["opt"], lr, grad_clip_norm)
    keep_in_place(disc["sn"], sn)
    return loss.detach() if total is None else total[0]


@jax_products()
def gan_train_step(state: Dict, batch: Dict[str, torch.Tensor], lr: float,
                   model_config: ModelConfig, training_config: TrainingConfig,
                   noise: Optional[Dict[str, torch.Tensor]] = None,
                   mesh: Optional[Mesh] = None) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """One two-cycle step on one batch (``gesture``, ``prototype``: (B, L, 3)).

    Without ``noise`` the step splits its keys off ``state["rng"]`` as the
    JAX step does and draws its noise from them (the JAX step's numbers).
    ``noise`` injects every draw instead: ``z_rand``/``eps_enc`` (n_critic,
    B, Z) for the critic loop, ``z1``/``eps_rec``/``eps2`` (B, Z) for the
    joint step, and ``z_ms`` (B, Z), the second prior draw, when
    ``lambda_ms`` or ``lambda_div`` is on; or it gives the step's keys as
    ``{"keys": (n, 2)}`` (``step_graph.step_keys``), which is how a captured
    step draws. ``lr`` is a Python number, or a 0-d device tensor in a
    captured step.

    With a process group in ``mesh`` the batch and ``noise`` are the global
    ones; the step trains on this rank's rows (module docstring) and returns
    the global metrics."""
    tc = training_config
    mesh = _active(mesh)
    B, Z, device = batch["gesture"].shape[0], model_config.latent_dim, batch["gesture"].device
    rows = mesh.rows(B) if mesh is not None else slice(0, B)
    real, proto = batch["gesture"][rows], batch["prototype"][rows]
    b, share = real.shape[0], real.shape[0] / B
    g_params, e_params = state["g"]["params"], state["e"]["params"]
    d1, d2 = state["d1"], state["d2"]
    diversity = bool(tc.lambda_ms or tc.lambda_div)
    noise = step_draws(noise, state, B, Z, tc.n_critic, diversity, device)

    def draw(name, axis=0):
        x = noise[name]
        return x if mesh is None else x.narrow(axis, rows.start, b)

    # -- critic loop: G and E frozen; the encoder runs once, with fresh ε per
    # iteration; each iteration draws both fakes in one 2B inference call.
    n_c = tc.n_critic
    d1_loss = d2_loss = torch.zeros((), device=device)
    if n_c > 0:
        z_rands = draw("z_rand", axis=1)
        eps_encs = draw("eps_enc", axis=1)
        with torch.no_grad():
            _, mu_c, log_var_c = encoder_apply(e_params, real, model_config, eps=eps_encs[0])
            z_encs = mu_c[None] + eps_encs * torch.exp(0.5 * log_var_c)[None]
        proto2 = torch.cat([proto, proto])
        for i in range(n_c):
            with torch.no_grad():
                fakes = generator_apply(g_params, proto2, torch.cat([z_rands[i], z_encs[i]]),
                                        model_config, inference=True)
            d1_loss = critic_update(d1, real, fakes[:b], lr, model_config, tc.grad_clip_norm,
                                    tc.fused_critic_forward, mesh, share)
            d2_loss = critic_update(d2, real, fakes[b:], lr, model_config, tc.grad_clip_norm,
                                    tc.fused_critic_forward, mesh, share)

    # -- joint G + E step.
    z = draw("z1")
    eps_rec = draw("eps_rec")
    eps2 = draw("eps2")
    z_ms = draw("z_ms") if diversity else None

    # Cycle 1: z → X' → z'.
    fake1 = generator_apply(g_params, proto, z, model_config)
    fake1_scores, fake1_feats, d1_sn = disc_apply(d1["params"], d1["sn"], fake1, True,
                                                  model_config)
    with torch.no_grad():
        _, real1_feats, d1_sn = disc_apply(d1["params"], d1_sn, real, True, model_config)
        z_rec, _, _ = encoder_apply(e_params, fake1.detach(), model_config, eps=eps_rec)
    c1_wgan = wgan_generator_loss(fake1_scores)
    c1_feat = feature_matching_loss(real1_feats, fake1_feats)
    c1_lat = latent_encoding_loss(z, z_rec)
    c1_total = c1_wgan + tc.lambda_feat * c1_feat + tc.lambda_lat * c1_lat
    if diversity:
        fake_ms = generator_apply(g_params, proto, z_ms, model_config)
        if tc.lambda_ms:
            c1_total = c1_total + tc.lambda_ms * mode_seeking_loss(fake1, fake_ms, z, z_ms)
        if tc.lambda_div:
            if tc.div_margin is None:
                raise ValueError("lambda_div requires div_margin; the training loop "
                                 "measures it from the data when left as None")
            c1_total = c1_total + tc.lambda_div * diversity_hinge_loss(fake1, fake_ms,
                                                                       tc.div_margin)

    # Cycle 2: X → z → X'.
    z_enc, mu, log_var = encoder_apply(e_params, real, model_config, eps=eps2)
    fake2 = generator_apply(g_params, proto, z_enc, model_config)
    fake2_scores, fake2_feats, d2_sn = disc_apply(d2["params"], d2["sn"], fake2, True,
                                                  model_config)
    with torch.no_grad():
        _, real2_feats, d2_sn = disc_apply(d2["params"], d2_sn, real, True, model_config)
    c2_wgan = wgan_generator_loss(fake2_scores)
    c2_feat = feature_matching_loss(real2_feats, fake2_feats)
    c2_rec = reconstruction_loss(real, fake2)
    c2_kld = kl_divergence_loss(mu, log_var)
    c2_total = (c2_wgan + tc.lambda_feat * c2_feat + tc.lambda_rec * c2_rec
                + tc.lambda_kld * c2_kld)
    if tc.lambda_dt:
        c2_total = c2_total + tc.lambda_dt * time_delta_loss(real, fake2)
    if tc.lambda_speed:
        c2_total = c2_total + tc.lambda_speed * speed_profile_loss(real, fake2)
    if tc.lambda_dtc:
        c2_total = c2_total + tc.lambda_dtc * time_delta_corr_loss(real, fake2)

    joint = (c1_total, c1_wgan, c1_feat, c1_lat, c2_total, c2_wgan, c2_feat, c2_rec, c2_kld)
    objective, extra = c1_total + c2_total, None
    if mesh is not None:
        objective = objective * share
        extra = torch.stack([v.detach().to(torch.float32) for v in joint]) * share
    g_leaves, e_leaves = tree_leaves(g_params), tree_leaves(e_params)
    grads = torch.autograd.grad(objective, g_leaves + e_leaves)
    grads, totals = all_reduce_gradients(mesh, grads, extra)
    apply_update(g_params, grads[:len(g_leaves)], state["g"]["opt"], lr, tc.grad_clip_norm)
    apply_update(e_params, grads[len(g_leaves):], state["e"]["opt"], lr, tc.grad_clip_norm)
    keep_in_place(d1["sn"], d1_sn)
    keep_in_place(d2["sn"], d2_sn)

    values = (d1_loss, d2_loss, *(joint if totals is None else totals.unbind()))
    return state, {k: v.detach().to(torch.float32) for k, v in zip(METRIC_KEYS, values)}


def gan_train_epoch(state: Dict, epoch_batches: Dict[str, torch.Tensor], lr: float,
                    model_config: ModelConfig, training_config: TrainingConfig,
                    noise: Optional[Dict[str, torch.Tensor]] = None,
                    mesh: Optional[Mesh] = None,
                    graph: Optional[StepGraph] = None) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """A whole epoch of ``gan_train_step`` over stacked batches
    (``gesture``, ``prototype``: (n_batches, B, L, 3), already shuffled on
    the device): the counterpart of the JAX package's ``lax.scan`` epoch.

    On a CUDA device the step is captured once as a CUDA graph and replayed
    once per batch (``step_graph.py``); ``graph`` is the ``StepGraph`` to
    reuse across epochs (``train_gan`` keeps one per run; None captures
    afresh). On the CPU the steps run in a loop. Each step draws from
    ``state["rng"]``'s key chain what the eager step draws, unless ``noise``
    gives every step's draws stacked (n_batches, ...) under
    ``gan_train_step``'s names.
    Returns the state, its epoch advanced by one, and {metric: (n_batches,)
    float32 trace on the device}."""
    tc = training_config
    diversity = bool(tc.lambda_ms or tc.lambda_div)

    def step(s, batch, lr_, noise_):
        return gan_train_step(s, batch, lr_, model_config, tc, noise=noise_, mesh=mesh)

    return run_epoch(step, state, epoch_batches, lr,
                     lambda rng: step_keys(rng, tc.n_critic, diversity), METRIC_KEYS, noise,
                     graph, key=("gan_train_step", model_config, tc, mesh), mesh=mesh)


def shuffle_batches(key: torch.Tensor, arrays: Dict[str, torch.Tensor],
                    batch_size: int) -> Dict[str, torch.Tensor]:
    """Shuffle every array of ``arrays`` by ``permutation(key, n)`` (the JAX
    package's, ``utils/prng.py``) and cut each into (n_batches, B, ...)
    stacks, dropping the last partial batch. The permutation's sort keys are
    drawn on the data's device."""
    first = next(iter(arrays.values()))
    n = first.shape[0]
    n_batches = n // batch_size
    perm = prng.permutation(key, n, device=first.device)[:n_batches * batch_size]
    return {name: x[perm.to(x.device)].reshape(n_batches, batch_size, *x.shape[1:])
            for name, x in arrays.items()}


def make_epoch_batches(key: torch.Tensor, gestures: torch.Tensor,
                       prototypes: torch.Tensor, batch_size: int) -> Dict[str, torch.Tensor]:
    """``shuffle_batches`` of (``gesture``, ``prototype``) (n, L, 3) arrays:
    the JAX package's ``make_epoch_batches(key, ...)``."""
    return shuffle_batches(key, {"gesture": gestures, "prototype": prototypes}, batch_size)
