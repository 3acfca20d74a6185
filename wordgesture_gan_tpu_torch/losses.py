"""The GAN losses, fixed-length and masked, and the supervised contrastive
loss (the port of the JAX package's ``losses.py``). Every loss returns a
float32 scalar tensor."""

from __future__ import annotations

from typing import List

import torch


# -- WGAN --------------------------------------------------------------------------------


def wgan_critic_loss(real_scores: torch.Tensor, fake_scores: torch.Tensor) -> torch.Tensor:
    """E[D(fake)] - E[D(real)], minimized by the critic."""
    return fake_scores.mean() - real_scores.mean()


def wgan_generator_loss(fake_scores: torch.Tensor) -> torch.Tensor:
    """-E[D(fake)], minimized by the generator."""
    return -fake_scores.mean()


# -- Pix2PixHD feature matching ------------------------------------------------------------


def feature_matching_loss(real_features: List[torch.Tensor],
                          fake_features: List[torch.Tensor]) -> torch.Tensor:
    """Mean over layers of the per-layer L1 between critic features, each
    divided by its per-sample element count. Real features are detached; the
    difference and its mean are taken in float32 (features may be bf16)."""
    total = 0.0
    for real, fake in zip(real_features, fake_features):
        per_sample = real.numel() // real.shape[0]
        diff = fake.to(torch.float32) - real.detach().to(torch.float32)
        total = total + diff.abs().mean() / per_sample
    return total / len(real_features)


# -- reconstruction / latent / KLD ---------------------------------------------------------


def reconstruction_loss(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """Mean L1 over (x, y, t)."""
    return (fake - real).abs().mean()


def latent_encoding_loss(z_original: torch.Tensor, z_recovered: torch.Tensor) -> torch.Tensor:
    """BicycleGAN latent recovery: mean L1 between drawn and re-encoded z."""
    return (z_recovered - z_original).abs().mean()


def kl_divergence_loss(mu: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    """-0.5 · sum(1 + log_var - mu² - exp(log_var)), averaged over the batch."""
    return (-0.5 * (1 + log_var - mu * mu - torch.exp(log_var)).sum(dim=1)).mean()


# -- timing-dynamics auxiliaries -----------------------------------------------------------


def time_delta_loss(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """Mean L1 between per-segment time increments, scaled by (L-1)."""
    L = real.shape[1]
    dtr = torch.diff(real[:, :, 2], dim=1)
    dtf = torch.diff(fake[:, :, 2], dim=1)
    return ((L - 1) * (dtf - dtr).abs()).mean()


def _pearson_loss(a: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """1 − mean per-row Pearson correlation of (B, n) rows."""
    am = a - a.mean(dim=1, keepdim=True)
    bm = b - b.mean(dim=1, keepdim=True)
    num = (am * bm).sum(dim=1)
    den = torch.sqrt((am * am).sum(dim=1) * (bm * bm).sum(dim=1) + eps)
    return (1.0 - num / den).mean()


def speed_profile_loss(real: torch.Tensor, fake: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """1 − mean per-pair Pearson correlation of the |v| profiles; ``eps``
    floors Δt so pause segments do not explode the gradient."""

    def speeds(g: torch.Tensor) -> torch.Tensor:
        d = torch.diff(g[:, :, :2], dim=1)
        seg = torch.sqrt((d * d).sum(dim=-1) + 1e-12)
        return seg / torch.clamp(torch.diff(g[:, :, 2], dim=1), min=eps)

    return _pearson_loss(speeds(real), speeds(fake), 1e-8)


def time_delta_corr_loss(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """1 − mean per-pair Pearson correlation of the Δt patterns."""
    return _pearson_loss(torch.diff(real[:, :, 2], dim=1), torch.diff(fake[:, :, 2], dim=1), 1e-12)


# -- masked twins (variable-length training) ----------------------------------------------
#
# The same semantics restricted to segments whose BOTH endpoints are valid:
# segment i is (point i, point i+1), so its weight is mask[:, 1:]·mask[:, :-1],
# and padded positions add exactly zero to every sum.


def _segment_weights(mask: torch.Tensor) -> torch.Tensor:
    return mask[:, 1:] * mask[:, :-1]


def _masked_pearson(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """Per-row Pearson correlation over weighted (0/1) segments."""
    n = torch.clamp(w.sum(dim=1, keepdim=True), min=1.0)
    am = (a - (a * w).sum(dim=1, keepdim=True) / n) * w
    bm = (b - (b * w).sum(dim=1, keepdim=True) / n) * w
    num = (am * bm).sum(dim=1)
    den = torch.sqrt((am * am).sum(dim=1) * (bm * bm).sum(dim=1) + eps)
    return num / den


def masked_time_delta_loss(real: torch.Tensor, fake: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """``time_delta_loss`` over valid segments, with its per-row SUM of
    |Δt_fake − Δt_real| semantics, averaged over rows."""
    w = _segment_weights(mask)
    d = (torch.diff(fake[:, :, 2], dim=1) - torch.diff(real[:, :, 2], dim=1)).abs()
    return (w * d).sum(dim=1).mean()


def masked_speed_profile_loss(real: torch.Tensor, fake: torch.Tensor, mask: torch.Tensor,
                              eps: float = 1e-4) -> torch.Tensor:
    """``speed_profile_loss`` over valid segments (1 − masked Pearson of |v|)."""

    def speeds(g: torch.Tensor) -> torch.Tensor:
        d = torch.diff(g[:, :, :2], dim=1)
        seg = torch.sqrt((d * d).sum(dim=-1) + 1e-12)
        return seg / torch.clamp(torch.diff(g[:, :, 2], dim=1), min=eps)

    corr = _masked_pearson(speeds(real), speeds(fake), _segment_weights(mask), 1e-8)
    return (1.0 - corr).mean()


def masked_time_delta_corr_loss(real: torch.Tensor, fake: torch.Tensor,
                                mask: torch.Tensor) -> torch.Tensor:
    """``time_delta_corr_loss`` over valid segments (1 − masked Pearson of Δt)."""
    corr = _masked_pearson(torch.diff(real[:, :, 2], dim=1), torch.diff(fake[:, :, 2], dim=1),
                           _segment_weights(mask), 1e-12)
    return (1.0 - corr).mean()


# -- diversity -----------------------------------------------------------------------------


def mode_seeking_loss(fake_a: torch.Tensor, fake_b: torch.Tensor, z_a: torch.Tensor,
                      z_b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """MSGAN regularizer: mean of d(z_a, z_b) / d(G(z_a), G(z_b)), the latent
    distance detached."""
    d_fake = (fake_a - fake_b).abs().mean(dim=(1, 2))
    d_z = (z_a - z_b).abs().mean(dim=1).detach()
    return (d_z / (d_fake + eps)).mean()


def diversity_hinge_loss(fake_a: torch.Tensor, fake_b: torch.Tensor,
                         margin: float) -> torch.Tensor:
    """Penalize a pair of generations from two prior draws only while their
    mean-L1 distance is below ``margin``; scale-free in the margin."""
    d = (fake_a - fake_b).abs().mean(dim=(1, 2))
    return (torch.relu(margin - d) / margin).mean()


# -- supervised contrastive ----------------------------------------------------------------


def supervised_contrastive_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                                temperature: float = 0.07) -> torch.Tensor:
    """SupCon (Khosla et al. 2020) over L2-normalized embeddings.

    Same-label pairs (minus self) are positives; the log-softmax denominator
    excludes self; the row max subtracted for stability carries no gradient;
    rows without positives contribute 0 through the clamp-to-1 divisor."""
    B = embeddings.shape[0]
    sim = embeddings @ embeddings.T / temperature
    same = (labels[:, None] == labels[None, :]).to(sim.dtype)
    eye = torch.eye(B, dtype=sim.dtype, device=sim.device)
    pos_mask = same - eye

    logits = sim - sim.max(dim=1, keepdim=True).values.detach()
    exp_logits = torch.exp(logits) * (1.0 - eye)
    log_prob = logits - torch.log(exp_logits.sum(dim=1, keepdim=True) + 1e-8)

    pos_count = torch.clamp(pos_mask.sum(dim=1), min=1.0)
    mean_log_prob = (pos_mask * log_prob).sum(dim=1) / pos_count
    return -mean_log_prob.mean()
