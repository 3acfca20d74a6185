"""Time-aware gesture dynamics metrics, fully batched (the port of the JAX
package's ``ops/stats.py``).

Velocities, accelerations and jerk as true d/dt finite differences with the
reference implementation's epsilon guards, and per-pair Pearson correlations
with its percentile clipping and validity filtering, for all pairs at once in
tensors on the inputs' device. Everything is float32; standard deviations
are the population ones (ddof 0), percentiles interpolate linearly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _safe_dt(dt: torch.Tensor) -> torch.Tensor:
    """dt with |dt| <= 1e-10 replaced by ±1e-10 (+ for an exact 0)."""
    return torch.where(dt.abs() > 1e-10, dt, 1e-10 * torch.sign(dt + 1e-20))


def time_aware_velocity(gestures: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, L, 3) → velocity (n, L-1, 2) at segment midpoints, midpoint times
    (n, L-1)."""
    xy = gestures[:, :, :2]
    t = gestures[:, :, 2]
    dxy = torch.diff(xy, dim=1)
    dt = torch.diff(t, dim=1)
    t_mid = (t[:, :-1] + t[:, 1:]) / 2.0
    return dxy / _safe_dt(dt)[:, :, None], t_mid


def time_aware_acceleration(gestures: torch.Tensor) -> torch.Tensor:
    """(n, L, 3) → acceleration (n, L-2, 2)."""
    velocity, t_mid = time_aware_velocity(gestures)
    dv = torch.diff(velocity, dim=1)
    dt_mid = torch.diff(t_mid, dim=1)
    return dv / _safe_dt(dt_mid)[:, :, None]


def time_aware_jerk(gestures: torch.Tensor) -> torch.Tensor:
    """(n, L, 3) → per-gesture mean |d³xy/dt³|."""
    _, t_mid = time_aware_velocity(gestures)
    acceleration = time_aware_acceleration(gestures)
    t_acc = (t_mid[:, :-1] + t_mid[:, 1:]) / 2.0
    da = torch.diff(acceleration, dim=1)
    dt_acc = torch.diff(t_acc, dim=1)
    dt_safe = torch.where(dt_acc.abs() > 1e-10, dt_acc, torch.full_like(dt_acc, 1e-10))
    jerk = da / dt_safe[:, :, None]
    return torch.sqrt(torch.sum(jerk * jerk, dim=-1)).mean(dim=1)


def _pearson_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise Pearson correlation of (n, K) against (n, K) → (n,)."""
    am = a - a.mean(dim=1, keepdim=True)
    bm = b - b.mean(dim=1, keepdim=True)
    num = (am * bm).sum(dim=1)
    den = torch.sqrt((am * am).sum(dim=1) * (bm * bm).sum(dim=1))
    return num / den


def _masked_mean_corr(a: torch.Tensor, b: torch.Tensor, corr_valid: torch.Tensor) -> torch.Tensor:
    corr = _pearson_rows(a, b)
    valid = corr_valid & torch.isfinite(corr)
    count = valid.sum()
    total = torch.where(valid, corr, torch.zeros_like(corr)).sum()
    return torch.where(count > 0, total / count.clamp_min(1), torch.zeros_like(total))


def _clip_rows_percentile(x: torch.Tensor, lo_pct, hi_pct) -> torch.Tensor:
    hi = torch.quantile(x, hi_pct / 100.0, dim=1, keepdim=True, interpolation="linear")
    if lo_pct is None:
        return torch.minimum(x.clamp_min(0.0), hi)
    lo = torch.quantile(x, lo_pct / 100.0, dim=1, keepdim=True, interpolation="linear")
    return torch.minimum(torch.maximum(x, lo), hi)


def _std(x: torch.Tensor) -> torch.Tensor:
    return x.std(dim=1, unbiased=False)


def velocity_correlation(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """Mean per-pair correlation of flattened velocity vectors, 1-99 pct
    clipped; pairs with ~zero variance excluded."""
    vr, _ = time_aware_velocity(real)
    vf, _ = time_aware_velocity(fake)
    vr = vr.reshape(vr.shape[0], -1)
    vf = vf.reshape(vf.shape[0], -1)
    valid = (_std(vr) > 1e-10) & (_std(vf) > 1e-10)
    return _masked_mean_corr(_clip_rows_percentile(vr, 1, 99), _clip_rows_percentile(vf, 1, 99),
                             valid)


def acceleration_correlation(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """Mean per-pair correlation of flattened acceleration vectors, 1-99 pct
    clipped."""
    ar = time_aware_acceleration(real).reshape(real.shape[0], -1)
    af = time_aware_acceleration(fake).reshape(fake.shape[0], -1)
    valid = (_std(ar) > 1e-10) & (_std(af) > 1e-10)
    return _masked_mean_corr(_clip_rows_percentile(ar, 1, 99), _clip_rows_percentile(af, 1, 99),
                             valid)


def speed_profile_correlation(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """Correlation of |v| profiles, clipped to [0, p99]."""
    vr, _ = time_aware_velocity(real)
    vf, _ = time_aware_velocity(fake)
    sr = torch.sqrt(torch.sum(vr * vr, dim=-1))
    sf = torch.sqrt(torch.sum(vf * vf, dim=-1))
    valid = (_std(sr) > 1e-10) & (_std(sf) > 1e-10)
    return _masked_mean_corr(_clip_rows_percentile(sr, None, 99),
                             _clip_rows_percentile(sf, None, 99), valid)


def time_delta_correlation(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """Correlation of diff(t) patterns, unclipped."""
    dtr = torch.diff(real[:, :, 2], dim=1)
    dtf = torch.diff(fake[:, :, 2], dim=1)
    valid = (_std(dtr) > 1e-10) & (_std(dtf) > 1e-10)
    return _masked_mean_corr(dtr, dtf, valid)


def pairwise_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean cdist between flattened feature rows: (n, K), (m, K) → (n, m),
    the cross term as one matrix product."""
    a2 = torch.sum(a * a, dim=1)
    b2 = torch.sum(b * b, dim=1)
    sq = a2[:, None] + b2[None, :] - 2.0 * (a @ b.T)
    return torch.sqrt(sq.clamp_min(0.0))


def knn_precision_recall(
    real_flat: torch.Tensor, fake_flat: torch.Tensor, k: int,
    real_dists: Optional[torch.Tensor] = None, real_radii: Optional[torch.Tensor] = None,
    cross: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """k-NN manifold precision/recall.

    radius_i = distance to the k-th same-set neighbor (sorted row, index k —
    which includes the self-distance 0 at index 0, as in the reference
    implementation). precision = fraction of fakes within any real ball;
    recall = fraction of reals within any fake ball. Returns (precision,
    recall, real_dists, real_radii) so the real side can be cached across
    model evaluations. ``cross`` accepts a precomputed (n_real, n_fake)
    real↔fake distance matrix."""
    if real_dists is None:
        real_dists = pairwise_l2(real_flat, real_flat)
        real_radii = torch.sort(real_dists, dim=1).values[:, k]
    fake_dists = pairwise_l2(fake_flat, fake_flat)
    fake_radii = torch.sort(fake_dists, dim=1).values[:, k]
    if cross is None:
        cross = pairwise_l2(real_flat, fake_flat)               # (n, m)

    precision = torch.any(cross <= real_radii[:, None], dim=0).float().mean()
    recall = torch.any(cross <= fake_radii[None, :], dim=1).float().mean()
    return precision, recall, real_dists, real_radii
