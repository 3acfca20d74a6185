"""Batched arc-length resampling and word prototypes on the device (the port
of the JAX package's ``ops/resample.py``).

Inputs are padded to static shapes with per-row valid lengths; every row of
a batch is resampled at once, with no loop over traces. The host pipeline
keeps its numpy resampler (``data/preprocess.py``); these are its batched
equivalents, which ``eval_cli --variable-length`` uses to bring real and
generated traces onto one 128-point grid.
"""

from __future__ import annotations

import torch


def batched_arclength_resample(points: torch.Tensor, n_valid: torch.Tensor,
                               out_len: int = 128) -> torch.Tensor:
    """Uniform-arc-length resampling of padded polylines: points (B, N, D)
    with rows at or past ``n_valid`` (B,) ignored → (B, out_len, D).

    The arc length is measured on the first two channels; the others ride
    the interpolation. As in the host resampler, the segment fraction is
    clipped to [0, 1], a degenerate segment (span <= 1e-6) has fraction 0, and
    a trace of zero length repeats its first point."""
    B, N, D = points.shape
    n_valid = n_valid.to(device=points.device, dtype=torch.long)
    valid_seg = torch.arange(N - 1, device=points.device)[None, :] < (n_valid[:, None] - 1)
    diffs = points[:, 1:, :2] - points[:, :-1, :2]
    seg_len = torch.sqrt((diffs * diffs).sum(dim=-1)) * valid_seg
    cum = torch.cat([seg_len.new_zeros((B, 1)), torch.cumsum(seg_len, dim=1)], dim=1)   # (B, N)
    total = cum[:, -1:]

    targets = torch.linspace(0.0, 1.0, out_len, device=points.device,
                             dtype=points.dtype)[None, :] * total                    # (B, out)
    seg_idx = torch.clamp(torch.searchsorted(cum, targets, right=True) - 1, 0, N - 2)
    seg_idx = torch.minimum(seg_idx, torch.clamp(n_valid - 2, min=0)[:, None])

    seg_start = torch.gather(cum, 1, seg_idx)
    span = torch.gather(cum, 1, seg_idx + 1) - seg_start
    frac = torch.where(span > 1e-6, (targets - seg_start) / span, torch.zeros_like(span))
    frac = torch.clamp(frac, 0.0, 1.0)

    p0 = torch.gather(points, 1, seg_idx[..., None].expand(B, out_len, D))
    p1 = torch.gather(points, 1, (seg_idx + 1)[..., None].expand(B, out_len, D))
    out = p0 + frac[..., None] * (p1 - p0)
    return torch.where(total[..., None] > 1e-6, out, points[:, :1, :].expand(B, out_len, D))


def batched_word_prototypes(key_positions: torch.Tensor, n_keys: torch.Tensor,
                            out_len: int = 128) -> torch.Tensor:
    """Straight-line prototypes for a batch of words: key centers (B, K, 2),
    padded, with ``n_keys`` (B,) valid → (B, out_len, 3), the polyline
    through the centers at uniform arc length and a uniform time column
    (the batched ``QWERTYKeyboard.get_word_prototype``). A word with one
    key is a constant point at it; a word with none is zeros."""
    B = key_positions.shape[0]
    n_keys = n_keys.to(device=key_positions.device, dtype=torch.long)
    xy = batched_arclength_resample(key_positions, torch.clamp(n_keys, min=2), out_len)
    times = torch.linspace(0.0, 1.0, out_len, device=key_positions.device,
                           dtype=key_positions.dtype)[None, :, None].expand(B, out_len, 1)
    single = key_positions[:, :1, :].expand(B, out_len, 2)
    xy = torch.where((n_keys >= 2)[:, None, None], xy, single)
    xy = torch.where((n_keys >= 1)[:, None, None], xy, torch.zeros_like(xy))
    return torch.cat([xy, times], dim=-1)
