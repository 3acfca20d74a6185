"""Gesture normalization, arc-length resampling, and canonical alignment.

Host-side numpy with the dtype and rounding flow of the reference
implementation; the port's copy of the JAX package's ``data/preprocess.py``,
held bit-equal to it by the tests.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..keyboard import QWERTYKeyboard
from .parse import RawGesture


def normalize_gesture(raw: RawGesture, seq_length: int = 128,
                      time64: bool = False) -> np.ndarray:
    """Normalize one raw trace and resample it to ``seq_length`` points.

    Semantics (reference data.py:234-323):
      * x, y → [-1, 1] by the keyboard width/height captured at touchstart
        (computed in float64, stored float32 — same rounding as the reference,
        which normalizes Python floats before building the float32 array);
      * t → cumulative [0, 1] from the start timestamp, in float32 arithmetic;
        degenerate zero-duration traces get a uniform time ramp;
      * all three channels resampled jointly at uniform *spatial* arc length
        (so time becomes non-uniform, encoding the velocity profile);
      * traces whose total arc length < 1e-6 collapse to a repeated first
        point with a uniform time ramp.

    ``time64=True`` does the duration math in float64 before narrowing —
    the fix for the reference defect documented below (the variable-length
    pipeline always does this; here it is opt-in to preserve bit parity by
    default). See ARCHITECTURE.md "Timing dynamics study" for the measured
    effect.
    """
    pts64 = raw.points
    if len(pts64) < 2:
        return np.zeros((seq_length, 3), dtype=np.float32)

    points = np.empty((len(pts64), 3), dtype=np.float32)
    points[:, 0] = (pts64[:, 0] / raw.keyb_width) * 2.0 - 1.0
    points[:, 1] = (pts64[:, 1] / raw.keyb_height) * 2.0 - 1.0

    if time64:
        t64 = np.asarray(pts64[:, 2], np.float64)
        duration64 = t64[-1] - t64[0]
        if duration64 > 0:
            points[:, 2] = (t64 - t64[0]) / duration64
        else:
            points[:, 2] = np.linspace(0, 1, len(points))
        if len(points) == seq_length:
            return points
        return _resample_trace(points, seq_length)

    # KNOWN REFERENCE DEFECT, kept for bit parity (data.py:267-277): raw
    # Unix-epoch-ms timestamps are narrowed to float32 BEFORE the duration
    # subtraction. float32 spacing at ~1.6e12 is 131072 ms, so every real
    # swipelog gesture shorter than ~2 min collapses to duration 0 and takes
    # the uniform-ramp else-branch below — the reference's published timing
    # metrics are computed on exactly this fallback. The variable-length
    # pipeline (no parity mandate) does the time math in float64 instead;
    # the fixed-length pipeline offers it via ``time64=True``.
    points[:, 2] = pts64[:, 2]

    start, end = points[0, 2], points[-1, 2]
    duration = end - start
    if duration > 0:
        points[:, 2] = (points[:, 2] - start) / duration
    else:
        points[:, 2] = np.linspace(0, 1, len(points))

    if len(points) == seq_length:
        return points

    return _resample_trace(points, seq_length)


def _resample_trace(points: np.ndarray, seq_length: int) -> np.ndarray:
    """Arc-length-uniform resampling of a float32 (n, 3) trace, vectorized with
    the exact clamp/degenerate semantics of the reference per-point loop
    (data.py:286-323). Interpolation runs in float64 (scalar targets in the
    reference promote to float64) and is stored float32 — bit-identical."""
    diffs = np.diff(points[:, :2], axis=0)
    seg_len = np.sqrt(np.sum(diffs ** 2, axis=1))          # float32
    # List-concat promotes to float64 holding exact float32 values — the
    # reference's dtype flow (data.py:291), load-bearing for bit equality.
    cum_len = np.concatenate([[0], np.cumsum(seg_len)])
    total = cum_len[-1]

    resampled = np.zeros((seq_length, 3), dtype=np.float32)
    if total < 1e-6:
        resampled[:, 0] = points[0, 0]
        resampled[:, 1] = points[0, 1]
        resampled[:, 2] = np.linspace(points[0, 2], points[-1, 2], seq_length)
        return resampled

    targets = np.linspace(0, total, seq_length)            # float64
    idx = np.searchsorted(cum_len, targets, side="right") - 1
    idx = np.clip(idx, 0, len(points) - 2)

    seg_start = cum_len[idx]
    seg_span = cum_len[idx + 1] - seg_start
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(seg_span > 1e-6, (targets - seg_start) / seg_span, 0.0)
    frac = np.clip(frac, 0.0, 1.0)

    # float32 difference first, then float64 scale — reference data.py:321.
    p0 = points[idx]
    step = points[idx + 1] - p0
    resampled[:] = p0 + frac[:, None] * step
    return resampled


def infer_key_positions(
    gestures_by_word: Dict[str, List[np.ndarray]],
    min_samples: int = 10,
) -> Dict[str, Tuple[float, float]]:
    """Per-letter medians of gesture start points (words starting with the
    letter) ∪ end points (words ending with it); letters with fewer than
    ``min_samples`` observations are dropped (reference data.py:19-59)."""
    starts: Dict[str, List[np.ndarray]] = {}
    ends: Dict[str, List[np.ndarray]] = {}

    for word, gestures in gestures_by_word.items():
        if len(word) < 2:
            continue
        for g in gestures:
            starts.setdefault(word[0], []).append(g[0, :2])
            ends.setdefault(word[-1], []).append(g[-1, :2])

    inferred: Dict[str, Tuple[float, float]] = {}
    for letter in "qwertyuiopasdfghjklzxcvbnm":
        samples = starts.get(letter, []) + ends.get(letter, [])
        if len(samples) >= min_samples:
            arr = np.array(samples)
            inferred[letter] = (np.median(arr[:, 0]), np.median(arr[:, 1]))
    return inferred


def compute_canonical_transform(
    inferred_positions: Dict[str, Tuple[float, float]],
    keyboard: QWERTYKeyboard,
) -> Dict[str, float]:
    """Per-axis least-squares fit ``canonical = scale * gesture + offset``
    from inferred key positions to canonical QWERTY centers
    (reference data.py:62-105)."""
    letters = list(inferred_positions.keys())
    if len(letters) < 2:
        raise ValueError(
            f"Cannot fit the canonical transform: only {len(letters)} "
            f"letter(s) reached the minimum observation count — the dataset "
            f"is too small (try more log files or a lower min_samples)."
        )
    gesture = np.array([inferred_positions[c] for c in letters])
    canonical = np.array([keyboard.get_key_center(c) for c in letters])

    def fit_axis(g: np.ndarray, c: np.ndarray) -> Tuple[float, float]:
        design = np.vstack([g, np.ones(len(g))]).T
        scale, offset = np.linalg.lstsq(design, c, rcond=None)[0]
        return scale, offset

    sx, ox = fit_axis(gesture[:, 0], canonical[:, 0])
    sy, oy = fit_axis(gesture[:, 1], canonical[:, 1])
    return {"scale_x": sx, "offset_x": ox, "scale_y": sy, "offset_y": oy}


def apply_canonical_transform(gesture: np.ndarray, transform: Dict[str, float]) -> np.ndarray:
    """Apply the fitted linear map to a gesture's x/y channels
    (reference data.py:108-125)."""
    out = gesture.copy()
    out[:, 0] = transform["scale_x"] * gesture[:, 0] + transform["offset_x"]
    out[:, 1] = transform["scale_y"] * gesture[:, 1] + transform["offset_y"]
    return out
