"""QWERTY keyboard geometry and word prototypes (the prototype half of the
JAX package's ``keyboard.py``; the minimum-jerk baseline is not ported yet).

Host-side numpy with the same arithmetic as the JAX package, so prototypes
agree bit for bit. Coordinate convention: key centers live in a canonical
space with x spanning [-0.9, 0.9] per row (minus row offset) and row-center
y values at ``-1 + (row + 0.5) * 2/3`` for 3 rows.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .configs import DEFAULT_KEYBOARD_CONFIG, KeyboardConfig

ALPHABET = "abcdefghijklmnopqrstuvwxyz"
LETTER_TO_INDEX = {c: i for i, c in enumerate(ALPHABET)}


def compute_key_centers(config: KeyboardConfig = DEFAULT_KEYBOARD_CONFIG) -> Dict[str, Tuple[float, float]]:
    """Canonical key-center coordinates."""
    centers: Dict[str, Tuple[float, float]] = {}
    n_rows = len(config.rows)
    for row_idx, (row, offset) in enumerate(zip(config.rows, config.row_offsets)):
        y = -1.0 + (row_idx + 0.5) * (2.0 / n_rows)
        span = 1.8 - offset
        start = -0.9 + offset / 2.0
        n_keys = len(row)
        for key_idx, key in enumerate(row):
            x = start + (key_idx + 0.5) * (span / n_keys)
            centers[key.lower()] = (x, y)
    return centers


def word_to_key_indices(word: str) -> np.ndarray:
    """Letter indices for the keyed characters of a word (non-letters dropped)."""
    return np.array([LETTER_TO_INDEX[c] for c in word.lower() if c in LETTER_TO_INDEX], dtype=np.int32)


def _uniform_time_column(num_points: int) -> np.ndarray:
    return np.linspace(0, 1, num_points).reshape(-1, 1)


def _constant_point_prototype(x: float, y: float, num_points: int) -> np.ndarray:
    """Single-letter / degenerate-word prototype."""
    proto = np.zeros((num_points, 3), dtype=np.float32)
    proto[:, 0] = x
    proto[:, 1] = y
    proto[:, 2] = np.linspace(0, 1, num_points)
    return proto


def resample_polyline_by_arclength(points: np.ndarray, num_points: int) -> np.ndarray:
    """Arc-length-uniform resampling of a (k, d) polyline → (num_points, d)
    float32 (float64 math stored into float32). Assumes total arc length
    > 1e-6 (callers handle the degenerate case)."""
    k = points.shape[0]
    seg_len = np.sqrt(np.sum(np.diff(points, axis=0) ** 2, axis=1))
    cum_len = np.concatenate([[0], np.cumsum(seg_len)])
    total = cum_len[-1]

    targets = np.linspace(0, total, num_points)          # float64
    idx = np.searchsorted(cum_len, targets, side="right") - 1
    idx = np.clip(idx, 0, k - 2)

    seg_start = cum_len[idx]
    seg_span = cum_len[idx + 1] - seg_start
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(seg_span > 1e-6, (targets - seg_start) / seg_span, 0.0)
    frac = np.clip(frac, 0.0, 1.0)

    p0 = points[idx]
    p1 = points[idx + 1]
    out = np.empty((num_points, points.shape[1]), dtype=np.float32)
    out[:] = p0 + frac[:, None] * (p1 - p0)
    return out


class QWERTYKeyboard:
    """Canonical QWERTY layout with word-prototype generation."""

    def __init__(self, config: KeyboardConfig = DEFAULT_KEYBOARD_CONFIG):
        self.config = config
        self.key_centers = compute_key_centers(config)

    def get_key_center(self, letter: str) -> Optional[Tuple[float, float]]:
        return self.key_centers.get(letter.lower())

    def _get_key_positions(self, word: str) -> List[Tuple[float, float]]:
        return [self.key_centers[c] for c in word.lower() if c in self.key_centers]

    def get_word_prototype(self, word: str, num_points: int = 128) -> np.ndarray:
        """Straight-line polyline through letter centroids, resampled at
        uniform arc length, with a uniform time column appended → (num_points, 3)."""
        positions = self._get_key_positions(word)
        if len(positions) < 2:
            if len(positions) == 1:
                return _constant_point_prototype(*positions[0], num_points)
            return np.zeros((num_points, 3), dtype=np.float32)

        key_positions = np.array(positions)
        seg_len = np.linalg.norm(np.diff(key_positions, axis=0), axis=1)
        if seg_len.sum() < 1e-6:
            return _constant_point_prototype(*positions[0], num_points)

        trajectory = resample_polyline_by_arclength(key_positions, num_points)
        return np.hstack([trajectory, _uniform_time_column(num_points)]).astype(np.float32)
