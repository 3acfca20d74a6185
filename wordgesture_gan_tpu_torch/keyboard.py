"""QWERTY keyboard geometry, word prototypes and the minimum-jerk baseline
(the port's copy of the JAX package's ``keyboard.py``).

Host-side numpy with the same arithmetic as the JAX package, so prototypes
agree bit for bit. Coordinate convention: key centers live in a canonical
space with x spanning [-0.9, 0.9] per row (minus row offset) and row-center
y values at ``-1 + (row + 0.5) * 2/3`` for 3 rows.
"""

from __future__ import annotations

from dataclasses import dataclass
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


def key_center_array(config: KeyboardConfig = DEFAULT_KEYBOARD_CONFIG) -> np.ndarray:
    """(26, 2) float64 key centers indexed by letter (a..z): the static-array
    form that batched prototype generation (``ops/resample.py``) indexes."""
    out = np.zeros((26, 2), dtype=np.float64)
    for letter, (x, y) in compute_key_centers(config).items():
        out[LETTER_TO_INDEX[letter]] = (x, y)
    return out


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

    def get_key_centers_for_word(self, word: str) -> np.ndarray:
        positions = self._get_key_positions(word)
        return np.array(positions) if positions else np.zeros((0, 2))

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

    def get_key_indices(self, word: str, num_points: int = 128) -> np.ndarray:
        """Prototype sequence indices where key centers land under arc-length
        sampling."""
        positions = self._get_key_positions(word)
        k = len(positions)
        if k == 0:
            return np.array([], dtype=int)
        if k == 1:
            return np.array([0], dtype=int)

        key_positions = np.array(positions)
        seg_len = np.linalg.norm(np.diff(key_positions, axis=0), axis=1)
        cum_len = np.concatenate([[0], np.cumsum(seg_len)])
        total = cum_len[-1]
        if total < 1e-6:
            return np.array([0], dtype=int)
        idx = np.round(cum_len * (num_points - 1) / total).astype(int)
        return np.clip(idx, 0, num_points - 1)

    def get_minimum_jerk_trajectory(
        self,
        word: str,
        num_points: int = 128,
        include_midpoints: bool = True,
        offset_std: float = 0.0,
        rng: Optional[np.random.Generator] = None,
    ) -> np.ndarray:
        """Quinn & Zhai (2018) minimum-jerk trajectory for a word, with
        optional key-offset and midpoint noise (the contrastive data's
        augmentation)."""
        positions = self._get_key_positions(word)
        if len(positions) < 2:
            if len(positions) == 1:
                return _constant_point_prototype(*positions[0], num_points)
            return np.zeros((num_points, 3), dtype=np.float32)
        return generate_minimum_jerk_trajectory(
            np.array(positions),
            num_points=num_points,
            include_midpoints=include_midpoints,
            offset_std=offset_std,
            rng=rng,
        )


# ---------------------------------------------------------------------------
# Minimum-jerk trajectory generation (Quinn & Zhai 2018)
# ---------------------------------------------------------------------------


def minimum_jerk_quintic(t: np.ndarray) -> np.ndarray:
    """s(t) = 10t^3 - 15t^4 + 6t^5 (reference keyboard.py:283-292)."""
    t3 = t * t * t
    return t3 * (10.0 + t * (-15.0 + 6.0 * t))


def quintic_hermite_segment(
    p0: np.ndarray, p1: np.ndarray,
    v0: np.ndarray, v1: np.ndarray,
    a0: np.ndarray, a1: np.ndarray,
    t: np.ndarray,
) -> np.ndarray:
    """Quintic Hermite interpolation for one segment given endpoint position/
    velocity/acceleration (reference keyboard.py:295-338). Returns
    (len(t), 2)."""
    h00, h01, h10, h11, h20, h21 = quintic_hermite_bases(t)
    return (
        np.outer(h00, p0) + np.outer(h01, p1)
        + np.outer(h10, v0) + np.outer(h11, v1)
        + np.outer(h20, a0) + np.outer(h21, a1)
    )


def quintic_hermite_bases(t: np.ndarray) -> Tuple[np.ndarray, ...]:
    """The six quintic Hermite basis functions h00,h01,h10,h11,h20,h21
    evaluated at t (reference keyboard.py:316-333)."""
    t2 = t * t
    t3 = t2 * t
    t4 = t3 * t
    t5 = t4 * t
    h00 = 1 - 10 * t3 + 15 * t4 - 6 * t5
    h01 = 10 * t3 - 15 * t4 + 6 * t5
    h10 = t - 6 * t3 + 8 * t4 - 3 * t5
    h11 = -4 * t3 + 7 * t4 - 3 * t5
    h20 = 0.5 * t2 - 1.5 * t3 + 1.5 * t4 - 0.5 * t5
    h21 = 0.5 * t3 - t4 + 0.5 * t5
    return h00, h01, h10, h11, h20, h21


def _catmull_rom_velocities(points: np.ndarray) -> np.ndarray:
    """Interior via-point velocities: averaged unit tangents scaled by the
    harmonic mean of adjacent segment lengths; zero at the endpoints
    (reference keyboard.py:459-476). Vectorized over via-points."""
    n = len(points)
    velocities = np.zeros((n, 2))
    if n <= 2:
        return velocities
    d = np.diff(points, axis=0)                       # (n-1, 2)
    lengths = np.linalg.norm(d, axis=1)               # (n-1,)
    before, after = d[:-1], d[1:]                     # per interior point
    len_b, len_a = lengths[:-1], lengths[1:]
    valid = (len_b > 1e-6) & (len_a > 1e-6)
    with np.errstate(divide="ignore", invalid="ignore"):
        tangent = 0.5 * (before / len_b[:, None] + after / len_a[:, None])
        scale = 2.0 * len_b * len_a / (len_b + len_a)
        vel = np.where(valid[:, None], tangent * scale[:, None], 0.0)
    velocities[1:-1] = np.nan_to_num(vel)
    return velocities


def _fine_trajectory_with_tau(
    points: np.ndarray,
    velocities: np.ndarray,
    num_fine: int = 1000,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample the piecewise quintic-Hermite curve at fine uniform tau, fully
    vectorized (reference keyboard.py:341-386 loops per segment; here a single
    gather + batched basis combination). Accelerations are zero at every
    via-point (natural-spline-like), matching keyboard.py:479-480."""
    n = len(points)
    tau = np.linspace(0, 1, num_fine)
    seg_pos = tau * (n - 1)
    seg = np.minimum(seg_pos.astype(int), n - 2)
    local = seg_pos - seg

    h00, h01, h10, h11, _, _ = quintic_hermite_bases(local)
    p0, p1 = points[seg], points[seg + 1]
    v0, v1 = velocities[seg], velocities[seg + 1]
    traj = (
        h00[:, None] * p0 + h01[:, None] * p1 + h10[:, None] * v0 + h11[:, None] * v1
    )
    return traj, tau


def _arclength_resample_with_tau(
    traj_fine: np.ndarray,
    tau_fine: np.ndarray,
    points: np.ndarray,
    num_points: int,
) -> np.ndarray:
    """Resample the fine curve at uniform arc length and recover time as the
    tau value at each arc-length position — i.e. invert s(tau)
    (reference keyboard.py:482-514)."""
    ds = np.linalg.norm(np.diff(traj_fine, axis=0), axis=1)
    s_of_tau = np.concatenate([[0], np.cumsum(ds)])
    total = s_of_tau[-1]
    if total < 1e-6:
        xy = np.tile(points[0], (num_points, 1))
        return np.hstack([xy, _uniform_time_column(num_points)]).astype(np.float32)

    s_target = np.linspace(0, total, num_points)
    tau_out = np.interp(s_target, s_of_tau, tau_fine)
    x = np.interp(s_target, s_of_tau, traj_fine[:, 0])
    y = np.interp(s_target, s_of_tau, traj_fine[:, 1])
    return np.column_stack([x, y, tau_out]).astype(np.float32)


def _two_point_trajectory(points: np.ndarray, num_points: int) -> np.ndarray:
    """Single minimum-jerk segment: position follows s(tau), time is tau
    (reference keyboard.py:449-456)."""
    tau = np.linspace(0, 1, num_points)
    s = minimum_jerk_quintic(tau)
    xy = points[0] + np.outer(s, points[1] - points[0])
    return np.column_stack([xy, tau]).astype(np.float32)


def _render_min_jerk(points: np.ndarray, num_points: int) -> np.ndarray:
    """Shared tail of both min-jerk generators: velocities → fine curve →
    arc-length resample with tau recovery."""
    if len(points) == 2:
        return _two_point_trajectory(points, num_points)
    velocities = _catmull_rom_velocities(points)
    traj_fine, tau_fine = _fine_trajectory_with_tau(points, velocities)
    return _arclength_resample_with_tau(traj_fine, tau_fine, points, num_points)


def generate_minimum_jerk_trajectory(
    via_points: np.ndarray,
    num_points: int = 128,
    include_midpoints: bool = True,
    offset_std: float = 0.0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """C2-continuous minimum-jerk trajectory through via-points with optional
    Gaussian key-offset noise and perpendicular midpoint noise
    (reference keyboard.py:389-514).

    Unlike the reference (which draws from the global ``np.random`` state),
    noise comes from an explicit ``rng`` for reproducibility; the global
    state is used when ``rng`` is None to preserve seeded behavior.
    """
    randn = (rng.normal if rng is not None else np.random.normal)
    n = len(via_points)
    if n < 2:
        xy = np.tile(via_points[0] if n == 1 else [0, 0], (num_points, 1))
        return np.hstack([xy, _uniform_time_column(num_points)]).astype(np.float32)

    points = via_points.astype(float).copy()
    if offset_std > 0 and n > 2:
        points[1:-1] += randn(0, offset_std, (n - 2, 2))

    if include_midpoints and n > 2:
        points = _insert_midpoints(
            points,
            perp_noise=lambda seg_length: randn(0, offset_std * 0.5) if offset_std > 0 else 0.0,
            scale_by_length=False,
        )

    return _render_min_jerk(points, num_points)


def generate_minimum_jerk_trajectory_fitted(
    via_points: np.ndarray,
    num_points: int = 128,
    include_midpoints: bool = True,
    key_offset_mean: Tuple[float, float] = (0.0, 0.0),
    key_offset_std: Tuple[float, float] = (0.02, 0.02),
    midpoint_angle_mean: float = 0.0,
    midpoint_angle_std: float = 0.1,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Minimum-jerk trajectory with learned offset/angle distributions
    (reference keyboard.py:517-630)."""
    randn = (rng.normal if rng is not None else np.random.normal)
    n = len(via_points)
    if n < 2:
        xy = np.tile(via_points[0] if n == 1 else [0, 0], (num_points, 1))
        return np.hstack([xy, _uniform_time_column(num_points)]).astype(np.float32)

    points = via_points.astype(float).copy()
    if n > 2:
        points[1:-1, 0] += randn(key_offset_mean[0], key_offset_std[0], n - 2)
        points[1:-1, 1] += randn(key_offset_mean[1], key_offset_std[1], n - 2)

    if include_midpoints and n > 2:
        points = _insert_midpoints(
            points,
            perp_noise=lambda seg_length: randn(midpoint_angle_mean, midpoint_angle_std),
            scale_by_length=True,
        )

    return _render_min_jerk(points, num_points)


def _insert_midpoints(points: np.ndarray, perp_noise, scale_by_length: bool) -> np.ndarray:
    """Interleave per-segment midpoints (with perpendicular noise) between
    consecutive via-points (reference keyboard.py:432-445 and :561-582).

    ``perp_noise(seg_length)`` draws one noise value per segment; when
    ``scale_by_length`` the deviation is multiplied back by segment length
    (the fitted model's normalized-angle convention).
    """
    n = len(points)
    out = [points[0]]
    for i in range(n - 1):
        a, b = points[i], points[i + 1]
        mid = (a + b) / 2.0
        direction = b - a
        seg_length = np.linalg.norm(direction)
        if seg_length > 1e-6:
            perp = np.array([-direction[1], direction[0]]) / seg_length
            noise = perp_noise(seg_length)
            mid = mid + perp * noise * (seg_length if scale_by_length else 1.0)
        out.append(mid)
        out.append(b)
    return np.array(out)


# ---------------------------------------------------------------------------
# Fitted minimum-jerk model (the learned baseline evaluated against the GAN)
# ---------------------------------------------------------------------------


@dataclass
class MinimumJerkDistributions:
    """Learned key-offset and midpoint-angle statistics
    (reference keyboard.py:14-42)."""

    key_offset_mean_x: float = 0.0
    key_offset_std_x: float = 0.02
    key_offset_mean_y: float = 0.0
    key_offset_std_y: float = 0.02
    midpoint_angle_mean: float = 0.0
    midpoint_angle_std: float = 0.1
    n_key_offset_samples: int = 0
    n_midpoint_samples: int = 0

    def is_fitted(self) -> bool:
        return self.n_key_offset_samples > 0 or self.n_midpoint_samples > 0


class MinimumJerkModel:
    """Minimum-jerk baseline fitted to data (reference keyboard.py:45-280).

    ``fit`` extracts, per (word, gesture):
      * offsets of the closest gesture point to each interior key center,
      * perpendicular deviations of the gesture point closest to each
        segment midpoint, normalized by segment length,
    and stores their means/stds. Extraction is vectorized: for a word all
    per-gesture argmin searches run as one (n_gestures, seq, n_targets)
    distance computation.
    """

    def __init__(self, keyboard: QWERTYKeyboard):
        self.keyboard = keyboard
        self.distributions = MinimumJerkDistributions()

    def fit(self, gestures_by_word: Dict[str, List[np.ndarray]], verbose: bool = True) -> "MinimumJerkModel":
        offsets: List[np.ndarray] = []
        angles: List[np.ndarray] = []

        for word, gestures in gestures_by_word.items():
            key_positions = self.keyboard.get_key_centers_for_word(word)
            if len(key_positions) < 2 or not gestures:
                continue
            stack = np.stack([g[:, :2] for g in gestures])      # (G, L, 2)

            if len(key_positions) > 2:
                offsets.append(self._batched_key_offsets(stack, key_positions))
            ang = self._batched_midpoint_angles(stack, key_positions)
            if ang.size:
                angles.append(ang)

        if offsets:
            all_off = np.concatenate(offsets, axis=0)           # (N, 2)
            d = self.distributions
            d.key_offset_mean_x = float(all_off[:, 0].mean())
            d.key_offset_std_x = float(all_off[:, 0].std())
            d.key_offset_mean_y = float(all_off[:, 1].mean())
            d.key_offset_std_y = float(all_off[:, 1].std())
            d.n_key_offset_samples = len(all_off)
        if angles:
            all_ang = np.concatenate(angles)
            d = self.distributions
            d.midpoint_angle_mean = float(all_ang.mean())
            d.midpoint_angle_std = float(all_ang.std())
            d.n_midpoint_samples = len(all_ang)

        if verbose:
            d = self.distributions
            print(
                f"MinimumJerkModel fitted: key offsets mean=({d.key_offset_mean_x:.4f}, "
                f"{d.key_offset_mean_y:.4f}) std=({d.key_offset_std_x:.4f}, {d.key_offset_std_y:.4f}) "
                f"[n={d.n_key_offset_samples}]; midpoint angles mean={d.midpoint_angle_mean:.4f} "
                f"std={d.midpoint_angle_std:.4f} [n={d.n_midpoint_samples}]"
            )
        return self

    @staticmethod
    def _batched_key_offsets(gestures_xy: np.ndarray, key_positions: np.ndarray) -> np.ndarray:
        """Closest-point offsets to interior keys for a stack of gestures
        (vectorized form of reference keyboard.py:142-178).

        Returns (G * n_interior, 2), ordered gesture-major to match the
        reference's accumulation order.
        """
        interior = key_positions[1:-1]                          # (K, 2)
        # (G, L, K) squared distances
        diff = gestures_xy[:, :, None, :] - interior[None, None, :, :]
        d2 = np.einsum("glkc,glkc->glk", diff, diff)
        closest = np.argmin(d2, axis=1)                          # (G, K)
        picked = np.take_along_axis(gestures_xy, closest[:, :, None], axis=1)
        return (picked - interior[None, :, :]).reshape(-1, 2)

    @staticmethod
    def _batched_midpoint_angles(gestures_xy: np.ndarray, key_positions: np.ndarray) -> np.ndarray:
        """Normalized perpendicular midpoint deviations for a gesture stack
        (vectorized form of reference keyboard.py:180-236)."""
        starts, ends = key_positions[:-1], key_positions[1:]
        direction = ends - starts                               # (S, 2)
        seg_len = np.linalg.norm(direction, axis=1)
        valid = seg_len > 1e-6
        if not valid.any():
            return np.array([])
        mids = (starts + ends)[valid] / 2.0                     # (S', 2)
        perp = np.stack([-direction[valid, 1], direction[valid, 0]], axis=1) / seg_len[valid, None]

        diff = gestures_xy[:, :, None, :] - mids[None, None, :, :]
        d2 = np.einsum("glsc,glsc->gls", diff, diff)
        closest = np.argmin(d2, axis=1)                          # (G, S')
        picked = np.take_along_axis(gestures_xy, closest[:, :, None], axis=1)
        deviation = picked - mids[None, :, :]
        perp_dev = np.einsum("gsc,sc->gs", deviation, perp)
        return (perp_dev / seg_len[valid][None, :]).reshape(-1)

    def generate_trajectory(
        self,
        word: str,
        num_points: int = 128,
        include_midpoints: bool = True,
        rng: Optional[np.random.Generator] = None,
    ) -> np.ndarray:
        """Sample one trajectory from the fitted distributions
        (reference keyboard.py:238-280)."""
        key_positions = self.keyboard.get_key_centers_for_word(word)
        if len(key_positions) < 2:
            if len(key_positions) == 1:
                return _constant_point_prototype(*key_positions[0], num_points)
            return np.zeros((num_points, 3), dtype=np.float32)

        d = self.distributions
        return generate_minimum_jerk_trajectory_fitted(
            via_points=key_positions,
            num_points=num_points,
            include_midpoints=include_midpoints,
            key_offset_mean=(d.key_offset_mean_x, d.key_offset_mean_y),
            key_offset_std=(d.key_offset_std_x, d.key_offset_std_y),
            midpoint_angle_mean=d.midpoint_angle_mean,
            midpoint_angle_std=d.midpoint_angle_std,
            rng=rng,
        )
