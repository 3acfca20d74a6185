"""Paper-style gesture visualization (host-side matplotlib).

The port's copy of the JAX package's ``viz.py``, with the reference's figure
semantics:
keyboard grid underlay, gestures drawn with 32 time-equispaced dots encoding
velocity (clustered dots = slow), comparison grid and overlay figures.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np
from matplotlib.patches import Rectangle

from .configs import DEFAULT_KEYBOARD_CONFIG, KeyboardConfig
from .keyboard import QWERTYKeyboard

COLOR_REAL = "#E67E22"   # user-drawn (orange)
COLOR_FAKE = "#3498DB"   # generated (blue)
COLOR_PROTO = "#2ECC71"  # prototype (green)


def draw_keyboard(ax, config: KeyboardConfig = DEFAULT_KEYBOARD_CONFIG) -> None:
    """Key rectangles + labels; y flipped for display (visualization.py:21-55)."""
    keyboard = QWERTYKeyboard(config)
    key_h = 1.4 / len(config.rows)
    for row in config.rows:
        if len(row) >= 2:
            x0 = keyboard.get_key_center(row[0])[0]
            x1 = keyboard.get_key_center(row[1])[0]
            key_w = (x1 - x0) * 0.95
        else:
            key_w = 0.15
        for key in row:
            x, y = keyboard.get_key_center(key)
            yd = -y
            ax.add_patch(Rectangle((x - key_w / 2, yd - key_h / 2), key_w, key_h,
                                   fill=False, edgecolor="#BDC3C7", linewidth=0.5))
            ax.text(x, yd, key.upper(), ha="center", va="center", fontsize=6, color="#7F8C8D")


def plot_gesture(ax, gesture: np.ndarray, color: str = COLOR_FAKE, alpha: float = 0.8,
                 dot_size: int = 15, line_width: float = 1.0, show_dots: bool = True) -> None:
    """One gesture: path line + dots equispaced in *time* so dot density
    encodes speed (visualization.py:58-91)."""
    x, y = gesture[:, 0], -gesture[:, 1]
    ax.plot(x, y, color=color, alpha=alpha * 0.7, linewidth=line_width, zorder=2)
    if show_dots and gesture.shape[1] >= 3:
        times = gesture[:, 2]
        samples = np.linspace(times.min(), times.max(), 32)
        idx = np.searchsorted(times, samples).clip(0, len(gesture) - 1)
        ax.scatter(x[idx], y[idx], c=color, s=dot_size, alpha=alpha, zorder=3)


def _finish_axes(ax, title: Optional[str] = None) -> None:
    ax.set_xlim(-1.1, 1.1)
    ax.set_ylim(-1.1, 1.1)
    ax.set_aspect("equal")
    ax.axis("off")
    if title:
        ax.set_title(title, fontsize=10)


def plot_gestures_on_keyboard(
    gestures,
    colors: Optional[List[str]] = None,
    title: Optional[str] = None,
    show_keyboard: bool = True,
    figsize: Tuple[float, float] = (4, 3),
    config: KeyboardConfig = DEFAULT_KEYBOARD_CONFIG,
):
    """Multiple gestures over the keyboard grid (visualization.py:94-142)."""
    fig, ax = plt.subplots(figsize=figsize)
    if show_keyboard:
        draw_keyboard(ax, config)
    if isinstance(gestures, np.ndarray) and gestures.ndim == 2:
        gestures = [gestures]
    colors = colors or [COLOR_FAKE] * len(gestures)
    for g, c in zip(gestures, colors):
        plot_gesture(ax, np.asarray(g), color=c)
    _finish_axes(ax, title)
    fig.tight_layout()
    return fig


def create_comparison_figure(
    real_gestures: np.ndarray,
    fake_gestures: np.ndarray,
    words: Sequence[str],
    n_samples: int = 6,
    config: KeyboardConfig = DEFAULT_KEYBOARD_CONFIG,
):
    """2×n grid: user-drawn (top) vs generated (bottom)
    (visualization.py:145-199)."""
    n = min(n_samples, len(real_gestures), len(fake_gestures))
    fig, axes = plt.subplots(2, n, figsize=(n * 2.5, 5))
    axes = axes.reshape(2, n)
    for i in range(n):
        for row, (gs, color) in enumerate(((real_gestures, COLOR_REAL), (fake_gestures, COLOR_FAKE))):
            ax = axes[row, i]
            draw_keyboard(ax, config)
            plot_gesture(ax, np.asarray(gs[i]), color=color)
            _finish_axes(ax, f'"{words[i]}"' if row == 0 and i < len(words) else None)
    axes[0, 0].text(-1.5, 0, "User-drawn", rotation=90, va="center",
                    fontsize=10, fontweight="bold", color=COLOR_REAL)
    axes[1, 0].text(-1.5, 0, "Generated", rotation=90, va="center",
                    fontsize=10, fontweight="bold", color=COLOR_FAKE)
    fig.tight_layout()
    return fig


def create_overlay_figure(
    real_gestures: np.ndarray,
    fake_gestures: np.ndarray,
    word: str,
    n_samples: int = 5,
    config: KeyboardConfig = DEFAULT_KEYBOARD_CONFIG,
):
    """Overlaid real vs generated gestures for one word
    (visualization.py:202-242)."""
    fig, ax = plt.subplots(figsize=(5, 4))
    draw_keyboard(ax, config)
    n = min(n_samples, len(real_gestures), len(fake_gestures))
    for i in range(n):
        plot_gesture(ax, np.asarray(real_gestures[i]), color=COLOR_REAL, alpha=0.6)
    for i in range(n):
        plot_gesture(ax, np.asarray(fake_gestures[i]), color=COLOR_FAKE, alpha=0.6)
    _finish_axes(ax, f'"{word}" - Real (orange) vs Generated (blue)')
    fig.tight_layout()
    return fig
