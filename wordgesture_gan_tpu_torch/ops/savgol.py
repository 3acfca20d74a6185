"""Savitzky-Golay derivative filtering as one precomputed linear map (the
port of the JAX package's ``ops/savgol.py``; ``savgol_matrix`` is its numpy
code, copied).

scipy.signal.savgol_filter(deriv=3) per gesture per axis, including its
default mode='interp' edge handling (which refits the boundary windows), is
linear in the input, so for a fixed sequence length it is one (L, L) matrix,
applied to a whole gesture batch as a single matrix product.
"""

from __future__ import annotations

from functools import lru_cache
from math import factorial

import numpy as np
import torch


def savgol_coeffs(window: int, polyorder: int, deriv: int) -> np.ndarray:
    """Least-squares filter taps: w[i] weights x[t - half + i] in the deriv-th
    derivative of the windowed polynomial fit, evaluated at the center."""
    half = window // 2
    pos = np.arange(window) - half
    design = np.vander(pos, polyorder + 1, increasing=True)     # (window, p+1)
    pinv = np.linalg.pinv(design)                               # (p+1, window)
    return pinv[deriv] * factorial(deriv)


@lru_cache(maxsize=16)
def savgol_matrix(seq_length: int, window: int, polyorder: int, deriv: int) -> np.ndarray:
    """(L, L) matrix M with (M @ x) == scipy savgol_filter(x, mode='interp')."""
    if window % 2 != 1 or window > seq_length:
        raise ValueError(f"window must be odd and at most the sequence length {seq_length}, "
                         f"got {window}")
    half = window // 2
    M = np.zeros((seq_length, seq_length))

    # Interior rows: the stationary filter taps.
    taps = savgol_coeffs(window, polyorder, deriv)
    for t in range(half, seq_length - half):
        M[t, t - half : t + half + 1] = taps

    # Edge rows (mode='interp'): fit one polynomial to the first/last window
    # samples and evaluate its derivative at the edge positions.
    pos = np.arange(window)
    design = np.vander(pos, polyorder + 1, increasing=True)
    pinv = np.linalg.pinv(design)                               # coeffs from samples
    # derivative evaluation row at position t: sum_j c_j * j!/(j-d)! * t^(j-d)
    dmat = np.zeros((seq_length, polyorder + 1))
    for j in range(deriv, polyorder + 1):
        dmat[:, j] = (factorial(j) / factorial(j - deriv)) * (
            np.arange(seq_length, dtype=float) ** (j - deriv)
        )
    head_eval = dmat[:half] @ pinv                              # (half, window)
    M[:half, :window] = head_eval

    tail_pos = np.arange(seq_length - window, seq_length, dtype=float)
    dmat_tail = np.zeros((half, polyorder + 1))
    for j in range(deriv, polyorder + 1):
        dmat_tail[:, j] = (factorial(j) / factorial(j - deriv)) * (
            (tail_pos[-half:] - (seq_length - window)) ** (j - deriv)
        )
    M[-half:, -window:] = dmat_tail @ pinv
    return M


def batched_savgol_jerk(gestures: torch.Tensor, window: int = 21,
                        polyorder: int = 3) -> torch.Tensor:
    """Mean Savitzky-Golay jerk magnitude per gesture for a whole batch.

    gestures: (B, L, >=2); returns (B,). Sequences shorter than the window
    are the caller's concern."""
    L = gestures.shape[1]
    M = torch.as_tensor(savgol_matrix(L, window, polyorder, 3), dtype=torch.float32,
                        device=gestures.device)
    d3 = torch.einsum("tl,bld->btd", M, gestures[:, :, :2])        # (B, L, 2)
    return torch.sqrt(torch.sum(d3 * d3, dim=-1)).mean(dim=1)
