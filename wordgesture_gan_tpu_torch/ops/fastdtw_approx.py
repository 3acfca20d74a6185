"""FastDTW (Salvador & Chan 2007): approximate dynamic time warping on the
host, with the PyPI ``fastdtw`` package's API (the port's own copy of the
JAX package's ``ops/fastdtw_approx.py``; numpy only).

The reference implementation's DTW-Wasserstein metric calls the ``fastdtw``
package. The port's metric is the exact batched DTW of ``ops/dtw.py``; this
module serves to check that exact DTW lower-bounds FastDTW without the
external dependency, and ``install_fastdtw_shim`` lets code that imports
``fastdtw`` run where the package is absent.

Algorithm: recursively coarsen both series by pairwise averaging until they
are shorter than ``radius + 2``, solve exactly at the coarsest level, then at
each finer level run the windowed DTW restricted to the projected coarse
path expanded by ``radius`` cells.
"""

from __future__ import annotations

import numbers
import sys
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


def _resolve_dist(x: np.ndarray, dist) -> Callable:
    """PyPI-fastdtw dist semantics: None → abs / L1, number p → p-norm,
    callable → itself."""
    if dist is None:
        if x.ndim == 1:
            return lambda a, b: abs(a - b)
        return lambda a, b: np.sum(np.abs(a - b))
    if isinstance(dist, numbers.Number):
        p = dist
        return lambda a, b: np.sum(np.abs(a - b) ** p) ** (1.0 / p)
    return dist


def _reduce_by_half(x: np.ndarray) -> np.ndarray:
    """Coarsen by averaging consecutive pairs (odd tail element dropped)."""
    n = len(x) - (len(x) % 2)
    return (x[0:n:2] + x[1:n:2]) / 2.0


def _expand_window(path: Sequence[Tuple[int, int]], len_x: int, len_y: int,
                   radius: int) -> dict:
    """Project a coarse warp path to the next resolution and dilate it by
    ``radius``; returns {row: (col_lo, col_hi)} contiguous column bounds."""
    path_set = set()
    for i, j in path:
        for a in range(-radius, radius + 1):
            for b in range(-radius, radius + 1):
                path_set.add((i + a, j + b))

    # Scale each dilated coarse cell up to its 2x2 block at the finer
    # resolution, folding straight into per-row column bounds.
    bounds: dict = {}
    for i, j in path_set:
        clo, chi = max(0, 2 * j), min(len_y - 1, 2 * j + 1)
        if chi < clo:
            continue
        for a in (0, 1):
            r = 2 * i + a
            if 0 <= r < len_x:
                lo, hi = bounds.get(r, (clo, chi))
                bounds[r] = (min(lo, clo), max(hi, chi))
    # Guard rows uncovered by border clipping (odd-length tails) so every
    # row has a valid interval and the DP stays connected.
    lo_prev = 0
    for i in range(len_x):
        lo, hi = bounds.get(i, (lo_prev, len_y - 1))
        lo = max(lo, 0)
        hi = min(max(hi, lo), len_y - 1)
        bounds[i] = (lo, hi)
        lo_prev = lo
    return bounds


def _dtw_windowed(x: np.ndarray, y: np.ndarray, dist: Callable,
                  bounds: Optional[dict]) -> Tuple[float, List[Tuple[int, int]]]:
    """Classic O(|window|) DP with backtracking. ``bounds`` maps each row to
    an inclusive column interval; None means the full matrix."""
    n, m = len(x), len(y)
    INF = float("inf")
    D = {}
    D[(-1, -1)] = 0.0

    for i in range(n):
        lo, hi = bounds[i] if bounds is not None else (0, m - 1)
        for j in range(lo, hi + 1):
            d = dist(x[i], y[j])
            best = min(
                D.get((i - 1, j), INF),
                D.get((i, j - 1), INF),
                D.get((i - 1, j - 1), INF),
            )
            if best == INF and (i, j) != (0, 0):
                # Disconnected cell (window clipping); unreachable.
                continue
            D[(i, j)] = d + (0.0 if (i, j) == (0, 0) else best)

    path = []
    i, j = n - 1, m - 1
    while (i, j) != (0, 0):
        path.append((i, j))
        steps = [(i - 1, j), (i, j - 1), (i - 1, j - 1)]
        costs = [D.get(s, INF) for s in steps]
        i, j = steps[int(np.argmin(costs))]
    path.append((0, 0))
    path.reverse()
    return D[(n - 1, m - 1)], path


def dtw(x, y, dist=None) -> Tuple[float, List[Tuple[int, int]]]:
    """Exact DTW (full window)."""
    x = np.asanyarray(x, dtype=np.float64)
    y = np.asanyarray(y, dtype=np.float64)
    return _dtw_windowed(x, y, _resolve_dist(x, dist), None)


def fastdtw(x, y, radius: int = 1, dist=None) -> Tuple[float, List[Tuple[int, int]]]:
    """Approximate DTW with O(L) cells per level. Returns (distance, path)."""
    x = np.asanyarray(x, dtype=np.float64)
    y = np.asanyarray(y, dtype=np.float64)
    return _fastdtw(x, y, radius, _resolve_dist(x, dist))


def _fastdtw(x, y, radius, dist):
    min_size = radius + 2
    if len(x) < min_size or len(y) < min_size:
        return _dtw_windowed(x, y, dist, None)
    _, coarse_path = _fastdtw(_reduce_by_half(x), _reduce_by_half(y), radius, dist)
    bounds = _expand_window(coarse_path, len(x), len(y), radius)
    try:
        return _dtw_windowed(x, y, dist, bounds)
    except KeyError:
        # Degenerate window (possible only for pathological tiny inputs):
        # fall back to the exact DP.
        return _dtw_windowed(x, y, dist, None)


def install_fastdtw_shim() -> None:
    """Make ``import fastdtw`` resolve to this module when the PyPI package
    is absent, so the reference evaluation code runs unmodified."""
    try:
        import fastdtw as _real  # noqa: F401  (real package wins if present)
        return
    except ImportError:
        pass
    import types

    mod = types.ModuleType("fastdtw")
    mod.fastdtw = fastdtw
    mod.dtw = dtw
    sys.modules["fastdtw"] = mod
