"""JAX's threefry2x32 random streams, in plain numpy and torch: the keys
(``PRNGKey``, ``split``, ``fold_in``), the bits, uniforms and normals drawn
from a key, and the permutation. The program under test draws the same
streams with its own code; this copy lets the reference work out every
draw again from the seed.

A key is a numpy uint32 array of shape (2,). Uniforms are bit for bit the
program's. Normals are sqrt(2)·erfinv(u) with erfinv taken in double, where
the program reproduces XLA's float32 polynomial: the two differ by a few
float32 ulp, far below what any comparison here resolves.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash of counters (x0, x1) under key (k0, k1): numpy
    uint64 arrays (or ints) holding 32-bit words; 20 rounds."""
    k0, k1, x0, x1 = (np.asarray(v, np.uint64) for v in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint64(_PARITY))
    m = np.uint64(MASK)
    x0 = (x0 + ks[0]) & m
    x1 = (x1 + ks[1]) & m
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & m
            x1 = ((x1 << np.uint64(r)) & m) | (x1 >> np.uint64(32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & m
        x1 = (x1 + ks[(i + 2) % 3] + np.uint64(i + 1)) & m
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    return np.array([0, int(seed) & MASK], np.uint64)


def split(key: np.ndarray, n: int = 2) -> np.ndarray:
    """(n, 2) keys: the hash of counters (0, i)."""
    y0, y1 = threefry2x32(key[0], key[1], np.zeros(n, np.uint64), np.arange(n, dtype=np.uint64))
    return np.stack([y0, y1], axis=1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    y0, y1 = threefry2x32(key[0], key[1], 0, int(data) & MASK)
    return np.array([y0, y1], np.uint64)


def bits(key: np.ndarray, n: int, start: int = 0) -> np.ndarray:
    """The 32-bit words at flat indices start .. start+n-1 of a draw from
    ``key`` (uint64 holding uint32)."""
    j = np.arange(start, start + n, dtype=np.uint64)
    y0, y1 = threefry2x32(key[0], key[1], np.zeros_like(j), j)
    return y0 ^ y1


def _unit(b: np.ndarray) -> torch.Tensor:
    f = ((b >> np.uint64(9)) | np.uint64(0x3F800000)).astype(np.uint32).view(np.float32)
    return torch.from_numpy(f.copy()) - 1.0


def _scale(unit: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    lo32, hi32 = np.float32(lo), np.float32(hi)
    span = float(np.float32(hi32 - lo32))
    out = (unit.double() * span + float(lo32)).float()
    return torch.clamp(out, min=float(lo32))


def uniform(key: np.ndarray, shape, lo: float, hi: float) -> torch.Tensor:
    n = math.prod(shape)
    return _scale(_unit(bits(key, n)), lo, hi).reshape(shape)


def normal(key: np.ndarray, shape, start: int = 0) -> torch.Tensor:
    """Normals of a draw of ``shape`` from ``key``; with ``start`` the
    numbers at flat indices start .. start+prod(shape)-1 of a larger draw."""
    n = math.prod(shape)
    u = _scale(_unit(bits(key, n, start)), NORMAL_LO, 1.0)
    return (math.sqrt(2.0) * torch.special.erfinv(u.double())).float().reshape(shape)


def permutation(key: np.ndarray, n: int) -> np.ndarray:
    """arange(n) sorted stably by fresh 32-bit keys, round after round."""
    x = np.arange(n)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(MASK)))
    for _ in range(rounds):
        key, sub = split(key)
        order = np.argsort(bits(sub, n), kind="stable")
        x = x[order]
    return x
