"""The benchmark's inputs, made from the seed on the host: word gestures of
the shapes the program trains on and samples from.

Words are drawn by frequency from the repo's word list
``dataset/wordfreq.txt`` (counts of the corpus's words). A word's prototype is the straight polyline
through its letters' key centers on the canonical QWERTY layout, resampled
at uniform arc length, with a uniform time column (the program's keyboard,
copied here so that the inputs do not change with it). A gesture is its
prototype scaled, shifted and bent by a few smooth sinusoids, with a clock
whose increments vary smoothly. Lengths come from a fixed set (``lengths``),
so every seed makes the same amount of work in another order.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

WORDFREQ = Path(__file__).resolve().parent.parent / "dataset" / "wordfreq.txt"
ROWS = ("qwertyuiop", "asdfghjkl", "zxcvbnm")
ROW_OFFSETS = (0.0, 0.05, 0.15)


def key_centers() -> Dict[str, Tuple[float, float]]:
    """Canonical key centers: x across [-0.9, 0.9] less the row's offset,
    row y at -1 + (row + 0.5)·2/3."""
    centers = {}
    for r, (row, offset) in enumerate(zip(ROWS, ROW_OFFSETS)):
        y = -1.0 + (r + 0.5) * (2.0 / len(ROWS))
        span, start = 1.8 - offset, -0.9 + offset / 2.0
        for k, key in enumerate(row):
            centers[key] = (start + (k + 0.5) * (span / len(row)), y)
    return centers


_CENTERS = key_centers()


def prototype(word: str, n: int) -> np.ndarray:
    """(n, 3) float32: the word's key polyline at n arc-length-uniform points
    and a uniform clock; words of one key are a point held for n steps."""
    pts = np.array([_CENTERS[c] for c in word.lower() if c in _CENTERS], np.float64)
    out = np.zeros((n, 3), np.float32)
    out[:, 2] = np.linspace(0, 1, n)
    if len(pts) == 0:
        return out
    seg = np.sqrt((np.diff(pts, axis=0) ** 2).sum(axis=1))
    if len(pts) < 2 or seg.sum() < 1e-6:
        out[:, :2] = pts[0]
        return out
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    targets = np.linspace(0, cum[-1], n)
    idx = np.clip(np.searchsorted(cum, targets, side="right") - 1, 0, len(pts) - 2)
    span = cum[idx + 1] - cum[idx]
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.clip(np.where(span > 1e-6, (targets - cum[idx]) / span, 0.0), 0.0, 1.0)
    out[:, :2] = pts[idx] + frac[:, None] * (pts[idx + 1] - pts[idx])
    return out


@lru_cache(maxsize=1)
def word_table() -> Tuple[List[str], np.ndarray]:
    """(words with at least two keys, their probabilities ∝ count)."""
    words, counts = [], []
    for line in WORDFREQ.read_text().splitlines():
        count, _, word = line.strip().partition(" ")
        if sum(c in _CENTERS for c in word.lower()) >= 2:
            words.append(word)
            counts.append(float(count))
    p = np.array(counts)
    return words, p / p.sum()


def draw_words(rng: np.random.Generator, n: int, cap: int = 0) -> np.ndarray:
    """n word indices drawn by frequency; with ``cap``, no word more than
    ``cap`` times (draws past the cap are dropped and drawn again)."""
    words, p = word_table()
    if not cap:
        return rng.choice(len(words), size=n, p=p)
    if n > cap * len(words):
        raise ValueError(f"{n} draws exceed {cap} per word over {len(words)} words")
    taken = np.zeros(len(words), np.int64)
    out: List[np.ndarray] = []
    need = n
    while need:
        draw = rng.choice(len(words), size=2 * need + 64, p=p)
        keep = []
        for w in draw:
            if taken[w] < cap:
                taken[w] += 1
                keep.append(w)
                if len(keep) == need:
                    break
        out.append(np.array(keep, np.int64))
        need -= len(keep)
    return np.concatenate(out)


def lengths(n: int, dist: Dict, rng: np.random.Generator) -> np.ndarray:
    """n lengths from a fixed grid of quantiles, in an order drawn from ``rng``.
    ``dist``: {"max": L} (every trace full), or {"min", "max", "full_share"}:
    that share at ``max``, the rest spread evenly over [min, max)."""
    top = int(dist["max"])
    share = float(dist.get("full_share", 1.0))
    q = (np.arange(n) + 0.5) / n
    short = q < 1.0 - share
    out = np.full(n, top, np.int64)
    lo = int(dist.get("min", top))
    out[short] = lo + np.floor(q[short] / (1.0 - share) * (top - lo)).astype(np.int64)
    return rng.permutation(out)


def prototypes(word_ids: np.ndarray, lens: np.ndarray, L: int) -> np.ndarray:
    """(n, L, 3) prototypes, each at its own length and zero-padded to L."""
    words, _ = word_table()
    out = np.zeros((len(word_ids), L, 3), np.float32)
    full: Dict[int, np.ndarray] = {}
    for i, (w, n) in enumerate(zip(word_ids, lens)):
        if n == L:
            if w not in full:
                full[w] = prototype(words[w], L)
            out[i] = full[w]
        else:
            out[i, :n] = prototype(words[w], int(n))
    return out


def gestures(protos: np.ndarray, lens: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """(n, L, 3) gestures drawn around their prototypes: each scaled by
    1 + N(0, 0.05²), shifted by N(0, 0.02²), bent by three sinusoids of
    amplitude N(0, (0.03/k)²), with a clock whose log-increments follow two
    sinusoids of amplitude 0.3; zero past each length."""
    n, L, _ = protos.shape
    pos = np.arange(L)[None, :]
    s = np.minimum(pos / np.maximum(lens[:, None] - 1, 1), 1.0)             # (n, L)
    valid = pos < lens[:, None]
    k = np.arange(1, 4)[None, None, :]
    bend = np.zeros((n, L, 2))
    for c in range(2):
        amp = rng.normal(0, 0.03, (n, 1, 3)) / k
        phase = rng.uniform(0, 2 * np.pi, (n, 1, 3))
        bend[..., c] = (amp * np.sin(np.pi * k * s[..., None] + phase)).sum(-1)
    xy = (protos[..., :2] * (1 + rng.normal(0, 0.05, (n, 1, 1)))
          + rng.normal(0, 0.02, (n, 1, 2)) + bend)
    amp = rng.uniform(0, 0.3, (n, 1, 2))
    phase = rng.uniform(0, 2 * np.pi, (n, 1, 2))
    inc = np.exp((amp * np.sin(np.pi * np.arange(1, 3)[None, None, :] * s[..., None]
                               + phase)).sum(-1)) * valid
    inc[:, 0] = 0.0
    t = np.cumsum(inc, axis=1)
    t = t / np.maximum(t.max(axis=1, keepdims=True), 1e-9)
    out = np.concatenate([xy, t[..., None]], axis=-1) * valid[..., None]
    return out.astype(np.float32)


def training_set(n: int, L: int, length_dist: Dict, cap: int, seed: int):
    """(gestures, prototypes, lengths, words) of a training set of n
    gestures, at most ``cap`` a word."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 1])
    ids = draw_words(rng, n, cap)
    lens = lengths(n, length_dist, rng)
    protos = prototypes(ids, lens, L)
    words, _ = word_table()
    return gestures(protos, lens, rng), protos, lens, [words[i] for i in ids]
