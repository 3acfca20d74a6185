"""Variable-length traces (the port's copy of the JAX package's
``data/variable_length.py``).

The fixed-length pipeline forces every trace to ``seq_length`` points. This
module keeps each trace's natural resolution instead: resample at a fixed
arc-length step, cap at ``max_len``, pad to the static shape, and carry a
validity mask. The transformer generator takes the mask as its attention
mask and the masked losses ignore the padding.
"""

from __future__ import annotations

import hashlib
import pickle
import random
import zipfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .parse import RawGesture, parse_log_file
from .preprocess import (_resample_trace, apply_canonical_transform,
                         compute_canonical_transform, infer_key_positions)


def normalize_gesture_variable(raw: RawGesture, max_len: int = 128, arc_step: float = 0.02,
                               min_len: int = 8) -> Tuple[np.ndarray, int]:
    """Normalize one trace at its natural resolution: ``clip(ceil(arc_length
    / arc_step), min_len, max_len)`` points.

    Returns (padded (max_len, 3) float32 array, true length); padding rows
    repeat the last valid point. The time math runs in float64 before
    narrowing, so epoch-millisecond timestamps keep their durations (the
    fixed-length pipeline keeps the reference's float32 collapse)."""
    pts64 = raw.points
    if len(pts64) < 2:
        return np.zeros((max_len, 3), dtype=np.float32), 0

    points = np.empty((len(pts64), 3), dtype=np.float32)
    points[:, 0] = (pts64[:, 0] / raw.keyb_width) * 2.0 - 1.0
    points[:, 1] = (pts64[:, 1] / raw.keyb_height) * 2.0 - 1.0
    t64 = np.asarray(pts64[:, 2], np.float64)
    duration = t64[-1] - t64[0]
    if duration > 0:
        points[:, 2] = (t64 - t64[0]) / duration
    else:
        points[:, 2] = np.linspace(0, 1, len(points))

    arc = float(np.sqrt(np.diff(points[:, :2], axis=0) ** 2 @ np.ones(2)).sum())
    n = int(np.clip(np.ceil(arc / arc_step), min_len, max_len))

    resampled = _resample_trace(points, n) if len(points) != n else points[:n]
    padded = np.empty((max_len, 3), dtype=np.float32)
    padded[:n] = resampled
    padded[n:] = resampled[n - 1]
    return padded, n


def length_mask(lengths: np.ndarray, max_len: int) -> np.ndarray:
    """(N,) true lengths → (N, max_len) float32 {0, 1} validity mask."""
    return (np.arange(max_len)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)


@dataclass
class VariableGestureArrays:
    """Traces padded to a static ``max_len`` with per-sample true lengths;
    each prototype is rendered at its trace's own length, so the transformer
    sees token-aligned conditioning."""

    gestures: np.ndarray            # (N, max_len, 3) float32, padded
    prototypes: np.ndarray          # (N, max_len, 3) float32, padded
    lengths: np.ndarray             # (N,) int32 true lengths
    words: List[str] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.gestures)

    def masks(self) -> np.ndarray:
        return length_mask(self.lengths, self.gestures.shape[1])


def load_variable_dataset_from_zip(
    zip_path: str,
    keyboard,
    max_len: int = 128,
    arc_step: float = 0.02,
    max_samples_per_word: int = 5,
    max_files: Optional[int] = None,
    seed: int = 42,
    verbose: bool = True,
) -> Tuple[Dict[str, List[Tuple[np.ndarray, int]]], Dict[int, np.ndarray]]:
    """The fixed-length loader's parse → canonical-align → cap pipeline, with
    each trace at its natural resolution (``normalize_gesture_variable``).

    Returns (by_word: word → [(padded (max_len, 3), n)], {}); use
    :func:`create_variable_split` to make arrays. The result is cached next
    to the zip in the JAX package's file format (a pickle of ``by_word``,
    named by the variable-length knobs), so either package reads the
    other's cache."""
    say = print if verbose else (lambda *a, **k: None)

    cpath = None
    if max_files is None:
        key = f"vl_{max_len}_{arc_step}_{max_samples_per_word}_{seed}"
        digest = hashlib.md5(key.encode()).hexdigest()[:8]
        p = Path(zip_path)
        cpath = p.parent / f".cache_{p.stem}_{digest}.pkl"
        if cpath.exists():
            say(f"Loading preprocessed variable-length data from cache: {cpath}")
            with open(cpath, "rb") as f:
                return pickle.load(f), {}

    from .native import parse_log_file_native

    def parse(content: str):
        parsed = parse_log_file_native(content)
        return parsed if parsed is not None else parse_log_file(content)

    by_word: Dict[str, List[Tuple[np.ndarray, int]]] = {}
    n_files = 0
    with zipfile.ZipFile(zip_path, "r") as zf:
        log_files = [m for m in zf.namelist() if m.endswith(".log")]
        if max_files:
            log_files = log_files[:max_files]
        for member in log_files:
            try:   # a corrupt member is skipped whole
                content = zf.read(member).decode("utf-8", errors="ignore")
                file_out: Dict[str, List[Tuple[np.ndarray, int]]] = {}
                for word, raw_list in parse(content).items():
                    items = []
                    for raw in raw_list:
                        padded, n = normalize_gesture_variable(raw, max_len, arc_step)
                        if n == 0:
                            continue
                        if not np.isfinite(padded).all():
                            raise ValueError(f"non-finite coordinates in {member}")
                        items.append((padded, n))
                    if items:
                        file_out[word] = items
            except Exception as e:
                say(f"Error processing {member}: {e}")
                continue
            for word, items in file_out.items():
                by_word.setdefault(word, []).extend(items)
            n_files += 1
    say(f"Processed {n_files} log files; {len(by_word)} unique words (variable-length)")

    # Canonical alignment fitted on valid points only.
    flat_for_fit = {w: [g[:n] for g, n in items] for w, items in by_word.items()}
    transform = compute_canonical_transform(infer_key_positions(flat_for_fit), keyboard)
    lo, hi = np.array([-1, -1, 0]), np.array([1, 1, 1])
    for word, items in by_word.items():
        by_word[word] = [
            (np.clip(apply_canonical_transform(g, transform), lo, hi).astype(np.float32), n)
            for g, n in items
        ]

    random.seed(seed)
    for word, items in by_word.items():
        if len(items) > max_samples_per_word:
            by_word[word] = random.sample(items, max_samples_per_word)

    if cpath is not None:
        say(f"Saving preprocessed variable-length data to cache: {cpath}")
        with open(cpath, "wb") as f:
            pickle.dump(by_word, f, protocol=pickle.HIGHEST_PROTOCOL)
    return by_word, {}


def create_variable_split(
    by_word: Dict[str, List[Tuple[np.ndarray, int]]],
    keyboard,
    max_len: int = 128,
    train_ratio: float = 0.8,
    seed: int = 42,
    verbose: bool = True,
) -> Tuple[VariableGestureArrays, VariableGestureArrays]:
    """Word-level split (the fixed-length split's seeded shuffle), with
    per-sample prototypes rendered at each trace's true length and padded by
    repeating the last point. Words are taken in sorted order."""
    random.seed(seed)
    words = list(by_word.keys())
    random.shuffle(words)
    split = int(len(words) * train_ratio)
    train_words, test_words = set(words[:split]), set(words[split:])
    if verbose:
        print(f"Training words: {len(train_words)}, Test words: {len(test_words)}")

    proto_cache: Dict[Tuple[str, int], np.ndarray] = {}

    def proto_for(word: str, n: int) -> np.ndarray:
        key = (word, n)
        if key not in proto_cache:
            p = np.asarray(keyboard.get_word_prototype(word, n), np.float32)
            padded = np.empty((max_len, 3), np.float32)
            padded[:n] = p
            padded[n:] = p[n - 1]
            proto_cache[key] = padded
        return proto_cache[key]

    def build(word_set) -> VariableGestureArrays:
        g_list, p_list, n_list, w_list = [], [], [], []
        for word in sorted(word_set):
            for g, n in by_word[word]:
                g_list.append(g)
                p_list.append(proto_for(word, n))
                n_list.append(n)
                w_list.append(word)
        if not g_list:
            return VariableGestureArrays(np.zeros((0, max_len, 3), np.float32),
                                         np.zeros((0, max_len, 3), np.float32),
                                         np.zeros((0,), np.int32), [])
        return VariableGestureArrays(np.stack(g_list).astype(np.float32),
                                     np.stack(p_list).astype(np.float32),
                                     np.asarray(n_list, np.int32), w_list)

    train_ds, test_ds = build(train_words), build(test_words)
    if verbose:
        print(f"Training samples: {len(train_ds)}, Test samples: {len(test_ds)}; "
              f"lengths {train_ds.lengths.min() if len(train_ds) else 0}-"
              f"{train_ds.lengths.max() if len(train_ds) else 0} "
              f"(mean {train_ds.lengths.mean() if len(train_ds) else 0:.1f})")
    return train_ds, test_ds
