"""The flat dataset view the trainer takes, and the corpus's within-word
diversity (the port of ``GestureArrays`` and ``within_word_diversity`` of
the JAX package's ``data/pipeline.py``; the loaders are not ported yet)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


@dataclass
class GestureArrays:
    """Stacked gestures and prototypes with aligned word labels."""

    gestures: np.ndarray            # (N, L, 3) float32
    prototypes: np.ndarray          # (N, L, 3) float32
    words: List[str]
    word_ids: np.ndarray = field(default=None)  # (N,) int32 labels

    def __post_init__(self):
        if self.word_ids is None:
            vocab = {}
            ids = np.empty(len(self.words), dtype=np.int32)
            for i, w in enumerate(self.words):
                ids[i] = vocab.setdefault(w, len(vocab))
            self.word_ids = ids

    def __len__(self) -> int:
        return len(self.gestures)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return {"gesture": self.gestures[idx], "prototype": self.prototypes[idx],
                "word": self.words[idx]}


def within_word_diversity(ds: GestureArrays, max_pairs_per_word: int = 4, seed: int = 0) -> float:
    """Mean L1 distance between two real gestures of the same word: the
    corpus's conditional diversity, the data-driven margin of
    ``losses.diversity_hinge_loss``. The same pairs as the JAX package's for
    the same seed."""
    rng = np.random.default_rng(seed)
    order = np.argsort(ds.word_ids, kind="stable")
    ids = ds.word_ids[order]
    groups = np.split(order, np.flatnonzero(np.diff(ids)) + 1)
    dists: List[float] = []
    for idx in groups:
        n = len(idx)
        if n < 2:
            continue
        for _ in range(min(max_pairs_per_word, n * (n - 1) // 2)):
            i, j = rng.choice(n, size=2, replace=False)
            dists.append(float(np.abs(ds.gestures[idx[i]] - ds.gestures[idx[j]]).mean()))
    if not dists:
        raise ValueError("within_word_diversity: no word has >=2 gestures; pass an "
                         "explicit div_margin instead")
    return float(np.mean(dists))
