"""Contrastive dataset: word-grouped gestures and the N-words × K-gestures
batch sampler, as index rows into one flat gesture store (the port of the
JAX package's ``data/contrastive.py``).

Stdlib and numpy only, with the JAX package's arithmetic and random calls,
so both packages draw the same splits and the same index rows from the same
seeds. An epoch of batches is one (n_batches, N*K) int32 array; the trainer
gathers each row from a gesture store that lives on the device.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..keyboard import QWERTYKeyboard


def augment_with_minimum_jerk(
    gestures_by_word: Dict[str, List[np.ndarray]],
    keyboard: QWERTYKeyboard,
    num_augmentations: int = 2,
    offset_std: float = 0.02,
    seq_length: int = 128,
    rng: Optional[np.random.Generator] = None,
) -> Dict[str, List[np.ndarray]]:
    """Add noisy minimum-jerk trajectories as synthetic positives (train
    split only)."""
    out = {}
    for word, gestures in gestures_by_word.items():
        out[word] = list(gestures)
        for _ in range(num_augmentations):
            out[word].append(
                keyboard.get_minimum_jerk_trajectory(
                    word, num_points=seq_length, include_midpoints=True,
                    offset_std=offset_std, rng=rng,
                )
            )
    return out


@dataclass
class ContrastiveArrays:
    """Flat store: gestures (N, L, 3), integer labels, word strings, and the
    per-word index lists the sampler draws from. Words with fewer than ``min_gestures_per_word`` samples are dropped."""

    gestures: np.ndarray
    labels: np.ndarray
    words: List[str]
    unique_words: List[str]
    word_to_indices: Dict[str, List[int]]

    @classmethod
    def from_gestures_by_word(
        cls, gestures_by_word: Dict[str, List[np.ndarray]],
        min_gestures_per_word: int = 2, verbose: bool = True,
    ) -> "ContrastiveArrays":
        g_list, words, word_to_indices = [], [], {}
        idx = 0
        for word, gestures in gestures_by_word.items():
            if len(gestures) < min_gestures_per_word:
                continue
            for g in gestures:
                g_list.append(np.asarray(g, np.float32))
                words.append(word)
                word_to_indices.setdefault(word, []).append(idx)
                idx += 1
        unique = list(word_to_indices.keys())
        label_of = {w: i for i, w in enumerate(unique)}
        labels = np.array([label_of[w] for w in words], dtype=np.int32)
        if verbose:
            print(f"ContrastiveArrays: {len(g_list)} gestures from {len(unique)} words")
        L = g_list[0].shape[0] if g_list else 128
        stacked = np.stack(g_list) if g_list else np.zeros((0, L, 3), np.float32)
        return cls(stacked, labels, words, unique, word_to_indices)

    def __len__(self) -> int:
        return len(self.gestures)


def sample_epoch_batches(
    data: ContrastiveArrays,
    batch_words: int = 32,
    gestures_per_word: int = 2,
    rng: Optional[random.Random] = None,
) -> np.ndarray:
    """One epoch of batch index rows: shuffle eligible words, emit
    ``batch_words`` words × ``gestures_per_word`` sampled gestures per batch,
    drop-last. Returns
    (n_batches, batch_words * gestures_per_word) int32."""
    r = rng or random
    eligible = [w for w in data.unique_words
                if len(data.word_to_indices[w]) >= gestures_per_word]
    if len(eligible) < batch_words:
        raise ValueError(
            f"Not enough words with >= {gestures_per_word} gestures. "
            f"Have {len(eligible)}, need {batch_words}"
        )
    words = list(eligible)
    r.shuffle(words)
    n_batches = len(words) // batch_words
    rows = []
    for b in range(n_batches):
        chunk = words[b * batch_words : (b + 1) * batch_words]
        row: List[int] = []
        for w in chunk:
            row.extend(r.sample(data.word_to_indices[w], gestures_per_word))
        rows.append(row)
    return np.asarray(rows, dtype=np.int32)


class ContrastiveBatchSampler:
    """Iterator-style wrapper over ``sample_epoch_batches``: each iteration
    yields one epoch's batch index rows."""

    def __init__(self, data: ContrastiveArrays, batch_words: int = 32,
                 gestures_per_word: int = 2, seed: int = 0):
        self.data = data
        self.batch_words = batch_words
        self.gestures_per_word = gestures_per_word
        self._rng = random.Random(seed)
        eligible = [w for w in data.unique_words
                    if len(data.word_to_indices[w]) >= gestures_per_word]
        if len(eligible) < batch_words:
            raise ValueError(
                f"Not enough words with >= {gestures_per_word} gestures. "
                f"Have {len(eligible)}, need {batch_words}"
            )
        self.batches_per_epoch = len(eligible) // batch_words

    def __len__(self) -> int:
        return self.batches_per_epoch

    def __iter__(self):
        rows = sample_epoch_batches(self.data, self.batch_words,
                                    self.gestures_per_word, self._rng)
        yield from (row for row in rows)


def word_labels_to_array(word_labels) -> np.ndarray:
    """Word strings → int32 labels (an arbitrary but consistent mapping
    within the call: it follows the set's iteration order)."""
    unique = list(set(word_labels))
    label_of = {w: i for i, w in enumerate(unique)}
    return np.array([label_of[w] for w in word_labels], dtype=np.int32)


def create_contrastive_datasets(
    gestures_by_word: Dict[str, List[np.ndarray]],
    train_ratio: float = 0.8,
    min_gestures_per_word: int = 2,
    seed: int = 42,
    augment_min_jerk: bool = False,
    keyboard: Optional[QWERTYKeyboard] = None,
    min_jerk_augmentations: int = 2,
    min_jerk_noise: float = 0.02,
    verbose: bool = True,
) -> Tuple[ContrastiveArrays, ContrastiveArrays]:
    """Word-level split (a seeded stdlib shuffle; seeds the global stdlib
    and numpy generators as the JAX package does) with optional min-jerk
    augmentation of the train half only."""
    random.seed(seed)
    np.random.seed(seed)

    eligible = [w for w, gs in gestures_by_word.items() if len(gs) >= min_gestures_per_word]
    random.shuffle(eligible)
    split = int(len(eligible) * train_ratio)
    train_words, test_words = set(eligible[:split]), set(eligible[split:])
    if verbose:
        print(f"Train words: {len(train_words)}, Test words: {len(test_words)}")

    train_by_word = {w: g for w, g in gestures_by_word.items() if w in train_words}
    test_by_word = {w: g for w, g in gestures_by_word.items() if w in test_words}

    if augment_min_jerk:
        if keyboard is None:
            raise ValueError("keyboard is required when augment_min_jerk=True")
        if verbose:
            print(f"Augmenting training set with {min_jerk_augmentations} min jerk "
                  f"trajectories per word (noise={min_jerk_noise})")
        seq_length = next(iter(gestures_by_word.values()))[0].shape[0]
        train_by_word = augment_with_minimum_jerk(
            train_by_word, keyboard, min_jerk_augmentations, min_jerk_noise, seq_length,
        )

    return (
        ContrastiveArrays.from_gestures_by_word(train_by_word, min_gestures_per_word, verbose),
        ContrastiveArrays.from_gestures_by_word(test_by_word, min_gestures_per_word, verbose),
    )
