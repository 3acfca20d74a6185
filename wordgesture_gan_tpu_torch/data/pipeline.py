"""Dataset loading pipeline: zip → parse → normalize → canonical align →
cache → word-level split → flat arrays (the port's copy of the JAX package's
``data/pipeline.py``: the same zip gives the same ``GestureArrays``, and the
preprocessing cache has the same file format)."""

from __future__ import annotations

import hashlib
import pickle
import random
import zipfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..configs import (DEFAULT_MODEL_CONFIG, DEFAULT_TRAINING_CONFIG, ModelConfig,
                       TrainingConfig)
from ..keyboard import QWERTYKeyboard
from .parse import parse_log_file
from .preprocess import (apply_canonical_transform, compute_canonical_transform,
                         infer_key_positions, normalize_gesture)


def _cache_path(zip_path: str, model_config: ModelConfig, training_config: TrainingConfig,
                time64: bool = False) -> Path:
    """Preprocessing cache keyed by (seq_length, max_samples_per_word,
    time64, zip byte size, zip mtime), next to the zip (reference
    data.py:326-331; `.npz.pkl` instead of torch `.pt`). The size+mtime
    terms auto-invalidate the cache when a same-named zip is regenerated —
    the reference keys on the name alone and silently serves stale data,
    and size alone misses a regenerated zip that lands on the same byte
    count."""
    p = Path(zip_path)
    st = p.stat() if p.exists() else None
    size = st.st_size if st else 0
    mtime = st.st_mtime_ns if st else 0
    key = (f"{model_config.seq_length}_{training_config.max_samples_per_word}"
           f"_{time64}_{size}_{mtime}")
    digest = hashlib.md5(key.encode()).hexdigest()[:8]
    return p.parent / f".cache_{p.stem}_{digest}.pkl"


def load_dataset_from_zip(
    zip_path: str,
    keyboard: QWERTYKeyboard,
    model_config: ModelConfig = DEFAULT_MODEL_CONFIG,
    training_config: TrainingConfig = DEFAULT_TRAINING_CONFIG,
    max_files: Optional[int] = None,
    use_cache: bool = True,
    verbose: bool = True,
    time64: bool = False,
) -> Tuple[Dict[str, List[np.ndarray]], Dict[str, np.ndarray]]:
    """Load and preprocess the swipelog dataset.

    Steps: parse every ``.log`` member; normalize + arc-length-resample each
    trace; infer key positions from start/end medians; least-squares fit the
    canonical transform; apply + clip all gestures to ([-1,-1,0],[1,1,1]);
    cap samples per word (seeded ``random.sample``); build one prototype per
    word. The full result is cached on disk.

    Returns:
        (gestures_by_word, prototypes_by_word)
    """
    say = print if verbose else (lambda *a, **k: None)

    if use_cache and max_files is None:
        cpath = _cache_path(zip_path, model_config, training_config, time64)
        if cpath.exists():
            say(f"Loading preprocessed data from cache: {cpath}")
            with open(cpath, "rb") as f:
                cached = pickle.load(f)
            return cached["gestures_by_word"], cached["prototypes_by_word"]

    gestures_by_word: Dict[str, List[np.ndarray]] = {}
    n_files = 0

    # Prefer the native C++ parser for the host-side hot loop; fall back to
    # the pure-Python parser transparently.
    from .native import parse_log_file_native

    def parse(content: str):
        parsed = parse_log_file_native(content)
        return parsed if parsed is not None else parse_log_file(content)

    with zipfile.ZipFile(zip_path, "r") as zf:
        log_files = [m for m in zf.namelist() if m.endswith(".log")]
        if max_files:
            log_files = log_files[:max_files]

        for member in log_files:
            # Per-file guard spans read+parse+normalize. This is deliberately
            # STRICTER than the reference (data.py:379-399), which appends
            # gestures into the global dict as it goes and keeps the ones
            # added before a mid-file failure: here a malformed file — e.g.
            # a keyb_width=0 row whose normalized coordinates come out
            # non-finite — is dropped atomically rather than half-ingested,
            # so a bad file can never poison the dataset with NaNs.
            try:
                content = zf.read(member).decode("utf-8", errors="ignore")
                file_gestures = {}
                for word, raw_list in parse(content).items():
                    normalized = [
                        normalize_gesture(raw, model_config.seq_length, time64=time64)
                        for raw in raw_list
                    ]
                    if any(not np.isfinite(g).all() for g in normalized):
                        raise ValueError(f"non-finite coordinates in {member}")
                    file_gestures[word] = normalized
            except Exception as e:  # corrupt member: skip, keep going
                say(f"Error processing {member}: {e}")
                continue
            for word, normalized in file_gestures.items():
                gestures_by_word.setdefault(word, []).extend(normalized)
            n_files += 1
            if n_files % 100 == 0:
                say(f"Processed {n_files} files...")

    say(f"Processed {n_files} log files; {len(gestures_by_word)} unique words")

    # Canonical alignment: fit once on inferred key positions, apply to all.
    inferred = infer_key_positions(gestures_by_word)
    transform = compute_canonical_transform(inferred, keyboard)
    say(
        f"Canonical transform: scale=({transform['scale_x']:.4f}, {transform['scale_y']:.4f}), "
        f"offset=({transform['offset_x']:.4f}, {transform['offset_y']:.4f})"
    )
    lo, hi = np.array([-1, -1, 0]), np.array([1, 1, 1])
    for word, gestures in gestures_by_word.items():
        gestures_by_word[word] = [
            np.clip(apply_canonical_transform(g, transform), lo, hi) for g in gestures
        ]

    # Balance: cap samples per word (reference uses stdlib random.sample).
    cap = training_config.max_samples_per_word
    for word, gestures in gestures_by_word.items():
        if len(gestures) > cap:
            gestures_by_word[word] = random.sample(gestures, cap)

    prototypes_by_word = {
        word: keyboard.get_word_prototype(word, model_config.seq_length)
        for word in gestures_by_word
    }

    if use_cache and max_files is None:
        cpath = _cache_path(zip_path, model_config, training_config, time64)
        say(f"Saving preprocessed data to cache: {cpath}")
        with open(cpath, "wb") as f:
            pickle.dump(
                {"gestures_by_word": gestures_by_word, "prototypes_by_word": prototypes_by_word},
                f,
                protocol=pickle.HIGHEST_PROTOCOL,
            )

    return gestures_by_word, prototypes_by_word


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


# The name of the reference's map-style dataset, for code written against it.
GestureDataset = GestureArrays


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


def create_train_test_split(
    gestures_by_word: Dict[str, List[np.ndarray]],
    prototypes_by_word: Dict[str, np.ndarray],
    train_ratio: float = 0.8,
    seed: int = 42,
    verbose: bool = True,
) -> Tuple[GestureArrays, GestureArrays]:
    """Word-level 80/20 split with a seeded shuffle — no word overlap between
    train and test. Uses the same stdlib
    ``random.shuffle`` stream so the word partition matches the reference for
    a given seed and word set."""
    random.seed(seed)
    np.random.seed(seed)

    words = list(gestures_by_word.keys())
    random.shuffle(words)
    split = int(len(words) * train_ratio)
    train_words, test_words = set(words[:split]), set(words[split:])
    if verbose:
        print(f"Training words: {len(train_words)}, Test words: {len(test_words)}")

    def build(word_set) -> GestureArrays:
        g_list, p_list, w_list = [], [], []
        # Sorted: str-set iteration order varies with PYTHONHASHSEED, and
        # eval slices [:n] rows — unsorted order would make fixed-seed evals
        # pick a different sample subset per process. (The reference iterates
        # its sets unsorted and inherits exactly that nondeterminism —
        # determinism here is a deliberate improvement; the word PARTITION
        # still matches the reference's seeded shuffle.)
        for word in sorted(word_set):
            proto = prototypes_by_word[word]
            for gesture in gestures_by_word[word]:
                g_list.append(gesture)
                p_list.append(proto)
                w_list.append(word)
        if not g_list:
            L = next(iter(prototypes_by_word.values())).shape[0] if prototypes_by_word else 128
            return GestureArrays(
                np.zeros((0, L, 3), np.float32), np.zeros((0, L, 3), np.float32), []
            )
        return GestureArrays(
            np.stack(g_list).astype(np.float32),
            np.stack(p_list).astype(np.float32),
            w_list,
        )

    train_ds, test_ds = build(train_words), build(test_words)
    if verbose:
        print(f"Training samples: {len(train_ds)}, Test samples: {len(test_ds)}")
    return train_ds, test_ds


class ArrayLoader:
    """Host-side batch iterator over a ``GestureArrays`` split, the
    counterpart of the reference's DataLoader: dicts of numpy ``gesture``,
    ``prototype`` and ``word`` batches. The training loop does not use it (it
    shuffles and batches on the device, ``gan_step.shuffle_batches``); it is
    for host-side consumers and interactive use. For the same seed it yields
    the JAX package's batches in the same order (numpy ``default_rng``)."""

    def __init__(self, dataset: GestureArrays, batch_size: int = 512,
                 shuffle: bool = False, drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        n = len(self.dataset)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for start in range(0, end, self.batch_size):
            idx = order[start:start + self.batch_size]
            yield {"gesture": self.dataset.gestures[idx],
                   "prototype": self.dataset.prototypes[idx],
                   "word": [self.dataset.words[i] for i in idx]}


def create_data_loaders(train_dataset: GestureArrays, test_dataset: GestureArrays,
                        batch_size: int = 512, num_workers: int = 0,
                        seed: int = 0) -> Tuple[ArrayLoader, ArrayLoader]:
    """Train (shuffled, drop-last) and test (in order) batch iterators.
    ``num_workers`` is accepted for the reference's signature; iteration runs
    in this process."""
    return (ArrayLoader(train_dataset, batch_size, shuffle=True, drop_last=True, seed=seed),
            ArrayLoader(test_dataset, batch_size, shuffle=False, drop_last=False))
