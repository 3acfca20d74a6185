"""Contrastive encoder evaluation: self-similarity retrieval (recall@k, mAP),
similarity search, the t-SNE figure, and real-vs-minimum-jerk centroid
quality (the port of the JAX package's ``eval/contrastive_eval.py``).

Embeddings come from the encoder on its device, and retrieval's similarity
matrix is a product there; rankings are numpy argsorts on the host, as in
the JAX package, so both rank ties alike.
"""

from __future__ import annotations

import random
from collections import Counter
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..configs import DEFAULT_CONTRASTIVE_CONFIG, ContrastiveConfig
from ..keyboard import MinimumJerkModel, QWERTYKeyboard
from ..train.contrastive_loop import embed_gestures
from ..utils.logging import log


def evaluate_recall(embeddings: np.ndarray, labels: np.ndarray,
                    k_values: Sequence[int] = (1, 5, 10, 20), device="cuda") -> Dict[str, float]:
    """Self-similarity retrieval: recall@k (any same-label neighbor in the
    top k, self excluded) and mAP over the top-max(k) list."""
    lab = np.asarray(labels)
    n = len(embeddings)
    emb = torch.as_tensor(np.asarray(embeddings, np.float32), device=device)
    sim = (emb @ emb.T).cpu().numpy()
    np.fill_diagonal(sim, -np.inf)

    max_k = min(max(k_values), n - 1)
    topk = np.argsort(-sim, axis=1)[:, :max_k]
    correct = (lab[topk] == lab[:, None]).astype(np.float32)          # (n, max_k)

    results = {}
    for k in k_values:
        results[f"recall@{k}"] = float(correct[:, :min(k, max_k)].any(axis=1).mean())

    precision_at_k = np.cumsum(correct, axis=1) / np.arange(1, max_k + 1)
    hits = correct.sum(axis=1)
    ap = np.where(hits > 0, (precision_at_k * correct).sum(axis=1) / np.maximum(hits, 1), 0.0)
    results["mAP"] = float(ap.mean())
    return results


def similarity_search(query_embedding: np.ndarray, database_embeddings: np.ndarray,
                      database_words: List[str], top_k: int = 10) -> List[Dict]:
    """The top-k database gestures nearest a query embedding."""
    sims = database_embeddings @ query_embedding.reshape(-1)
    order = np.argsort(-sims)[:top_k]
    return [{"index": int(i), "word": database_words[int(i)], "similarity": float(sims[i])}
            for i in order]


def create_tsne_plot(embeddings: np.ndarray, words: List[str], output_path: str,
                     n_samples: int = 2000, top_n_words: int = 20) -> None:
    """t-SNE scatter of the embeddings, the top-N most frequent words colored
    (needs scikit-learn and matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from sklearn.manifold import TSNE

    if len(embeddings) > n_samples:
        keep = np.random.choice(len(embeddings), n_samples, replace=False)
        embeddings = embeddings[keep]
        words = [words[i] for i in keep]

    top_words = [w for w, _ in Counter(words).most_common(top_n_words)]
    color_of = {w: i for i, w in enumerate(top_words)}

    log(f"Running t-SNE on {len(embeddings)} samples...")
    coords = TSNE(n_components=2, perplexity=min(30, len(embeddings) - 1),
                  random_state=42).fit_transform(embeddings)

    fig, ax = plt.subplots(figsize=(14, 12))
    other = np.array([w not in color_of for w in words])
    if other.any():
        ax.scatter(coords[other, 0], coords[other, 1], c="lightgray", alpha=0.3, s=5, label="other")
    for word, ci in color_of.items():
        mask = np.array([w == word for w in words])
        if mask.any():
            ax.scatter(coords[mask, 0], coords[mask, 1], c=[plt.cm.tab20(ci)],
                       alpha=0.7, s=20, label=word)
    ax.set_title(f"t-SNE of Gesture Embeddings (n={len(embeddings)}, top {top_n_words} words colored)")
    ax.set_xlabel("t-SNE 1")
    ax.set_ylabel("t-SNE 2")
    ax.legend(bbox_to_anchor=(1.02, 1), loc="upper left", fontsize=8)
    fig.savefig(output_path, dpi=150, bbox_inches="tight")
    log(f"Saved t-SNE plot to {output_path}")
    plt.close(fig)


def _normalize_rows(x: np.ndarray) -> np.ndarray:
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)


def evaluate_centroids(
    state: Dict,
    gestures_by_word: Dict[str, List[np.ndarray]],
    keyboard: QWERTYKeyboard,
    config: ContrastiveConfig = DEFAULT_CONTRASTIVE_CONFIG,
    sample_counts: Sequence[int] = (5, 10, 20, 50),
    seed: int = 42,
    verbose: bool = True,
) -> Dict[str, float]:
    """Real-gesture centroids against fitted-minimum-jerk centroids at
    several sample counts: recall@1 of the test words' gestures against
    each set of centroids, and the gap."""
    say = log if verbose else (lambda *_: None)

    eligible = [w for w, g in gestures_by_word.items() if len(g) >= 2]
    random.seed(seed)
    random.shuffle(eligible)
    split = int(len(eligible) * 0.8)
    train_words = set(eligible[:split])
    test_words = eligible[split:]
    say(f"  Train words: {len(train_words)}, Test words: {len(test_words)}")

    say("Fitting MinimumJerkModel on training data...")
    mj_model = MinimumJerkModel(keyboard).fit(
        {w: gestures_by_word[w] for w in train_words}, verbose=verbose)

    # Test gestures are the queries; real per-word centroids from them.
    queries, query_words = [], []
    for word in test_words:
        for g in gestures_by_word[word]:
            queries.append(np.asarray(g, np.float32))
            query_words.append(word)
    query_emb = embed_gestures(state, np.stack(queries), config)
    say(f"  Embedded {len(query_emb)} gestures")

    word_list = list(test_words)
    word_idx = {w: i for i, w in enumerate(word_list)}
    q_ids = np.array([word_idx[w] for w in query_words])
    real_matrix = np.stack([_normalize_rows(query_emb[q_ids == i].mean(axis=0))
                            for i in range(len(word_list))])

    def recall1(centroid_matrix: np.ndarray) -> float:
        sim = query_emb @ centroid_matrix.T
        return float((np.argmax(sim, axis=1) == q_ids).mean())

    real_r1 = recall1(real_matrix)
    results = {"real_recall@1": real_r1}

    say("")
    say("=" * 60)
    say("Centroid Quality: Real vs Min Jerk")
    say("=" * 60)
    say(f"  Real centroids recall@1: {real_r1:.4f}")
    say("")
    say("  Samples    recall@1    Gap vs Real")

    rng = np.random.default_rng(seed)
    for n_samples in sample_counts:
        # Every word's trajectories embedded in one batched pass, then
        # per-word means.
        trajs = np.stack([mj_model.generate_trajectory(word, num_points=config.seq_length, rng=rng)
                          for word in word_list for _ in range(n_samples)])
        emb = embed_gestures(state, trajs, config).reshape(len(word_list), n_samples, -1)
        mj_r1 = recall1(_normalize_rows(emb.mean(axis=1)))
        say(f"  {n_samples:3d}         {mj_r1:.4f}      {real_r1 - mj_r1:+.4f}")
        results[f"minjerk_{n_samples}_recall@1"] = mj_r1

    say("=" * 60)
    return results
