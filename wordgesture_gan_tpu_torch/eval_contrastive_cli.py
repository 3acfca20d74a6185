"""Evaluate the contrastive gesture encoder on the GPU.

The PyTorch twin of ``eval_contrastive.py``: the same flags and defaults,
plus ``--device`` (default ``cuda``). It restores ``contrastive_latest.pt``
(else the newest ``epoch_N.pt``) from ``--checkpoint-dir``, rebuilds the
training run's word split from the same seed, and prints retrieval recall@k
and mAP of the test words; ``--query WORD`` lists the nearest gestures to
that word's first test gesture, ``--centroids`` compares real centroids with
fitted-minimum-jerk ones, ``--tsne`` writes a t-SNE figure (scikit-learn and
matplotlib).

Usage:
    python -m wordgesture_gan_tpu_torch.eval_contrastive_cli [--centroids] [--tsne]
        [--query WORD] [--synthetic] [--device cpu]
"""

from __future__ import annotations

import argparse
import importlib.util
from pathlib import Path
from typing import Optional, Sequence

import torch

from .cli_common import add_data_args, resolve_dataset_zip
from .configs import ContrastiveConfig, ModelConfig, TrainingConfig
from .data.contrastive import create_contrastive_datasets
from .data.pipeline import load_dataset_from_zip
from .eval.contrastive_eval import (create_tsne_plot, evaluate_centroids, evaluate_recall,
                                    similarity_search)
from .keyboard import QWERTYKeyboard
from .train.checkpoint import restore_checkpoint
from .train.contrastive_loop import embed_gestures, init_contrastive_state
from .utils.logging import log, seed_everything


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Evaluate contrastive gesture encoder "
                                                 "(PyTorch/CUDA)")
    parser.add_argument("--centroids", action="store_true",
                        help="evaluate real vs min-jerk centroid quality")
    parser.add_argument("--tsne", action="store_true", help="save a t-SNE plot")
    parser.add_argument("--query", type=str, default=None,
                        help="similarity-search a word's first test gesture")
    parser.add_argument("--checkpoint-dir", type=str, default="checkpoints")
    parser.add_argument("--output-dir", type=str, default="eval_output")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' evaluates on the CPU")
    add_data_args(parser)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns {"epoch", "best_recall", "recall", "query",
    "centroids"}: the checkpoint's counters, ``evaluate_recall``'s result,
    the query's hits and ``evaluate_centroids``' result (None when not
    asked for)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda but no CUDA device is available; pass --device cpu")
    missing = [m for m in ("sklearn", "matplotlib") if importlib.util.find_spec(m) is None]
    if args.tsne and missing:
        parser.error(f"--tsne needs scikit-learn and matplotlib; not installed: "
                     f"{', '.join(missing)}")

    log(f"Device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else device}")
    seed_everything(args.seed)

    config = ContrastiveConfig()
    keyboard = QWERTYKeyboard()
    gestures, _ = load_dataset_from_zip(
        resolve_dataset_zip(args), keyboard, ModelConfig(), TrainingConfig(),
        max_files=args.max_files, time64=args.time64)

    state = restore_checkpoint(init_contrastive_state(args.seed, config, device),
                               args.checkpoint_dir, "contrastive_latest.pt")
    if state is None:
        log(f"ERROR: no contrastive checkpoint in {args.checkpoint_dir}")
        raise SystemExit(1)
    log(f"Loaded contrastive checkpoint (epoch {state['epoch']}, "
        f"best recall@1 {state['best_recall']:.4f})")

    # The training run's split (same seed).
    _train_data, test_data = create_contrastive_datasets(gestures, 0.8, seed=args.seed)

    log("Embedding test set...")
    embeddings = embed_gestures(state, test_data.gestures, config)

    results = evaluate_recall(embeddings, test_data.labels, device=device)
    log("")
    log("=" * 50)
    log("Retrieval metrics (test set)")
    log("=" * 50)
    for key, val in results.items():
        log(f"  {key:<12} {val:.4f}")
    log("=" * 50)

    hits = None
    if args.query:
        q_idx = next((i for i, w in enumerate(test_data.words) if w == args.query), None)
        if q_idx is None:
            log(f"Query word '{args.query}' not in test set")
        else:
            hits = similarity_search(embeddings[q_idx], embeddings, test_data.words)
            log(f"Top matches for '{args.query}':")
            for h in hits:
                log(f"  {h['word']:<16} sim={h['similarity']:.4f}")

    if args.tsne:
        out_dir = Path(args.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        create_tsne_plot(embeddings, test_data.words, str(out_dir / "tsne.png"))

    centroids = None
    if args.centroids:
        centroids = evaluate_centroids(state, gestures, keyboard, config, seed=args.seed)

    log("")
    log("Done.")
    return {"epoch": state["epoch"], "best_recall": state["best_recall"], "recall": results,
            "query": hits, "centroids": centroids}


if __name__ == "__main__":
    main()
