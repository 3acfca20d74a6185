"""Train the contrastive gesture encoder on the GPU.

The PyTorch twin of ``train_contrastive.py``: the same flags and defaults,
plus ``--device`` (default ``cuda``). It writes ``contrastive_latest.pt``
and, on each new best recall@1, ``epoch_N.pt`` into ``--checkpoint-dir``,
and resumes from them unless ``--no-resume``. ``--data-axis-size`` and the
torchrun environment start data-parallel ranks as ``train_cli`` describes.

Usage:
    python -m wordgesture_gan_tpu_torch.train_contrastive_cli [--epochs N] [--synthetic]
        [--augment-min-jerk] [--device cpu] [--data-axis-size N]
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence, Tuple

import torch

from .cli_common import add_data_args, add_parallel_args, resolve_dataset_zip, run_ranks
from .configs import ContrastiveConfig, ModelConfig, RuntimeConfig, TrainingConfig
from .data.contrastive import create_contrastive_datasets
from .data.pipeline import load_dataset_from_zip
from .keyboard import QWERTYKeyboard
from .parallel.mesh import is_main_process, main_rank_first
from .train.contrastive_loop import train_contrastive
from .utils.logging import log, seed_everything


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train contrastive gesture encoder (PyTorch/CUDA)")
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--no-resume", action="store_true")
    parser.add_argument("--augment-min-jerk", action="store_true",
                        help="add min-jerk trajectories as synthetic positives")
    parser.add_argument("--min-jerk-noise", type=float, default=0.02)
    parser.add_argument("--min-jerk-augmentations", type=int, default=2)
    parser.add_argument("--checkpoint-dir", type=str, default="checkpoints")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' trains on the CPU")
    add_parallel_args(parser)
    add_data_args(parser)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> Tuple[Dict, Dict[str, list]]:
    """Run the CLI; returns ``train_contrastive``'s (state, history) (rank
    0's in a data-parallel run)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda but no CUDA device is available; pass --device cpu")
    return run_ranks("wordgesture_gan_tpu_torch.train_contrastive_cli", args, argv, device,
                     lambda dev: _main(args, dev))


def _main(args: argparse.Namespace, device: torch.device) -> Tuple[Dict, Dict[str, list]]:
    main = is_main_process()
    if main:
        log(f"Device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else device}")
    seed_everything(args.seed)

    config = ContrastiveConfig(num_epochs=args.epochs)
    keyboard = QWERTYKeyboard()
    with main_rank_first(device):   # rank 0 writes the corpus and its cache
        gestures, _protos = load_dataset_from_zip(
            resolve_dataset_zip(args), keyboard, ModelConfig(), TrainingConfig(),
            max_files=args.max_files, time64=args.time64, verbose=main)
    train_data, test_data = create_contrastive_datasets(
        gestures,
        train_ratio=0.8,
        seed=args.seed,
        augment_min_jerk=args.augment_min_jerk,
        keyboard=keyboard,
        min_jerk_augmentations=args.min_jerk_augmentations,
        min_jerk_noise=args.min_jerk_noise,
        verbose=main,
    )

    state, history = train_contrastive(
        train_data,
        test_data,
        config=config,
        runtime_config=RuntimeConfig(data_axis_size=args.data_axis_size),
        num_epochs=args.epochs,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
        resume=not args.no_resume,
        device=device,
    )
    if main:
        if history.get("test_recall@1"):
            log(f"Best recall@1: {max(history['test_recall@1']):.4f}")
        log("Training complete!")
    return state, history


if __name__ == "__main__":
    main()
