"""Shared CLI plumbing: dataset resolution (real zip or synthetic stand-in),
split construction, wandb gating (the port's copy of the JAX package's
``cli_common.py``), and the ranks of a data-parallel run."""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .configs import ModelConfig, TrainingConfig
from .data.pipeline import GestureArrays, create_train_test_split, load_dataset_from_zip
from .data.synthetic import write_synthetic_swipelogs_zip
from .keyboard import QWERTYKeyboard
from .parallel.distributed import (distributed_env_requested, local_ranks, maybe_init_distributed,
                                   rank_device, shutdown_distributed)
from .utils.logging import log


def add_data_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--data", type=str, default="dataset/swipelogs.zip",
                        help="path to swipelogs.zip")
    parser.add_argument("--synthetic", action="store_true",
                        help="generate (and cache) a synthetic swipelogs zip when the real dataset is absent")
    parser.add_argument("--synthetic-users", type=int, default=200,
                        help="number of synthetic users when --synthetic")
    parser.add_argument("--max-files", type=int, default=None,
                        help="cap processed log files (debugging)")
    parser.add_argument("--time64", action="store_true",
                        help="do gesture-duration math in float64 (fixes the "
                             "reference's float32 epoch-timestamp collapse, "
                             "preprocess.py:40-47; default keeps bit parity)")
    parser.add_argument("--seed", type=int, default=42)


def resolve_dataset_zip(args: argparse.Namespace) -> str:
    """Return a usable zip path. Synthetic data is only ever substituted when
    the user explicitly asked for it (--synthetic); a missing real dataset
    fails loudly rather than silently training on fabricated data."""
    path = Path(args.data)
    if not args.synthetic:
        if path.exists():
            return str(path)
        raise FileNotFoundError(
            f"dataset zip not found: {path}. Pass --synthetic to generate a "
            f"synthetic stand-in, or point --data at the real swipelogs.zip."
        )

    # The stand-in always lives under an explicit synthetic_ name — never at
    # the real dataset's path, where a later run WITHOUT --synthetic would
    # silently mistake fabricated data for the real corpus.
    syn_path = path.parent / f"synthetic_swipelogs_{args.synthetic_users}.zip"
    if not syn_path.exists():
        log(f"Generating synthetic swipelogs ({args.synthetic_users} users) at {syn_path}")
        # The repo's own word-frequency table (dataset/README.md); without
        # it the writer uses its built-in word list.
        wordfreq = Path(__file__).resolve().parent.parent / "dataset" / "wordfreq.txt"
        write_synthetic_swipelogs_zip(
            str(syn_path), n_users=args.synthetic_users, seed=7,
            wordfreq_path=str(wordfreq) if wordfreq.exists() else None,
            # Match the real dataset's vocabulary scale (~11k words,
            # Zipf-weighted) so the capped gesture count is realistic.
            max_vocab=12000,
        )
    else:
        log(f"Using cached synthetic swipelogs at {syn_path}")
    return str(syn_path)


def load_split(
    args: argparse.Namespace,
    model_config: ModelConfig,
    training_config: TrainingConfig,
    verbose: bool = True,
) -> Tuple[GestureArrays, GestureArrays, QWERTYKeyboard]:
    keyboard = QWERTYKeyboard()
    zip_path = resolve_dataset_zip(args)
    gestures, protos = load_dataset_from_zip(
        zip_path, keyboard, model_config, training_config,
        max_files=args.max_files, verbose=verbose,
        time64=getattr(args, "time64", False),
    )
    train_ds, test_ds = create_train_test_split(
        gestures, protos, training_config.train_ratio, seed=args.seed, verbose=verbose,
    )
    return train_ds, test_ds, keyboard


def maybe_wandb(enabled: bool, **init_kwargs):
    """Lazy wandb init; returns the module or None (offline-safe)."""
    if not enabled:
        return None
    try:
        import wandb

        os.environ.setdefault("WANDB_MODE", "offline")
        wandb.init(**init_kwargs)
        return wandb
    except Exception as e:  # wandb missing or unreachable: degrade to logs
        log(f"wandb unavailable ({e}); continuing without it")
        return None


def add_parallel_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--data-axis-size", type=int, default=-1,
                        help="data-parallel ranks, one process each (-1 = every visible card, "
                             "1 on the CPU); without torchrun's environment, N > 1 starts "
                             "ranks 1..N-1 as copies of this command")


def data_axis_size(requested: int, device: torch.device) -> int:
    """Ranks for ``--data-axis-size``: -1 means every visible card (1 on the CPU)."""
    if requested != -1:
        return requested
    return torch.cuda.device_count() if device.type == "cuda" else 1


def run_ranks(module: str, args: argparse.Namespace, argv: Optional[Sequence[str]],
              device: torch.device, body: Callable):
    """``body(device)`` in this process: as one rank of the process group
    the environment asks for (torchrun, ``WGG_DISTRIBUTED=1``), as rank 0 of
    ``--data-axis-size`` local ranks started here (``python -m module
    *argv``), or alone. A group this call joined is left at the end."""
    world = data_axis_size(args.data_axis_size, device)
    if world > 1 and not distributed_env_requested():
        with local_ranks(world, module, list(sys.argv[1:] if argv is None else argv)):
            return run_ranks(module, args, argv, device, body)
    joined_before = dist.is_initialized()
    owner = maybe_init_distributed(device) and not joined_before
    try:
        return body(rank_device(device) if dist.is_initialized() else device)
    finally:
        if owner:
            shutdown_distributed()
