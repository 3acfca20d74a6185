"""Evaluate WordGesture-GAN and/or the fitted minimum-jerk baseline on the GPU.

The PyTorch twin of ``eval_gan.py``: the same flags and defaults, plus
``--device`` (default ``cuda``) and ``--fid-epochs``. It reads the run
metadata sidecar and the newest checkpoint (``latest.pt``) that
``train_cli`` writes into ``--checkpoint-dir``, for any generator family.
``--variable-length`` scores a masked transformer checkpoint: real,
generated and training traces are resampled onto the common 128-point
arc-length grid on the device (``ops/resample.py``) and run through the
metric suite. ``--large-scale N`` samples N gestures over test prototypes
drawn with replacement and compares them with N real test gestures through
the scale estimators of ``metrics/large_scale.py`` (sliced W2, energy
distance, the Sinkhorn matched cost, chunked k-NN precision/recall, FID).

Usage:
    python -m wordgesture_gan_tpu_torch.eval_cli --model both --n-samples 2000 [--synthetic]
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from .cli_common import add_data_args, load_split, maybe_wandb, resolve_dataset_zip
from .configs import EvaluationConfig, ModelConfig, PathsConfig, TrainingConfig
from .data.variable_length import create_variable_split, load_variable_dataset_from_zip
from .eval.gan_eval import (PAPER_GAN, PAPER_MINJERK, attach_eval_to_wandb,
                            evaluate_gan_and_minjerk, print_comparison_table,
                            print_results_table)
from .keyboard import QWERTYKeyboard
from .metrics.fid import load_or_train_fid_autoencoder
from .metrics.large_scale import evaluate_large_scale
from .metrics.suite import evaluate_all_metrics
from .ops.resample import batched_arclength_resample
from .train.checkpoint import find_checkpoint, load_generator, load_run_metadata
from .train.gan_loop import generate_gestures
from .train.variable_loop import generate_variable_gestures
from .utils.logging import log, seed_everything


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Evaluate WordGesture-GAN (PyTorch/CUDA)")
    parser.add_argument("--model", choices=["gan", "min-jerk", "both"], default="both")
    parser.add_argument("--n-samples", type=int, default=2000)
    parser.add_argument("--truncation", type=float, default=1.0)
    parser.add_argument("--savgol-window", type=int, default=21)
    parser.add_argument("--precision-k", type=int, default=3)
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument("--fast", action="store_true", help="skip DTW Wasserstein")
    parser.add_argument("--fid-features", choices=["positional", "paper"],
                        default="positional",
                        help="FID feature AE decoder: 'positional' (shape-aware "
                             "features; default) or 'paper' (reference parity — "
                             "constant-trace decoder, features near-blind to "
                             "shape/timing)")
    parser.add_argument("--fid-epochs", type=int,
                        default=EvaluationConfig().fid_autoencoder_epochs,
                        help="training epochs of the FID feature autoencoders")
    parser.add_argument("--large-scale", type=int, default=0, metavar="N",
                        help="distribution metrics on N generated gestures "
                             "(sliced W2, energy, Sinkhorn, chunked k-NN, FID)")
    parser.add_argument("--checkpoint-dir", type=str, default="checkpoints")
    parser.add_argument("--generator", choices=["bilstm", "mlp", "transformer"],
                        default=None, help="generator family (default: what the "
                        "checkpoint's run metadata records, else bilstm)")
    parser.add_argument("--time-head", choices=["tanh", "monotone"], default=None,
                        help="generator time-channel head (default: what the "
                             "checkpoint's run metadata records, else tanh)")
    parser.add_argument("--gen-hidden", type=int, default=None,
                        help="BiLSTM hidden dim (default: run metadata, else 48)")
    parser.add_argument("--precision", choices=["float32", "bfloat16"],
                        default="float32",
                        help="generation compute precision (metrics always fp32)")
    parser.add_argument("--variable-length", action="store_true",
                        help="evaluate a variable-length (masked transformer) checkpoint")
    parser.add_argument("--arc-step", type=float, default=0.02,
                        help="arc-length per point for --variable-length")
    parser.add_argument("--save-figures", type=str, default=None,
                        help="directory for comparison/overlay figures")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain versions")
    add_data_args(parser)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns {"n", "gan", "minjerk", "stage_seconds"}: the two
    result dicts (None for a model that was not evaluated) and the host
    seconds of loading, of generation, and of each stage of the metric suite
    per evaluated model. With ``--large-scale`` it returns {"n",
    "large_scale", "stage_seconds"} instead (``_run_large_scale``)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.save_figures and importlib.util.find_spec("matplotlib") is None:
        parser.error("--save-figures needs matplotlib, which is not installed")

    meta = load_run_metadata(args.checkpoint_dir)
    generator_type = args.generator or meta.get("generator_type", "bilstm")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda but no CUDA device is available; pass --device cpu")

    log(f"Device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else device}")
    log(f"Model: {args.model}, Samples: {args.n_samples}, Truncation: {args.truncation}")
    log(f"Savgol window: {args.savgol_window}, Precision k: {args.precision_k}, Fast: {args.fast}")
    log("")
    seed_everything(args.seed)

    # Architecture knobs default to what the training run recorded in its
    # run-metadata sidecar, so `--checkpoint-dir D` alone restores the head
    # and the width.
    model_config = ModelConfig(
        generator_type=generator_type,
        time_head=args.time_head or meta.get("time_head", "tanh"),
        gen_hidden_dim=args.gen_hidden or meta.get("gen_hidden_dim", 48),
        compute_dtype=args.precision)
    training_config = TrainingConfig()
    eval_config = EvaluationConfig(
        n_samples=args.n_samples,
        truncation=args.truncation,
        savgol_window=args.savgol_window,
        precision_recall_k=args.precision_k,
        fid_feature_mode=args.fid_features,
        fid_autoencoder_epochs=args.fid_epochs,
    )
    if args.variable_length:
        ignored = [name for name, hit in (("--wandb", args.wandb),
                                          ("--save-figures", bool(args.save_figures)),
                                          ("--model min-jerk", args.model == "min-jerk"),
                                          ("--large-scale", bool(args.large_scale))) if hit]
        if ignored:
            log(f"NOTE: --variable-length evaluates the masked transformer path only; "
                f"ignoring {', '.join(ignored)}")
        return _run_variable_length(args, model_config, training_config, eval_config, device)
    stage_seconds = {}

    log("[1/5] Loading data...")
    t0 = time.perf_counter()
    train_ds, test_ds, keyboard = load_split(args, model_config, training_config)
    stage_seconds["load"] = time.perf_counter() - t0
    log(f"  Train: {len(train_ds)}, Test: {len(test_ds)}")

    n = min(args.n_samples, len(test_ds))
    real_g = test_ds.gestures[:n]
    words = test_ds.words[:n]

    if args.large_scale:
        return _run_large_scale(args, train_ds, test_ds, model_config, eval_config, device,
                                stage_seconds)

    gan_fake = None
    if args.model in ("gan", "both"):
        log("[2/5] Loading GAN checkpoint...")
        path = find_checkpoint(args.checkpoint_dir)
        if path is None:
            log(f"  ERROR: No checkpoint found in {args.checkpoint_dir}")
            if args.model == "gan":
                raise SystemExit(1)
            log("  Skipping GAN evaluation.")
        else:
            model = load_generator(str(path), model_config, device=device)
            epoch = torch.load(path, map_location="cpu", weights_only=True).get("epoch")
            log(f"  Loaded checkpoint from epoch {epoch}")
            log("[3/5] Generating samples (batched)...")
            t0 = time.perf_counter()
            gan_fake = generate_gestures(model, test_ds.prototypes[:n], model_config,
                                         truncation=args.truncation, seed=args.seed,
                                         device=device)
            stage_seconds["generate"] = time.perf_counter() - t0
            log(f"    Generated {n} samples")

    log("[4/5] Computing metrics...")
    gan_results, minjerk_results = evaluate_gan_and_minjerk(
        real_g, words, train_ds, keyboard,
        gan_fake=gan_fake,
        run_minjerk=args.model in ("min-jerk", "both"),
        model_config=model_config,
        eval_config=eval_config,
        skip_dtw=args.fast,
        cache_dir=args.checkpoint_dir,
        device=device,
        stage_seconds=stage_seconds,
    )
    log("[5/5] Done computing metrics.")
    log("")

    if args.model == "both" and gan_results and minjerk_results:
        print_comparison_table(gan_results, minjerk_results, args.precision_k)
    elif gan_results:
        print_results_table(gan_results, "GAN", PAPER_GAN, args.precision_k)
    elif minjerk_results:
        print_results_table(minjerk_results, "Minimum Jerk", PAPER_MINJERK, args.precision_k)

    if args.save_figures and gan_fake is not None:
        import matplotlib.pyplot as plt

        from .viz import create_comparison_figure, create_overlay_figure

        out = Path(args.save_figures)
        out.mkdir(parents=True, exist_ok=True)
        fig = create_comparison_figure(real_g[:6], gan_fake[:6], words[:6])
        fig.savefig(out / "comparison.png", dpi=100)
        plt.close(fig)
        fig = create_overlay_figure(real_g[:5], gan_fake[:5], words[0] if words else "sample")
        fig.savefig(out / "overlay.png", dpi=100)
        plt.close(fig)
        log(f"Figures saved to {out}")

    if args.wandb:
        # Attach the results to the training run through the run-id sidecar;
        # a standalone run when there is none.
        train_run_id = meta.get("wandb_run_id")
        wb = maybe_wandb(True, project=PathsConfig().wandb_project,
                         name=None if train_run_id else "eval_standalone",
                         id=train_run_id, resume="allow" if train_run_id else None)
        if wb is not None:
            attach_eval_to_wandb(wb, gan_results, minjerk_results,
                                 real_g=real_g, gan_fake=gan_fake, words=words)
            wb.finish()

    log("")
    log("Done.")
    return {"n": n, "gan": gan_results, "minjerk": minjerk_results,
            "stage_seconds": stage_seconds}


def _run_large_scale(args, train_ds, test_ds, model_config: ModelConfig,
                     eval_config: EvaluationConfig, device, stage_seconds: dict) -> dict:
    """``--large-scale N``: sample N gestures over test prototypes drawn with
    replacement, compare them with N real test gestures drawn the same way
    (``np.random.default_rng(seed)``, as the JAX package draws them) through
    ``evaluate_large_scale`` on ``device``, FID on the cached (or newly
    trained) feature autoencoder. Returns {"n", "large_scale",
    "stage_seconds"}."""
    n = args.large_scale
    log(f"[large-scale] Evaluating with N={n}")
    path = find_checkpoint(args.checkpoint_dir)
    if path is None:
        log(f"ERROR: No checkpoint found in {args.checkpoint_dir}")
        raise SystemExit(1)
    model = load_generator(str(path), model_config, device=device)

    rng = np.random.default_rng(args.seed)
    proto_idx = rng.integers(0, len(test_ds), n)
    real_idx = rng.integers(0, len(test_ds), n)

    log(f"[large-scale] Generating {n} gestures (batched)...")
    t0 = time.perf_counter()
    fake = generate_gestures(model, test_ds.prototypes[proto_idx], model_config,
                             truncation=args.truncation, seed=args.seed, device=device)
    dt = time.perf_counter() - t0
    stage_seconds["generate"] = dt
    log(f"[large-scale] Generated {n} gestures in {dt:.1f}s "
        f"({n / dt / 1e3:.1f}k gestures/s → {60 * n / dt / 1e6:.2f}M/min)")

    real = test_ds.gestures[real_idx]
    t0 = time.perf_counter()
    ae_params, _ = load_or_train_fid_autoencoder(train_ds.gestures, model_config, eval_config,
                                                 cache_dir=args.checkpoint_dir, device=device)
    stage_seconds["fid_autoencoder"] = time.perf_counter() - t0

    results = evaluate_large_scale(real, fake, ae_params=ae_params, seed=args.seed, device=device,
                                   stage_seconds=stage_seconds)
    log("")
    log("=" * 60)
    log(f"Large-scale distribution metrics (N={n})")
    log("=" * 60)
    for key, val in results.items():
        log(f"  {key:<20} {val:.5f}")
    log("=" * 60)
    return {"n": n, "large_scale": results, "stage_seconds": stage_seconds}


def _run_variable_length(args, model_config: ModelConfig, training_config: TrainingConfig,
                         eval_config: EvaluationConfig, device) -> dict:
    """Score a ``--variable-length`` checkpoint. Real and generated traces
    live at natural resolution; for comparable metrics each valid segment is
    resampled onto the common 128-point arc-length grid on ``device``, the
    time channel riding the interpolation, and the standard suite runs.
    Returns what ``main`` returns, with ``"minjerk"`` None."""
    model_config = dataclasses.replace(model_config, generator_type="transformer")
    stage_seconds = {}
    log("[1/5] Loading variable-length data...")
    t0 = time.perf_counter()
    keyboard = QWERTYKeyboard()
    by_word, _ = load_variable_dataset_from_zip(
        resolve_dataset_zip(args), keyboard, max_len=model_config.seq_length,
        arc_step=args.arc_step, max_samples_per_word=training_config.max_samples_per_word,
        max_files=args.max_files, seed=args.seed)
    train_ds, test_ds = create_variable_split(by_word, keyboard, max_len=model_config.seq_length,
                                              train_ratio=training_config.train_ratio,
                                              seed=args.seed)
    stage_seconds["load"] = time.perf_counter() - t0

    log("[2/5] Loading variable-length GAN checkpoint...")
    path = find_checkpoint(args.checkpoint_dir)
    if path is None:
        log(f"  ERROR: No checkpoint found in {args.checkpoint_dir}")
        raise SystemExit(1)
    model = load_generator(str(path), model_config, device=device)
    epoch = torch.load(path, map_location="cpu", weights_only=True).get("epoch")
    log(f"  Loaded checkpoint from epoch {epoch}")

    n = min(args.n_samples, len(test_ds))
    log(f"[3/5] Generating {n} masked samples...")
    t0 = time.perf_counter()
    fake = generate_variable_gestures(model, test_ds.prototypes[:n], test_ds.masks()[:n],
                                      model_config, truncation=args.truncation, seed=args.seed,
                                      device=device)
    stage_seconds["generate"] = time.perf_counter() - t0

    log("[4/5] Resampling to the common 128-point grid + computing metrics...")
    t0 = time.perf_counter()

    def grid(traces, lengths):
        return batched_arclength_resample(torch.from_numpy(traces).to(device),
                                          torch.from_numpy(lengths).to(device), 128).cpu().numpy()

    lengths = test_ds.lengths[:n]
    real128 = grid(test_ds.gestures[:n], lengths)
    fake128 = grid(fake, lengths)
    train128 = grid(train_ds.gestures, train_ds.lengths)
    stage_seconds["resample"] = time.perf_counter() - t0
    results = evaluate_all_metrics(real128, fake128, train128,
                                   model_config=dataclasses.replace(model_config, seq_length=128),
                                   eval_config=eval_config, skip_dtw=args.fast,
                                   cache_dir=args.checkpoint_dir, device=device)
    results.pop("_cached_real", None)
    stage_seconds["gan"] = results.pop("_stage_seconds")
    log("[5/5] Done computing metrics.")
    log("")
    log(f"Variable-length traces: test lengths {lengths.min()}-{lengths.max()} "
        f"(mean {lengths.mean():.1f}); metrics on the common 128-point grid:")
    print_results_table(results, "GAN (variable-length)", PAPER_GAN, args.precision_k)
    return {"n": n, "gan": results, "minjerk": None, "stage_seconds": stage_seconds}


if __name__ == "__main__":
    main()
