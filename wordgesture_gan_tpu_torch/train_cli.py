"""Train WordGesture-GAN on the GPU.

The PyTorch twin of ``train_gan.py``: the same flags and defaults, plus
``--device`` (default ``cuda``). ``--generator`` picks the family (bilstm,
mlp, transformer); ``--variable-length`` trains the transformer on
natural-resolution traces with validity masks (``train/variable_loop.py``).
It writes the run metadata sidecar that ``eval_cli`` and ``generate`` read,
and checkpoints (``epoch_N.pt``, ``latest.pt``) into ``--checkpoint-dir``.

Data parallelism: under torchrun (``WORLD_SIZE`` > 1) or with
``WGG_DISTRIBUTED=1`` each process joins the process group as one rank
(NCCL on CUDA, gloo on the CPU). Without that environment,
``--data-axis-size N`` > 1 makes this process rank 0 of N local ranks and
starts the other N-1 as copies of the same command (one per card; on the
CPU over gloo); the default -1 takes every visible card, so a one-card host
trains in this process with no process group. ``--profile-dir DIR`` writes
a ``torch.profiler`` trace of the training run into DIR.

Usage:
    python -m wordgesture_gan_tpu_torch.train_cli [--epochs N] [--no-resume]
        [--batch-size B] [--synthetic] [--wandb] [--data-axis-size N]
        [--profile-dir DIR]
"""

from __future__ import annotations

import argparse
import importlib.util
from pathlib import Path
from typing import Optional, Sequence

import torch

from .cli_common import (add_data_args, add_parallel_args, data_axis_size, load_split,
                         maybe_wandb, resolve_dataset_zip, run_ranks)
from .configs import ModelConfig, PathsConfig, RuntimeConfig, TrainingConfig, asdict
from .data.variable_length import create_variable_split, load_variable_dataset_from_zip
from .keyboard import QWERTYKeyboard
from .parallel.distributed import distributed_env_requested
from .parallel.mesh import is_main_process, main_rank_first
from .train.checkpoint import (generator_from_state, latest_epoch, load_run_metadata,
                               save_run_metadata)
from .train.gan_loop import TrainResult, generate_gestures, train_gan
from .train.variable_loop import train_variable_gan
from .utils.logging import log, seed_everything
from .utils.profiling import trace_profile

_LAMBDAS = ("lambda_rec", "lambda_kld", "lambda_dt", "lambda_speed", "lambda_dtc", "lambda_ms",
            "lambda_div", "div_margin")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train WordGesture-GAN (PyTorch/CUDA)")
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--no-resume", action="store_true", help="start fresh")
    parser.add_argument("--batch-size", type=int, default=512)
    parser.add_argument("--checkpoint-dir", type=str, default="checkpoints")
    parser.add_argument("--generator", choices=["bilstm", "mlp", "transformer"],
                        default="bilstm", help="generator family")
    parser.add_argument("--time-head", choices=["tanh", "monotone"], default="monotone",
                        help="time-channel output head: 'monotone' (cumsum of "
                             "softmax increments — learnable clock warp, the "
                             "quality default) or 'tanh' (reference parity)")
    parser.add_argument("--lambda-rec", type=float, default=None,
                        help="override reconstruction-loss weight (default 4.0)")
    parser.add_argument("--lambda-kld", type=float, default=None,
                        help="override KLD weight (default 0.02)")
    parser.add_argument("--lambda-dt", type=float, default=None,
                        help="weight of the cycle-2 time-increment-pattern L1 (default 0 = off)")
    parser.add_argument("--lambda-speed", type=float, default=None,
                        help="weight of the cycle-2 speed-profile correlation loss "
                             "(default 0 = off)")
    parser.add_argument("--lambda-dtc", type=float, default=None,
                        help="weight of the cycle-2 Δt-pattern Pearson loss (default 0 = off)")
    parser.add_argument("--lambda-ms", type=float, default=None,
                        help="MSGAN mode-seeking weight on a second prior draw (default 0 = off)")
    parser.add_argument("--lambda-div", type=float, default=None,
                        help="hinged conditional-diversity weight (default 0 = off)")
    parser.add_argument("--div-margin", type=float, default=None,
                        help="hinge margin for --lambda-div; default measures "
                             "the corpus's mean within-word L1 distance")
    parser.add_argument("--gen-hidden", type=int, default=None,
                        help="override BiLSTM generator hidden dim (default 48)")
    parser.add_argument("--wandb", action="store_true", help="log to wandb")
    parser.add_argument("--precision", choices=["float32", "bfloat16"], default="bfloat16",
                        help="compute precision (params/optimizer stay fp32)")
    parser.add_argument("--variable-length", action="store_true",
                        help="train on natural-resolution traces with validity masks "
                             "(transformer generator)")
    parser.add_argument("--arc-step", type=float, default=0.02,
                        help="arc-length per point for --variable-length")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain versions")
    add_parallel_args(parser)
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a torch.profiler trace of the training run into this dir")
    add_data_args(parser)
    return parser


def main(argv: Optional[Sequence[str]] = None, *, scan_epoch: bool = False) -> TrainResult:
    """Run the CLI; returns ``train_gan``'s result (rank 0's in a
    data-parallel run). ``scan_epoch`` trains with
    ``RuntimeConfig(scan_epoch=True)``: on the card each epoch replays one
    captured CUDA graph of the step, bit-equal to the eager epoch. It is a
    keyword of the library call, not a flag, as the JAX package's
    ``train_gan.py`` has none. The ranks that ``--data-axis-size`` starts
    here are copies of the command line, which cannot carry the keyword, so
    ``scan_epoch`` with local ranks raises ValueError; under torchrun each
    rank's own call passes it."""
    parser = build_parser()
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda but no CUDA device is available; pass --device cpu")
    if (scan_epoch and data_axis_size(args.data_axis_size, device) > 1
            and not distributed_env_requested()):
        raise ValueError("scan_epoch reaches this process only: the ranks --data-axis-size "
                         "starts here would train eagerly; start the ranks with torchrun "
                         "and pass scan_epoch in each")
    return run_ranks("wordgesture_gan_tpu_torch.train_cli", args, argv, device,
                     lambda dev: _main(args, dev, scan_epoch))


def _main(args: argparse.Namespace, device: torch.device, scan_epoch: bool = False) -> TrainResult:
    say = log if is_main_process() else (lambda *_: None)
    say(f"Device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else device}")
    seed_everything(args.seed)

    model_config = ModelConfig(
        generator_type="transformer" if args.variable_length else args.generator,
        compute_dtype=args.precision, time_head=args.time_head,
        **({"gen_hidden_dim": args.gen_hidden} if args.gen_hidden else {}))
    training_config = TrainingConfig(
        num_epochs=args.epochs, batch_size=args.batch_size,
        **{k: getattr(args, k) for k in _LAMBDAS if getattr(args, k) is not None})
    runtime_config = RuntimeConfig(data_axis_size=args.data_axis_size, precision=args.precision,
                                   scan_epoch=scan_epoch)
    if args.variable_length:
        return _train_variable(args, model_config, training_config, runtime_config, device)

    with main_rank_first(device):   # rank 0 writes the corpus and its cache
        train_ds, test_ds, _keyboard = load_split(args, model_config, training_config,
                                                  verbose=is_main_process())
    say(f"Data: {len(train_ds)} train, {len(test_ds)} test")

    # Attach to a prior W&B run only when there is a checkpoint to resume
    # from — otherwise a fresh run would overwrite the old run's history.
    resuming = not args.no_resume and latest_epoch(args.checkpoint_dir) > 0
    prior_run_id = load_run_metadata(args.checkpoint_dir).get("wandb_run_id") if resuming else None
    wb = maybe_wandb(
        args.wandb and is_main_process(),
        project=PathsConfig().wandb_project,
        name=f"{'temporal' if model_config.use_temporal_disc else 'mlp'}_"
             f"{'xy' if not model_config.prototype_has_time else 'xyt'}_"
             f"{training_config.lambda_rec}_{training_config.lambda_kld}",
        config={"model": asdict(model_config), "training": asdict(training_config),
                "num_epochs": args.epochs},
        resume="allow",
        id=prior_run_id,
    )
    if wb is not None:
        save_run_metadata(args.checkpoint_dir, wandb_run_id=wb.run.id)
    # The architecture knobs evaluation and serving must match to restore
    # the checkpoint.
    if is_main_process():
        save_run_metadata(args.checkpoint_dir,
                          generator_type=model_config.generator_type,
                          time_head=model_config.time_head,
                          gen_hidden_dim=model_config.gen_hidden_dim)

    draw_figures = importlib.util.find_spec("matplotlib") is not None
    if not draw_figures:
        say("matplotlib is not installed: no sample figures will be written")

    def epoch_callback(epoch, state, losses):
        if wb is not None:
            wb.log({"epoch": epoch + 1, "learning_rate": losses.get("lr", 0),
                    **{f"loss/{k}": v for k, v in losses.items() if k != "lr"}},
                   step=epoch + 1)
        # Periodic comparison figures.
        if draw_figures and (epoch + 1) % 10 == 0 and len(test_ds) > 0:
            import matplotlib.pyplot as plt

            from .viz import create_comparison_figure

            n_viz = min(6, len(test_ds))
            sampler = generator_from_state(state, model_config, device)
            fake = generate_gestures(sampler, test_ds.prototypes[:n_viz], model_config,
                                     seed=epoch, device=device)
            fig = create_comparison_figure(test_ds.gestures[:n_viz], fake, test_ds.words[:n_viz])
            out = Path(args.checkpoint_dir) / f"samples_epoch_{epoch + 1}.png"
            out.parent.mkdir(parents=True, exist_ok=True)
            fig.savefig(out, dpi=100)
            if wb is not None:
                wb.log({"gestures/training_samples": wb.Image(fig)}, step=epoch + 1)
            plt.close(fig)

    with trace_profile(args.profile_dir):
        result = train_gan(
            train_ds,
            model_config=model_config,
            training_config=training_config,
            runtime_config=runtime_config,
            num_epochs=args.epochs,
            seed=args.seed,
            checkpoint_dir=args.checkpoint_dir,
            resume=not args.no_resume,
            epoch_callback=epoch_callback,
            device=device,
        )

    if wb is not None:
        wb.finish()
    say("Training complete!")
    return result


def _train_variable(args, model_config: ModelConfig, training_config: TrainingConfig,
                    runtime_config: RuntimeConfig, device) -> TrainResult:
    """``--variable-length``: natural-resolution traces with validity masks,
    the masked transformer step."""
    keyboard = QWERTYKeyboard()
    main = is_main_process()
    with main_rank_first(device):   # rank 0 writes the corpus and its cache
        by_word, _ = load_variable_dataset_from_zip(
            resolve_dataset_zip(args), keyboard, max_len=model_config.seq_length,
            arc_step=args.arc_step, max_samples_per_word=training_config.max_samples_per_word,
            max_files=args.max_files, seed=args.seed, verbose=main)
    train_ds, test_ds = create_variable_split(by_word, keyboard, max_len=model_config.seq_length,
                                              train_ratio=training_config.train_ratio,
                                              seed=args.seed)
    if main:
        log(f"Data: {len(train_ds)} train, {len(test_ds)} test (variable-length)")
        save_run_metadata(args.checkpoint_dir,
                          generator_type=model_config.generator_type,
                          time_head=model_config.time_head,
                          gen_hidden_dim=model_config.gen_hidden_dim)
    with trace_profile(args.profile_dir):
        result = train_variable_gan(train_ds, model_config, training_config, runtime_config,
                                    num_epochs=args.epochs, seed=args.seed,
                                    checkpoint_dir=args.checkpoint_dir,
                                    resume=not args.no_resume, device=device)
    if main:
        log("Training complete!")
    return result


if __name__ == "__main__":
    main()
