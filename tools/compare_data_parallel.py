#!/usr/bin/env python3
"""Train through ``train_cli`` on one rank and on N ranks in one call, and
print each run's time per step and losses.

    python tools/compare_data_parallel.py --ranks 4 [--users 480] [--epochs 2]
        [--device cuda] [-- extra train_cli flags]

Both runs take the flagship recipe (bf16, batch 512, λ_speed 2, λ_div 0.3,
λ_dtc 4) on the synthetic corpus of ``--users`` users, written once into a
temporary directory. The one-rank run trains in this process with no process
group; the N-rank run makes this process rank 0 and starts ranks 1..N-1
(``--data-axis-size N``: NCCL, one card each). Every rank trains on 1/N of
each global batch of 512. Printed as JSON lines: per run the epoch seconds,
ms per step, gestures per second (and per chip) and the last epoch's losses;
then the largest relative difference of the two runs' last losses, the
card's name and power limit (nvidia-smi), and the number of cards.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from wordgesture_gan_tpu_torch import train_cli  # noqa: E402

RECIPE = ["--batch-size", "512", "--precision", "bfloat16", "--lambda-speed", "2.0",
          "--lambda-div", "0.3", "--lambda-dtc", "4.0"]


def run(ranks: int, workdir: Path, args: argparse.Namespace, extra) -> dict:
    argv = ["--epochs", str(args.epochs), "--synthetic", "--synthetic-users", str(args.users),
            "--data", str(workdir / "swipelogs.zip"), "--checkpoint-dir",
            str(workdir / f"ckpt_{ranks}"), "--device", args.device, "--data-axis-size",
            str(ranks), *RECIPE, *extra]
    t0 = time.perf_counter()
    result = train_cli.main(argv)
    wall = time.perf_counter() - t0
    steps = result.gestures_per_epoch // train_cli.build_parser().parse_args(argv).batch_size
    line = {"ranks": ranks, "steps_per_epoch": steps, "epoch_seconds": result.epoch_seconds,
            "ms_per_step": [t / max(steps, 1) * 1e3 for t in result.epoch_seconds],
            "gestures_per_s": result.throughput.per_sec,
            "gestures_per_s_per_chip": result.throughput.per_sec_per_chip,
            "n_chips": result.throughput.n_chips, "wall_seconds": wall,
            "losses_last_epoch": result.history[-1]}
    print(json.dumps(line), flush=True)
    return line


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--users", type=int, default=480)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--device", default="cuda")
    args, extra = parser.parse_known_args()
    extra = [a for a in extra if a != "--"]
    if args.device == "cuda" and torch.cuda.device_count() < args.ranks:
        print(f"needs {args.ranks} CUDA devices, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        one = run(1, Path(tmp), args, extra)
        many = run(args.ranks, Path(tmp), args, extra)
    diff = max(abs(many["losses_last_epoch"][k] - v) / max(1.0, abs(v))
               for k, v in one["losses_last_epoch"].items())
    print(json.dumps({"compare": f"1 vs {args.ranks} ranks", "max_loss_diff_rel": diff}),
          flush=True)
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip(), flush=True)
        print(json.dumps({"cards": torch.cuda.device_count()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
