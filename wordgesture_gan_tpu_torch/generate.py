"""Bulk gesture synthesis on the GPU: words → prototypes → GAN samples → .npz.

The PyTorch twin of ``generate_gestures.py``: the same flags and the same
output keys (``gestures``, ``words``, ``prototypes``), for all three
generator families (``--generator bilstm|mlp|transformer``). Weights come
from ``--weights`` — a port checkpoint (a train state, or ``torch.save`` of
a ``Generator`` state dict) or a path-keyed JAX generator ``.npz``
(``interop/from_jax.py``) — and default to ``<checkpoint-dir>/generator.pt``,
else the newest checkpoint ``train_cli`` wrote there (``latest.pt``).
``run_meta.json`` in ``--checkpoint-dir`` supplies the defaults of
``--generator`` and ``--time-head``.

Examples:
    # 10 samples for each word in a file (one word per line)
    python -m wordgesture_gan_tpu_torch.generate --words-file words.txt \\
        --samples-per-word 10 --weights checkpoints/generator.npz

    # 100k samples over a comma-separated vocabulary, bf16, with truncation
    python -m wordgesture_gan_tpu_torch.generate --words the,quick,brown --n 100000 \\
        --precision bfloat16 --truncation 0.7 --out gestures.npz
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .configs import ModelConfig
from .keyboard import QWERTYKeyboard
from .train.checkpoint import find_checkpoint, load_generator, load_run_metadata
from .train.gan_loop import generate_gestures


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns {"n", "seconds", "gestures_per_s", "out"}, where
    ``seconds`` covers sampling (the generator on the device and the copy
    back), not reading weights or writing the file."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--words", type=str, default=None,
                        help="comma-separated words to synthesize")
    parser.add_argument("--words-file", type=str, default=None,
                        help="file with one word per line")
    parser.add_argument("--n", type=int, default=0,
                        help="total samples (cycled over the vocabulary); "
                             "0 → samples-per-word for every word")
    parser.add_argument("--samples-per-word", type=int, default=1)
    parser.add_argument("--truncation", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batch", type=int, default=512)
    parser.add_argument("--out", type=str, default="gestures.npz")
    parser.add_argument("--checkpoint-dir", type=str, default="checkpoints",
                        help="directory holding run_meta.json (and, by default, the weights)")
    parser.add_argument("--weights", type=str, default=None,
                        help="generator weights, .pt or JAX .npz (default: "
                             "<checkpoint-dir>/generator.pt, else the newest checkpoint "
                             "there)")
    parser.add_argument("--generator", choices=["bilstm", "mlp", "transformer"],
                        default=None, help="default: the checkpoint's run metadata")
    parser.add_argument("--time-head", choices=["tanh", "monotone"], default=None,
                        help="default: the checkpoint's run metadata")
    parser.add_argument("--precision", choices=["float32", "bfloat16"], default="bfloat16")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain versions")
    args = parser.parse_args(argv)

    words = []
    if args.words:
        words += [w.strip().lower() for w in args.words.split(",") if w.strip()]
    if args.words_file:
        words += [w.strip().lower() for w in Path(args.words_file).read_text().split()
                  if w.strip()]
    if not words:
        parser.error("provide --words or --words-file")

    meta = load_run_metadata(args.checkpoint_dir)
    generator_type = args.generator or meta.get("generator_type", "bilstm")
    weights = args.weights
    if weights is None:
        default = Path(args.checkpoint_dir) / "generator.pt"
        found = default if default.exists() else find_checkpoint(args.checkpoint_dir)
        if found is None:
            parser.error(f"no generator weights: neither {str(default)!r} nor a checkpoint in "
                         f"{args.checkpoint_dir!r} (train first, or pass --weights)")
        weights = str(found)
    elif not Path(weights).exists():
        parser.error(f"no generator weights at {weights!r}")
    config = ModelConfig(generator_type=generator_type,
                         time_head=args.time_head or meta.get("time_head", "tanh"),
                         gen_hidden_dim=meta.get("gen_hidden_dim", 48),
                         compute_dtype=args.precision)
    model = load_generator(weights, config, device=args.device)

    keyboard = QWERTYKeyboard()
    L = model.config.seq_length
    protos_by_word = {w: keyboard.get_word_prototype(w, L) for w in dict.fromkeys(words)}
    if args.n > 0:
        idx = np.arange(args.n) % len(words)
    else:
        idx = np.repeat(np.arange(len(words)), args.samples_per_word)
    out_words = [words[i] for i in idx]
    protos = np.stack([protos_by_word[w] for w in out_words])

    print(f"Generating {len(protos)} gestures over {len(protos_by_word)} words "
          f"({generator_type}, {args.precision}, truncation {args.truncation}, "
          f"{args.device})", flush=True)
    t0 = time.perf_counter()
    gestures = generate_gestures(model, protos, model.config, truncation=args.truncation,
                                 seed=args.seed, batch=args.batch, device=args.device)
    dt = time.perf_counter() - t0
    print(f"Done in {dt:.3f}s ({len(protos) / max(dt, 1e-9):.0f} gestures/s incl. the copy "
          f"back)", flush=True)

    np.savez_compressed(args.out, gestures=gestures, words=np.asarray(out_words),
                        prototypes=protos)
    print(f"Wrote {args.out}: gestures {gestures.shape}, "
          f"range [{gestures.min():.3f}, {gestures.max():.3f}]", flush=True)
    return {"n": len(protos), "seconds": dt, "gestures_per_s": len(protos) / max(dt, 1e-9),
            "out": args.out}


if __name__ == "__main__":
    main()
