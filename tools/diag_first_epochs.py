"""The control recipe's first epochs on the card, and one step's gradients in
bf16 against float32.

    python tools/diag_first_epochs.py [EPOCHS] [RUNS]

Trains ``train_cli --epochs EPOCHS --synthetic --synthetic-users 1338
--lambda-speed 2`` (runs/r5_sweep.sh's recipe cut to EPOCHS, default 12),
seed 42, once per run of RUNS (comma-separated; default bf16_graphed,
fp32_graphed, bf16_eager), each into ``build/diag_<run>/``, and prints one
JSON line of per-epoch losses per run. Then one step from the initial state
and one from the first run's trained state, at learning rate 0 with fresh
Adam moments, in bf16 and in float32 on one batch and one noise draw: per
model, the cosine, the norm ratio and the largest difference of the two
gradients. Needs a CUDA card; runs_torch/diagnostics/first_epochs_card.log
is its output on an H100."""
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from wordgesture_gan_tpu_torch import train_cli  # noqa: E402
from wordgesture_gan_tpu_torch.cli_common import load_split  # noqa: E402
from wordgesture_gan_tpu_torch.configs import ModelConfig, TrainingConfig  # noqa: E402
from wordgesture_gan_tpu_torch.train.checkpoint import restore_checkpoint  # noqa: E402
from wordgesture_gan_tpu_torch.train.gan_step import gan_train_step  # noqa: E402
from wordgesture_gan_tpu_torch.train.state import MODELS, init_gan_state  # noqa: E402
from wordgesture_gan_tpu_torch.utils.tree import tree_leaves  # noqa: E402

EP = int(sys.argv[1]) if len(sys.argv) > 1 else 12
RUNS = sys.argv[2].split(",") if len(sys.argv) > 2 else ["bf16_graphed", "fp32_graphed",
                                                         "bf16_eager"]
base = ["--epochs", str(EP), "--synthetic", "--synthetic-users", "1338", "--lambda-speed", "2",
        "--no-resume"]
spec = {"bf16_graphed": ("bfloat16", True), "fp32_graphed": ("float32", True),
        "bf16_eager": ("bfloat16", False), "fp32_eager": ("float32", False)}
for name in RUNS:
    prec, scan = spec[name]
    t0 = time.perf_counter()
    r = train_cli.main([*base, "--precision", prec, "--checkpoint-dir", f"build/diag_{name}"],
                       scan_epoch=scan)
    print(json.dumps({"run": name, "seconds": time.perf_counter() - t0,
                      **{k: [round(h[k], 4) for h in r.history]
                         for k in ("cycle2_rec", "cycle2_kld", "cycle1_lat", "d1_loss",
                                   "cycle2_wgan")}}), flush=True)

device = torch.device("cuda")
args = train_cli.build_parser().parse_args(base)
mcfg = ModelConfig(time_head="monotone")
tcfg = TrainingConfig(lambda_speed=2.0)
train_ds, _, _ = load_split(args, mcfg, tcfg, verbose=False)
batch = {"gesture": torch.from_numpy(train_ds.gestures[:512]).to(device),
         "prototype": torch.from_numpy(train_ds.prototypes[:512]).to(device)}
rng = np.random.default_rng(5)
shapes = {"z_rand": (5, 512, 32), "eps_enc": (5, 512, 32), "z1": (512, 32),
          "eps_rec": (512, 32), "eps2": (512, 32)}
noise = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
         for k, s in shapes.items()}
for where in ("init", "trained"):
    grads = {}
    for prec in ("bfloat16", "float32"):
        cfg = ModelConfig(time_head="monotone", compute_dtype=prec)
        state = init_gan_state(42, cfg, device)
        if where == "trained":
            restore_checkpoint(state, f"build/diag_{RUNS[0]}")
        for m in MODELS:
            for leaf in tree_leaves(state[m]["opt"]["mu"]) + tree_leaves(state[m]["opt"]["nu"]):
                leaf.zero_()
        _, metrics = gan_train_step(state, batch, 0.0, cfg, tcfg, noise=noise)
        grads[prec] = ({m: torch.cat([x.flatten() for x in tree_leaves(state[m]["opt"]["mu"])])
                        for m in MODELS}, {k: v.item() for k, v in metrics.items()})
    out = {"where": where, "losses_bf16": grads["bfloat16"][1], "losses_fp32": grads["float32"][1]}
    for m in MODELS:
        a, b = grads["bfloat16"][0][m].double(), grads["float32"][0][m].double()
        out[m] = {"cos": (a @ b / (a.norm() * b.norm())).item(),
                  "norm_ratio": (a.norm() / b.norm()).item(),
                  "max_rel": ((a - b).abs().max() / b.abs().max()).item()}
    print(json.dumps(out), flush=True)
