"""Train the port and the JAX package side by side from one initial state and
report, step by step, how far apart they drift.

Both packages start from the JAX package's initial state (the port's copy
through ``interop.from_jax.train_state_from_jax``) and train on the same
batches, in float32 or bfloat16 (``--precision``; parameters and Adam stay
float32 in both), with the draws the JAX step takes from its own key (the
port is handed them as ``noise``). A third run, the control, is the JAX
package against itself: its initial state with every parameter moved by one
float32 rounding step (relative 2**-24, random sign). Two runs of a GAN part
after enough steps whatever the code does; a fault in the port shows as the
port parting from JAX sooner than the control does.

Each step writes one JSON line: the losses of the three runs and, for G, E,
D1 and D2, the relative parameter distance ||theta - theta_jax|| /
||theta_jax|| of the port and of the control. The last line gives, for each
run, the first step at which G's distance passes 1e-3 and 1e-2.

Run from the repository root, on the CPU:

    JAX_PLATFORMS=cpu python tests/jax_trajectory.py --recipe flag \
        --steps 80 --out runs_torch/diagnostics/trajectory_flag.jsonl

``--recipe`` picks the auxiliary terms: ``flag`` (lambda_speed 2,
lambda_div 0.3, lambda_dtc 4, ``runs/r5_sweep4.sh``), ``div03`` (lambda_speed
2, lambda_div 0.3, ``runs/r5_sweep3.sh``) or ``none`` (no auxiliary term), on
the BiLSTM generator and the fixed-length step; or ``varlen2``
(lambda_speed 2, ``runs/r5_sweep5.sh``): the transformer generator, the
masked step and variable-length batches. The data are the synthetic corpus
the sweeps train on (``--synthetic-users 1338``), written to ``--zip`` when
it is missing.
``tests/test_torch_recipe_trajectory.py`` runs this at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from wordgesture_gan_tpu.configs import ModelConfig as JaxModelConfig  # noqa: E402
from wordgesture_gan_tpu.configs import TrainingConfig as JaxTrainingConfig  # noqa: E402
from wordgesture_gan_tpu.train import gan_train_step as jax_gan_train_step  # noqa: E402
from wordgesture_gan_tpu.train import init_gan_state as jax_init_gan_state  # noqa: E402
from wordgesture_gan_tpu.train.masked_step import (  # noqa: E402
    gan_train_step_masked as jax_masked_step)
from wordgesture_gan_tpu_torch.configs import ModelConfig, TrainingConfig  # noqa: E402
from wordgesture_gan_tpu_torch.interop.from_jax import (flatten_tree,  # noqa: E402
                                                        train_state_from_jax)
from wordgesture_gan_tpu_torch.train.gan_step import gan_train_step  # noqa: E402
from wordgesture_gan_tpu_torch.train.masked_step import gan_train_step_masked  # noqa: E402

MODELS = ("g", "e", "d1", "d2")
# The flagship's measured diversity margin (runs/r5_train_flag.log).
MARGIN = 0.066
RECIPES = {
    "flag": dict(lambda_speed=2.0, lambda_div=0.3, lambda_dtc=4.0, div_margin=MARGIN),
    "div03": dict(lambda_speed=2.0, lambda_div=0.3, div_margin=MARGIN),
    "none": dict(),
    "varlen2": dict(lambda_speed=2.0),
}
# The recipes that train the transformer on variable-length batches through
# the masked step.
MASKED = {"varlen2": dict(generator_type="transformer")}
LOSSES = ("d1_loss", "d2_loss", "cycle1_total", "cycle1_lat", "cycle2_total", "cycle2_rec",
          "cycle2_kld", "cycle2_wgan")
# The masked step reports no latent, KLD or WGAN term of its own.
MASKED_LOSSES = ("d1_loss", "d2_loss", "cycle1_total", "cycle2_total", "cycle2_rec")
THRESHOLDS = (1e-3, 1e-2)


def jax_step_draws(key, batch: int, n_critic: int, latent: int, diversity: bool) -> dict:
    """The draws the JAX step makes from its state key, by repeating its
    splits: split(rng, 3) per critic iteration, then split(rng, 4), then
    (with a diversity term) split(rng, 2) for the second prior draw. Returns
    them under ``gan_train_step``'s noise names as float32 tensors."""
    zkeys, ekeys = [], []
    for _ in range(n_critic):
        key, kz, ke = jax.random.split(key, 3)
        zkeys.append(kz)
        ekeys.append(ke)
    key, kz1, ke1, ke2 = jax.random.split(key, 4)
    keys = {"z1": kz1, "eps_rec": ke1, "eps2": ke2}
    if diversity:
        _, keys["z_ms"] = jax.random.split(key)

    def normal(k):
        return torch.from_numpy(np.array(jax.random.normal(k, (batch, latent)), np.float32))

    draws = {name: normal(k) for name, k in keys.items()}
    if n_critic:
        draws["z_rand"] = torch.stack([normal(k) for k in zkeys])
        draws["eps_enc"] = torch.stack([normal(k) for k in ekeys])
    return draws


def nudge(state, seed: int, step: float = 2.0 ** -24):
    """``state`` with every parameter moved by ``step`` relative, random
    sign (by default one float32 rounding step); optimizer moments, u
    vectors and the key are kept."""
    rng = np.random.default_rng(seed)
    out = dict(state)
    for m in MODELS:
        params = jax.tree.map(
            lambda x: (np.asarray(x) * (1 + np.float32(step)
                                        * rng.choice([-1, 1], np.shape(x)))).astype(np.float32),
            state[m]["params"])
        out[m] = dict(state[m], params=params)
    return out


def distance(params, ref) -> float:
    """||params - ref|| / ||ref|| over every leaf of a parameter tree."""
    a, b = flatten_tree(params), flatten_tree(ref)
    num = sum(float(np.sum((np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64)) ** 2))
              for k in b)
    den = sum(float(np.sum(np.asarray(b[k], np.float64) ** 2)) for k in b)
    return (num / den) ** 0.5


def port_params(state, m):
    """The port's parameter tree of model ``m`` as numpy arrays."""
    def leaf(x):
        return x.detach().numpy()
    tree = state[m]["params"]
    walk = (lambda t: {k: walk(v) for k, v in t.items()} if isinstance(t, dict)
            else [walk(v) for v in t] if isinstance(t, (list, tuple)) else leaf(t))
    return walk(tree)


def trajectory(batches, recipe: str, hidden: int = 48, seed: int = 0, lr: float = 2e-4,
               precision: str = "float32", model: dict = None,
               control_step: float = 2.0 ** -24):
    """Yield one record per batch of ``batches`` ((gesture, prototype) float32
    arrays, with a (B, L) mask for a masked recipe): the three runs' losses
    and the port's and the control's parameter distances from JAX.
    ``model`` overrides ModelConfig fields (the transformer's widths);
    ``control_step`` is the control's relative nudge."""
    masked = recipe in MASKED
    fields = dict(time_head="monotone", compute_dtype=precision, gen_hidden_dim=hidden,
                  **MASKED.get(recipe, {}), **(model or {}))
    batch_size = batches[0][0].shape[0]
    tfields = dict(RECIPES[recipe], batch_size=batch_size)
    jcfg, jtcfg = JaxModelConfig(**fields), JaxTrainingConfig(**tfields)
    pcfg, ptcfg = ModelConfig(**fields), TrainingConfig(**tfields)
    diversity = bool(jtcfg.lambda_div or jtcfg.lambda_ms) and not masked
    jax_step, port_step = ((jax_masked_step, gan_train_step_masked) if masked
                           else (jax_gan_train_step, gan_train_step))
    step = jax.jit(lambda s, b: jax_step(s, b, jnp.float32(lr), jcfg, jtcfg))
    ref = jax.device_get(jax_init_gan_state(seed, jcfg, jtcfg))
    ctl = nudge(ref, seed + 1, control_step)
    port = train_state_from_jax(ref, device="cpu")
    names = [n for n in LOSSES if not masked or n in MASKED_LOSSES]
    for k, arrays in enumerate(batches):
        noise = jax_step_draws(ref["rng"], batch_size, jtcfg.n_critic, jcfg.latent_dim, diversity)
        batch = dict(zip(("gesture", "prototype", "mask"), arrays))
        jbatch = {key: jnp.asarray(v) for key, v in batch.items()}
        ref, ref_m = jax.device_get(step(ref, jbatch))
        ctl, ctl_m = jax.device_get(step(ctl, jbatch))
        port, port_m = port_step(port, {key: torch.from_numpy(v) for key, v in batch.items()},
                                 lr, pcfg, ptcfg, noise=noise)
        yield {"step": k,
               "losses": {name: [float(ref_m[name]), port_m[name].item(), float(ctl_m[name])]
                          for name in names},
               "port": {m: distance(port_params(port, m), ref[m]["params"]) for m in MODELS},
               "control": {m: distance(ctl[m]["params"], ref[m]["params"]) for m in MODELS}}


def parting(records, run: str, model: str = "g") -> dict:
    """The first step at which ``run``'s distance from JAX passes each of
    THRESHOLDS, or None."""
    out = {}
    for t in THRESHOLDS:
        out[f"{t:g}"] = next((r["step"] for r in records if r[run][model] > t), None)
    return out


def corpus_batches(zip_path: str, n_users: int, batch_size: int, steps: int, seed: int,
                   variable: bool = False):
    """``steps`` batches of the synthetic corpus's training split, drawn as
    one shuffle with ``seed`` (the split is the sweeps': 0.8, seed 42);
    ``variable``: the variable-length split (``train_gan.py
    --variable-length``'s loader, arc step 0.02), each batch with its mask."""
    from wordgesture_gan_tpu.data.synthetic import write_synthetic_swipelogs_zip
    from wordgesture_gan_tpu.keyboard import QWERTYKeyboard

    if not Path(zip_path).exists():
        Path(zip_path).parent.mkdir(parents=True, exist_ok=True)
        write_synthetic_swipelogs_zip(zip_path, n_users=n_users)
    if variable:
        from wordgesture_gan_tpu.data.variable_length import (create_variable_split,
                                                              load_variable_dataset_from_zip)

        tcfg = JaxTrainingConfig()
        by_word, _ = load_variable_dataset_from_zip(
            zip_path, QWERTYKeyboard(), max_len=128, arc_step=0.02,
            max_samples_per_word=tcfg.max_samples_per_word, seed=42, verbose=False)
        train, _ = create_variable_split(by_word, QWERTYKeyboard(), max_len=128, seed=42,
                                         verbose=False)
        arrays = (train.gestures, train.prototypes, train.masks())
    else:
        from wordgesture_gan_tpu.data.pipeline import (create_train_test_split,
                                                       load_dataset_from_zip)

        g, p = load_dataset_from_zip(zip_path, QWERTYKeyboard(),
                                     JaxModelConfig(time_head="monotone"), JaxTrainingConfig())
        train, _ = create_train_test_split(g, p, 0.8, seed=42, verbose=False)
        arrays = (train.gestures, train.prototypes)
    idx = np.random.default_rng(seed).permutation(len(arrays[0]))
    need = steps * batch_size
    idx = np.concatenate([idx] * (need // len(idx) + 1))[:need]
    return [tuple(a[s].astype(np.float32) for a in arrays) for s in np.split(idx, steps)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--recipe", choices=sorted(RECIPES), default="flag")
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--hidden", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--zip", default="dataset/synthetic_swipelogs_1338.zip")
    ap.add_argument("--synthetic-users", type=int, default=1338)
    ap.add_argument("--precision", choices=["float32", "bfloat16"], default="float32")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    batches = corpus_batches(args.zip, args.synthetic_users, args.batch_size, args.steps,
                             args.seed, variable=args.recipe in MASKED)
    records = []
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        f.write(json.dumps({"recipe": args.recipe, **RECIPES[args.recipe],
                            **MASKED.get(args.recipe, {}), "precision": args.precision,
                            "batch_size": args.batch_size, "hidden": args.hidden,
                            "seed": args.seed, "steps": args.steps}) + "\n")
        t0 = time.perf_counter()
        for rec in trajectory(batches, args.recipe, args.hidden, args.seed,
                              precision=args.precision):
            rec["seconds"] = round(time.perf_counter() - t0, 1)
            records.append(rec)
            f.write(json.dumps(rec) + "\n")
            f.flush()
        summary = {"parting_g": {run: parting(records, run) for run in ("port", "control")}}
        f.write(json.dumps(summary) + "\n")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
