"""Score a variable-length generator the port trained with the JAX package's
evaluation and with the port's, on the CPU, DTW off.

    JAX_PLATFORMS=cpu python tests/jax_eval_of_port_checkpoint.py \
        --checkpoint runs_torch/varlen2/epoch_200.pt \
        --zip dataset/synthetic_swipelogs_1338.zip --cache-dir build/vl_eval

The port's checkpoint (a ``train_cli --variable-length`` run) is loaded
twice: its generator tree as JAX arrays into the JAX package's
``generate_variable_gestures``, and through the port's ``load_generator``.
Both sample the first 2000 test prototypes with seed 42; each package's
``evaluate_all_metrics`` scores its own samples at 128 points (FID
autoencoders one epoch: FID is not read), and the JAX package's also scores
the port's samples. Three lines of metrics follow: the JAX evaluation of the
port's generator, the port's evaluation of it, and the JAX metrics on the
port's samples. runs_torch/diagnostics/varlen2_jax_eval.log is its output on
the seed-42 ``varlen2`` checkpoint.
"""

import argparse
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from wordgesture_gan_tpu.configs import EvaluationConfig as JaxEvaluationConfig  # noqa: E402
from wordgesture_gan_tpu.configs import ModelConfig as JaxModelConfig  # noqa: E402
from wordgesture_gan_tpu.configs import TrainingConfig as JaxTrainingConfig  # noqa: E402
from wordgesture_gan_tpu.data.variable_length import (  # noqa: E402
    create_variable_split, load_variable_dataset_from_zip)
from wordgesture_gan_tpu.keyboard import QWERTYKeyboard  # noqa: E402
from wordgesture_gan_tpu.metrics import suite as jax_suite  # noqa: E402
from wordgesture_gan_tpu.ops.resample import batched_arclength_resample  # noqa: E402
from wordgesture_gan_tpu.train.variable_loop import generate_variable_gestures  # noqa: E402
from wordgesture_gan_tpu_torch.configs import EvaluationConfig, ModelConfig  # noqa: E402
from wordgesture_gan_tpu_torch.metrics import suite as port_suite  # noqa: E402
from wordgesture_gan_tpu_torch.ops.resample import (  # noqa: E402
    batched_arclength_resample as port_resample)
from wordgesture_gan_tpu_torch.train.checkpoint import load_generator  # noqa: E402
from wordgesture_gan_tpu_torch.train.variable_loop import (  # noqa: E402
    generate_variable_gestures as port_generate)

KEYS = ["l2_wasserstein", "velocity_corr", "acceleration_corr", "speed_profile_corr",
        "time_delta_corr", "precision", "recall", "jerk_fake"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--zip", default="dataset/synthetic_swipelogs_1338.zip")
    ap.add_argument("--cache-dir", default="build/vl_eval")
    ap.add_argument("--n-samples", type=int, default=2000)
    ap.add_argument("--threads", type=int, default=6)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    n, cache = args.n_samples, Path(args.cache_dir)
    saved = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    jax_tree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), saved["g"]["params"])
    mc = JaxModelConfig(generator_type="transformer", time_head="monotone")
    by_word, _ = load_variable_dataset_from_zip(
        args.zip, QWERTYKeyboard(), max_len=128, arc_step=0.02,
        max_samples_per_word=JaxTrainingConfig().max_samples_per_word, seed=42)
    train_ds, test_ds = create_variable_split(by_word, QWERTYKeyboard(), max_len=128,
                                              train_ratio=JaxTrainingConfig().train_ratio,
                                              seed=42)
    fake = generate_variable_gestures({"g": {"params": jax_tree}}, test_ds.prototypes[:n],
                                      test_ds.masks()[:n], mc, seed=42)
    lengths = jnp.asarray(test_ds.lengths[:n])
    real128 = np.asarray(batched_arclength_resample(jnp.asarray(test_ds.gestures[:n]),
                                                    lengths, 128))
    fake128 = np.asarray(batched_arclength_resample(jnp.asarray(fake), lengths, 128))
    train128 = np.asarray(batched_arclength_resample(jnp.asarray(train_ds.gestures),
                                                     jnp.asarray(train_ds.lengths), 128))
    jax_eval = JaxEvaluationConfig(n_samples=n, fid_autoencoder_epochs=1)
    scored = jax_suite.evaluate_all_metrics(
        real128, fake128, train128, model_config=dataclasses.replace(mc, seq_length=128),
        eval_config=jax_eval, skip_dtw=True, cache_dir=str(cache / "jax"))
    print("JAX eval of the port generator:", {k: round(float(scored[k]), 4) for k in KEYS},
          flush=True)

    pmc = ModelConfig(generator_type="transformer", time_head="monotone")
    model = load_generator(args.checkpoint, pmc, device="cpu")
    port_fake = port_generate(model, test_ds.prototypes[:n], test_ds.masks()[:n], pmc, seed=42,
                              device="cpu")
    plen = torch.from_numpy(test_ds.lengths[:n])
    pfake128 = port_resample(torch.from_numpy(port_fake), plen, 128).numpy()
    preal128 = port_resample(torch.from_numpy(test_ds.gestures[:n]), plen, 128).numpy()
    ptrain128 = port_resample(torch.from_numpy(train_ds.gestures),
                              torch.from_numpy(train_ds.lengths), 128).numpy()
    print("real grids equal:", np.abs(preal128 - real128).max(), flush=True)
    scored = port_suite.evaluate_all_metrics(
        preal128, pfake128, ptrain128, model_config=dataclasses.replace(pmc, seq_length=128),
        eval_config=EvaluationConfig(n_samples=n, fid_autoencoder_epochs=1), skip_dtw=True,
        cache_dir=str(cache / "port"), device="cpu")
    print("port eval of the port generator:", {k: round(float(scored[k]), 4) for k in KEYS},
          flush=True)
    scored = jax_suite.evaluate_all_metrics(
        real128, pfake128, train128, model_config=dataclasses.replace(mc, seq_length=128),
        eval_config=jax_eval, skip_dtw=True, cache_dir=str(cache / "jax"))
    print("JAX metrics on the port's samples:", {k: round(float(scored[k]), 4) for k in KEYS},
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
