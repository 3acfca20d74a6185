"""The quality runs' five GAN recipes (the flagship, the control, the
flagship's two auxiliary terms one at a time, the variable-length run): one
step of each at full width (the flagship BiLSTM at H=48, L=128, the default
transformer) on gesture-like data with the draws the JAX step makes from
its key, against the JAX step, in float32 and in bfloat16. float32: losses
1e-4 relative to max(1, |loss|); gradients (Adam's moments after a step at
lr=0) of each leaf's largest: 1e-3 for the variable-length recipe (measured
2e-5), 3e-3 for the recipes with lambda_speed (measured 7.3e-4 to 1.3e-3).
bfloat16: see the test. The monotone head's clock is a cumulative sum
whose increments the speed-profile and Pearson terms divide by; summed in
another order they differ by up to 2.5e-5 relative between the packages.
At full width with the flagship's terms that moves G's and E's gradients by
1.3e-3 to 2.0e-3 against JAX, and by 1.1e-3 between two runs of the port
itself on 1 and on 8 CPU threads (another summation order); with no
auxiliary term the gap to JAX is 1e-6. On identical inputs the two
packages' auxiliary losses agree in their gradients to 2e-7 of the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  one torch thread per test worker
from tests.jax_trajectory import jax_step_draws, nudge
from tests.recipe_parity import STEP_B, gesture_batch, leaves_by_path
from wordgesture_gan_tpu.configs import ModelConfig as JaxModelConfig
from wordgesture_gan_tpu.configs import TrainingConfig as JaxTrainingConfig
from wordgesture_gan_tpu.train import gan_train_step as jax_gan_train_step
from wordgesture_gan_tpu.train import init_gan_state as jax_init_gan_state
from wordgesture_gan_tpu.train.masked_step import gan_train_step_masked as jax_masked_step
from wordgesture_gan_tpu_torch.configs import ModelConfig, TrainingConfig
from wordgesture_gan_tpu_torch.interop.from_jax import adam_moments, train_state_from_jax
from wordgesture_gan_tpu_torch.train.gan_step import gan_train_step
from wordgesture_gan_tpu_torch.train.masked_step import gan_train_step_masked
from wordgesture_gan_tpu_torch.train.state import MODELS

RECIPES = {
    # runs/r5_sweep4.sh: the flagship, its margin as runs/r5_train_flag.log measured it
    "flag": (dict(), dict(lambda_speed=2.0, lambda_div=0.3, lambda_dtc=4.0, div_margin=0.066),
             3e-3),
    # runs/r5_sweep5.sh: the variable-length run
    "varlen2": (dict(generator_type="transformer"), dict(lambda_speed=2.0), 1e-3),
    # runs/r5_sweep.sh, r5_sweep3.sh, r5_sweep2.sh: the control and the
    # flagship's auxiliary terms one at a time, each beside lambda_speed=2
    "base": (dict(), dict(lambda_speed=2.0), 3e-3),
    "div03": (dict(), dict(lambda_speed=2.0, lambda_div=0.3, div_margin=0.066), 3e-3),
    "dtc4": (dict(), dict(lambda_speed=2.0, lambda_dtc=4.0), 3e-3),
}
# bfloat16 (every quality run but flag_fp32 trains in it): losses within
# BF16_LOSS_TOL of max(1, |loss|); each model's gradient (Adam's first
# moments, the relative L2 distance of the whole tree) within
# BF16_CONTROL_FACTOR times the distance of the control, the JAX step from
# the initial state nudged by one float32 rounding step, plus BF16_FLOOR.
BF16_LOSS_TOL = 2e-2
BF16_CONTROL_FACTOR, BF16_FLOOR = 2.0, 0.15
STEP_CASES = [pytest.param(run, "float32", id=run) for run in RECIPES] + [
    pytest.param(run, "bfloat16", id=f"{run}-bfloat16") for run in RECIPES]


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(np.sum((np.asarray(got[p], np.float64) - np.asarray(w, np.float64)) ** 2))
              for p, w in want.items())
    return (num / sum(float(np.sum(np.asarray(w, np.float64) ** 2)) for w in want.values())) ** 0.5


@pytest.mark.parametrize("run, dtype", STEP_CASES)
def test_the_recipe_step_at_full_width_matches_jax(run, dtype):
    """float32: as the module's docstring says. bfloat16: a rounding that
    flips on one side moves everything after it, and the JAX step itself
    moves as far from a one-ulp nudge of its initial state (G's gradient by
    15-46% relative L2), so each model is held to that control as
    BF16_CONTROL_FACTOR and BF16_FLOOR say. Measured, port / control: G
    0.18-0.62 / 0.15-0.46, E 0.09-0.59 / 0.09-0.36; the critics 0.02-0.10 /
    0.002-0.008, which the floor covers: among their differences are the
    bias gradients, which XLA's CPU backend sums in bfloat16 with a rounding
    after every add (in windows of 32) and the port in float32 with one
    rounding, as its kernels do (ROADMAP, Queue 3). Losses up to 5.7e-3 of
    max(1, |loss|)."""
    model, recipe, grad_tol = RECIPES[run]
    masked = model.get("generator_type") == "transformer"
    fields = dict(model, time_head="monotone", compute_dtype=dtype)
    tfields = dict(recipe, batch_size=STEP_B)
    jcfg, jtcfg = JaxModelConfig(**fields), JaxTrainingConfig(**tfields)
    start = jax.device_get(jax_init_gan_state(0, jcfg, jtcfg))
    batch = gesture_batch(jcfg.seq_length, masked)
    jax_step = jax.jit(lambda s, b: (jax_masked_step if masked else jax_gan_train_step)(
        s, b, jnp.float32(0.0), jcfg, jtcfg))
    ref_state, ref_metrics = jax.device_get(jax_step(start, jax.tree.map(jnp.asarray, batch)))
    state = train_state_from_jax(start, device="cpu")
    noise = jax_step_draws(start["rng"], STEP_B, jtcfg.n_critic, jcfg.latent_dim,
                           bool(jtcfg.lambda_div) and not masked)
    step = gan_train_step_masked if masked else gan_train_step
    _, metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, 0.0,
                      ModelConfig(**fields), TrainingConfig(**tfields), noise=noise)
    assert set(metrics) == set(ref_metrics)
    loss_tol = 1e-4 if dtype == "float32" else BF16_LOSS_TOL
    for k, v in metrics.items():
        want = float(ref_metrics[k])
        assert abs(v.item() - want) <= loss_tol * max(1.0, abs(want)), (k, v.item(), want)
    if dtype == "bfloat16":
        ctl_state, _ = jax.device_get(jax_step(nudge(start, 1), jax.tree.map(jnp.asarray, batch)))
    for model_name in MODELS:
        want = leaves_by_path(adam_moments(ref_state[model_name]["opt"])["mu"])
        got = leaves_by_path(state[model_name]["opt"]["mu"])
        assert set(got) == set(want)
        if dtype == "bfloat16":
            port = _rel_l2({p: v.numpy() for p, v in got.items()}, want)
            ctl = _rel_l2(leaves_by_path(adam_moments(ctl_state[model_name]["opt"])["mu"]), want)
            assert port <= BF16_CONTROL_FACTOR * ctl + BF16_FLOOR, (model_name, port, ctl)
            continue
        for path, leaf in got.items():
            w = np.asarray(want[path])
            np.testing.assert_allclose(leaf.numpy(), w,
                                       atol=grad_tol * max(np.abs(w).max(), 1e-30),
                                       err_msg=f"{model_name}{path}")
