"""Over several steps (``tests/jax_trajectory.py`` at H=8, with the flagship's
terms and with none, and the variable-length recipe on a small transformer;
float32 and bfloat16) the port trains from one JAX initial state as close to
JAX as the control, JAX from a nudged state; the full-width runs of that
script are in ``runs_torch/diagnostics/``.

``init_gan_state`` against the JAX package's, leaf by leaf, for each
generator family at full width.
"""

import jax
import numpy as np
import pytest

import torch_threads  # noqa: F401  one torch thread per test worker
from tests.jax_trajectory import trajectory
from tests.recipe_parity import gesture_batch, leaves_by_path
from wordgesture_gan_tpu.configs import ModelConfig as JaxModelConfig
from wordgesture_gan_tpu.configs import TrainingConfig as JaxTrainingConfig
from wordgesture_gan_tpu.train import init_gan_state as jax_init_gan_state
from wordgesture_gan_tpu_torch.configs import ModelConfig
from wordgesture_gan_tpu_torch.train.state import MODELS, init_gan_state

TRAJECTORY_STEPS = 8


# The variable-length recipe on a small transformer (H=8 is the BiLSTM's).
SMALL_TRANSFORMER = dict(tfm_d_model=16, tfm_num_heads=2, tfm_num_layers=2)


@pytest.mark.parametrize("recipe", ["flag", "none", "varlen2", "varlen2-bfloat16"])
def test_the_recipe_tracks_jax_over_steps(recipe):
    """``tests/jax_trajectory.py`` at a small size (H=8, or a transformer of
    width 16 with two blocks for the variable-length recipe on its masked
    batch; four gestures, one batch repeated): the port and the JAX package
    train from one JAX initial state on the JAX step's own draws, with the
    flagship's auxiliary terms, with none, and with lambda_speed alone
    (varlen2). float32: over TRAJECTORY_STEPS steps G's and E's parameters
    stay within 1e-3 of JAX's (relative norm of the difference; measured up
    to 4.5e-4) and the reconstruction, latent and KLD losses within 1e-3
    relative (measured up to 5.4e-4, the KLD at the last step without
    auxiliary terms). The control, JAX from its initial state nudged by one
    float32 rounding step, must stay within the same bound on its parameters.
    bfloat16: with this few parameters a float32 nudge flips no bfloat16
    rounding, so the control is nudged by bfloat16's unit roundoff (2^-8,
    random sign); G's and E's distances from JAX must stay at or under the
    control's at every step (measured: G 0.8-1.3e-3 against 4.0-4.2e-3, E
    3.0-5.0e-3 against 5.3-6.3e-3) and cycle2_rec within 2e-3 relative
    (measured up to 1.4e-3)."""
    recipe, _, precision = recipe.partition("-")
    precision = precision or "float32"
    masked = recipe == "varlen2"
    batch = gesture_batch(128, masked)
    arrays = (batch["gesture"], batch["prototype"]) + ((batch["mask"],) if masked else ())
    bf16 = precision == "bfloat16"
    records = list(trajectory([arrays] * TRAJECTORY_STEPS, recipe, hidden=8,
                              precision=precision, model=SMALL_TRANSFORMER if masked else None,
                              control_step=2.0 ** -8 if bf16 else 2.0 ** -24))
    assert len(records) == TRAJECTORY_STEPS
    names = ("cycle2_rec",) if masked else ("cycle2_rec", "cycle1_lat", "cycle2_kld")
    for rec in records:
        for model in ("g", "e"):
            if bf16:
                assert rec["port"][model] <= rec["control"][model], (rec["step"], model, rec)
                continue
            assert rec["port"][model] < 1e-3, (rec["step"], model, rec["port"])
            assert rec["control"][model] < 1e-3, (rec["step"], model, rec["control"])
        for name in names:
            want, got, _ = rec["losses"][name]
            tol = 2e-3 if bf16 else 1e-3
            assert abs(got - want) <= tol * max(1.0, abs(want)), (rec["step"], name, got, want)


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("family", ["bilstm", "mlp", "transformer"])
def test_initial_state_draws_like_jax(family):
    """The port's ``init_gan_state(42)`` is the JAX package's: every leaf of
    G, E, D1 and D2 (weights, biases, the output heads) within 1 ulp, the
    critics' u vectors within 2 ulp (their normal draws are bit-equal; the
    two packages sum the normalising norm in another order), and the same
    key, for each generator family at full width."""
    cfg = dict(time_head="monotone", generator_type=family)
    ref = jax.device_get(jax_init_gan_state(42, JaxModelConfig(**cfg), JaxTrainingConfig()))
    state = init_gan_state(42, ModelConfig(**cfg), "cpu")
    np.testing.assert_array_equal(state["rng"].numpy(), np.asarray(ref["rng"]))
    for model in MODELS:
        for part, tol in (("params", 1), ("sn", 2)):
            if part not in ref[model]:
                continue
            want = leaves_by_path(ref[model][part])
            got = {k: v.detach().numpy() for k, v in leaves_by_path(state[model][part]).items()}
            assert set(got) == set(want), (model, part)
            for path, w in want.items():
                assert got[path].shape == np.shape(w), (model, path)
                assert _ulps(got[path], w) <= tol, (model, part, path)
