"""The plain reference against the program at a tiny size on the CPU, the
program in float32 (where the two must agree to rounding): the random
streams, one step's losses, gradients and change, and sampled gestures."""

import numpy as np
import pytest
import torch

from portbench.kinds import generate, train
from portbench.reference import prng


def test_streams_equal_the_programs():
    from wordgesture_gan_tpu_torch.utils import prng as program

    key = prng.fold_in(prng.PRNGKey(2 ** 33 + 7), 3)
    want = program.fold_in(program.PRNGKey(2 ** 33 + 7), 3)
    assert [int(v) for v in key] == want.tolist()
    assert (prng.split(key, 5).astype(np.int64) == program.split(want, 5).numpy()).all()
    assert torch.equal(prng.uniform(key, (64,), -0.5, 0.5), program.uniform(want, (64,), -0.5, 0.5))
    assert torch.allclose(prng.normal(key, (4, 16)), program.normal(want, (4, 16)),
                          rtol=0, atol=2e-6)
    assert torch.allclose(prng.normal(key, (16,), start=32), program.normal(want, (4, 16))[2],
                          rtol=0, atol=2e-6)
    assert (prng.permutation(key, 3000) == program.permutation(want, 3000).numpy()).all()


@pytest.mark.parametrize("workload", ["flagship.train", "varlen_transformer.train"])
def test_reference_step_follows_the_program(workload, small, cell_of):
    cell = small(cell_of(workload))
    r = train.program_run(cell, 12345678901, 0.0, False, 0.0, "cpu")
    want = train.reference_steps(cell, 12345678901, r["data"], "cpu")
    numbers, _ = train.compare(r["readings"], want)
    # Steps 2 and 3 amplify rounding: Adam moves a parameter by about the
    # learning rate whatever the size of its gradient, so the sign of a
    # gradient at rounding level shows in the next losses.
    assert numbers["loss_gap"] < 2e-3 and numbers["grad_gap"] < 1e-3
    assert numbers["replay_loss_gap"] < 2e-3 and numbers["replay_grad_gap"] < 2e-2
    assert numbers["replay_grad_diff"] < 2e-2
    assert numbers["change_gap"] < 2e-2
    control, _ = train.compare(
        train.reference_steps(cell, 12345678901, r["data"], "cpu", "float8"), want)
    assert max(control[k] / max(numbers[k], 1e-12) for k in numbers) > 10


@pytest.mark.parametrize("workload", ["flagship.generate", "varlen_transformer.generate"])
def test_reference_rows_follow_the_program(workload, small, cell_of):
    cell = small(cell_of(workload))
    r = generate.program_run(cell, 2 ** 40 + 1, 0.2, False, 0.0, "cpu")
    want = generate.reference_rows(cell, r, "cpu")
    assert generate.compare(r, want)[0]["widest_gap"] < 1e-4
    fp8 = generate.reference_rows(cell, r, "cpu", "float8")
    assert np.abs(fp8 - want).max() > 1e-3
