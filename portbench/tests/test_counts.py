"""Operation and byte counts against sums written out by hand."""

import pytest

from portbench import flops

MODEL = {"seq_length": 4, "latent_dim": 2, "generator_type": "bilstm", "gen_hidden_dim": 3,
         "gen_num_layers": 2, "enc_hidden_dims": [5, 4], "compute_dtype": "bfloat16"}


def test_bilstm_flops_by_hand():
    # L=4, H=3 (4H=12), Z=2, two layers, one sample: per step and direction
    # the first layer's products are 12·(3 + 2), the second's 12·(3·3);
    # the latent projection once per direction, 12·2.
    per_sample = 2 * (4 * 2 * 12 * 5 + 4 * 2 * 12 * 9 + 2 * 12 * 2)
    assert flops.bilstm_flops(1, 4, 3, 2, 2) == per_sample
    assert flops.bilstm_flops(7, 4, 3, 2, 2) == 7 * per_sample


def test_generator_encoder_critic_by_hand():
    out_head = 2 * 4 * 6 * 3
    assert flops.generator_flops(MODEL) == flops.bilstm_flops(1, 4, 3, 2, 2) + out_head
    # 12 -> 5 -> 4, then mu and log_var heads 4 -> 2 each.
    assert flops.encoder_flops(MODEL) == 2 * (12 * 5 + 5 * 4 + 2 * 4 * 2)
    convs = 4 * (3 * 64 * 5 + 64 * 64 * 5 + 64 * 32 * 3)
    assert flops.critic_flops(MODEL) == 2 * (convs + 256 * 128 + 128 * 64 + 64)
    tfm = {"seq_length": 4, "latent_dim": 2, "generator_type": "transformer",
           "tfm_d_model": 8, "tfm_mlp_ratio": 2, "tfm_num_layers": 1}
    block = 2 * 4 * (8 * 24 + 8 * 8 + 2 * 8 * 16) + 2 * 2 * 4 * 4 * 8
    assert flops.generator_flops(tfm) == 2 * 4 * 4 * 8 + block + 2 * 4 * 8 * 3


def test_train_step_flops_by_hand():
    training = {"batch_size": 2, "n_critic": 3, "lambda_div": 0.3}
    G, E, D = (flops.generator_flops(MODEL), flops.encoder_flops(MODEL),
               flops.critic_flops(MODEL))
    loop = 2 * E + 3 * (2 * 2 * G + 2 * (2 * 2 * D * 3))
    joint = 2 * (3 * 3 * G + E + 3 * E + 2 * (2 * D + D))
    assert flops.train_step_flops(MODEL, training) == loop + joint
    no_div = flops.train_step_flops(MODEL, dict(training, lambda_div=0.0))
    assert flops.train_step_flops(MODEL, training) - no_div == 2 * 3 * G


def test_bounds_pick_the_larger_and_scale():
    ms, by = flops.bilstm_bound_ms(512, 128, 48, 4, 32, "bfloat16")
    ops = flops.bilstm_flops(512, 128, 48, 4, 32) / flops.PEAK_FLOPS["bfloat16"] * 1e3
    assert by == "operations" and ms == pytest.approx(ops)
    # The published shape's bound (PERF.md's kernel table: 0.0245 ms at B=512).
    assert ms == pytest.approx(0.0245, rel=0.01)
    pair = flops.train_bounds_ms(512, 128, 48, 4, 32, "bfloat16")
    assert pair["fwd"][1] == "bytes" and pair["bwd"][1] == "operations"
    assert pair["fwd"][0] == pytest.approx(0.094, rel=0.02)
    assert pair["bwd"][0] == pytest.approx(0.098, rel=0.02)
    small = flops.bilstm_bound_ms(1, 4, 3, 1, 2, "float32")
    assert small[1] == "bytes"
