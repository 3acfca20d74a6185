"""The PyTorch port's generator against the JAX package, on the CPU.

Weights move from the JAX tree with ``generator_from_jax``; prototypes and
noise come from numpy seeds. float32 throughout, tolerance 1e-5 abs (same
math, different summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test worker

from wordgesture_gan_tpu.configs import ModelConfig as JaxModelConfig
from wordgesture_gan_tpu.models.gan import apply_time_head as jax_apply_time_head
from wordgesture_gan_tpu.models.gan import generator_apply, generator_init
from wordgesture_gan_tpu.models.layers import dense as jax_dense
from wordgesture_gan_tpu.models.layers import leaky_relu as jax_leaky_relu
from wordgesture_gan_tpu_torch.configs import ModelConfig
from wordgesture_gan_tpu_torch.interop.from_jax import generator_from_jax
from wordgesture_gan_tpu_torch.models.gan import Generator, apply_time_head
from wordgesture_gan_tpu_torch.models.layers import Dense, leaky_relu
from wordgesture_gan_tpu_torch.utils import prng

SMALL = dict(seq_length=16, gen_hidden_dim=16, gen_num_layers=2, latent_dim=8)


def _pair(seed=0, **overrides):
    """(JAX config, JAX params, port Generator holding the same weights)."""
    fields = {**SMALL, **overrides}
    params = jax.device_get(generator_init(jax.random.PRNGKey(seed), JaxModelConfig(**fields)))
    model = Generator(ModelConfig(**fields))
    model.load_state_dict(generator_from_jax(params))
    return JaxModelConfig(**fields), params, model


def _inputs(seed, B, L, Z):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, L, 3)).astype(np.float32),
            rng.normal(size=(B, Z)).astype(np.float32))


@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("time_head", ["tanh", "monotone"])
def test_generator_matches_jax(time_head, batch):
    jcfg, params, model = _pair(1, time_head=time_head)
    proto, z = _inputs(2, batch, jcfg.seq_length, jcfg.latent_dim)
    ref = generator_apply(params, jnp.asarray(proto), jnp.asarray(z), jcfg, inference=True)
    with torch.no_grad():
        out = model(torch.from_numpy(proto), torch.from_numpy(z))
    assert out.shape == (batch, jcfg.seq_length, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_generator_with_time_channel_matches_jax():
    jcfg, params, model = _pair(3, prototype_has_time=True, time_head="monotone")
    proto, z = _inputs(4, 3, jcfg.seq_length, jcfg.latent_dim)
    ref = generator_apply(params, jnp.asarray(proto), jnp.asarray(z), jcfg)
    with torch.no_grad():
        out = model(torch.from_numpy(proto), torch.from_numpy(z))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_generator_bf16_runs_the_fused_contract():
    """bf16 compute: finite, in range, within bf16 drift of float32."""
    _, params, model32 = _pair(5, time_head="monotone")
    model16 = Generator(ModelConfig(**SMALL, time_head="monotone", compute_dtype="bfloat16"))
    model16.load_state_dict(generator_from_jax(params))
    proto, z = _inputs(6, 4, SMALL["seq_length"], SMALL["latent_dim"])
    with torch.no_grad():
        a = model32(torch.from_numpy(proto), torch.from_numpy(z))
        b = model16(torch.from_numpy(proto), torch.from_numpy(z))
    assert b.dtype == torch.float32 and torch.isfinite(b).all()
    assert (b - a).abs().max() < 5e-2


@pytest.mark.parametrize("mode", ["tanh", "monotone", "masked"])
def test_apply_time_head_matches_jax(mode):
    rng = np.random.default_rng(7)
    raw = (rng.normal(size=(3, 20, 3)) * 3).astype(np.float32)
    mask = None
    if mode == "masked":
        mask = np.ones((3, 20), np.float32)
        mask[0, 12:] = 0
        mask[2, 5:] = 0
    head = "tanh" if mode == "tanh" else "monotone"
    ref = jax_apply_time_head(jnp.asarray(raw), head,
                              None if mask is None else jnp.asarray(mask))
    out = apply_time_head(torch.from_numpy(raw), head,
                          None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_monotone_head_runs_from_zero_to_one():
    raw = torch.randn(4, 32, 3, generator=torch.Generator().manual_seed(0)) * 4
    t = apply_time_head(raw, "monotone")[..., 2]
    assert torch.all(t[:, 0] == 0)
    torch.testing.assert_close(t[:, -1], torch.ones(4), atol=1e-6, rtol=0)
    assert torch.all(t[:, 1:] >= t[:, :-1])
    with pytest.raises(ValueError):
        apply_time_head(raw, "linear")


def test_dense_and_leaky_relu_match_jax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(5, 7)).astype(np.float32)
    layer = Dense(7, 3, prng.PRNGKey(1))
    params = {"w": jnp.asarray(layer.w.detach().numpy()), "b": jnp.asarray(layer.b.detach().numpy())}
    with torch.no_grad():
        np.testing.assert_allclose(layer(torch.from_numpy(x)).numpy(),
                                   np.asarray(jax_dense(params, jnp.asarray(x))), atol=1e-6)
    np.testing.assert_array_equal(leaky_relu(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_leaky_relu(jnp.asarray(x))))


def test_generator_state_dict_matches_jax_tree():
    _, params, model = _pair(9)
    state = generator_from_jax(params)
    assert set(state) == set(model.state_dict())
    assert state["lstm.1.bwd.w_ih"].shape == (2 * SMALL["gen_hidden_dim"], 4 * SMALL["gen_hidden_dim"])
    assert state["out.w"].shape == (2 * SMALL["gen_hidden_dim"], 3)
    np.testing.assert_array_equal(model.lstm[0]["fwd"].w_hh.detach().numpy(),
                                  np.asarray(params["lstm"][0]["fwd"]["w_hh"]))


@pytest.mark.parametrize("generator_type", ["mlp", "transformer"])
def test_unported_generators_are_rejected(generator_type):
    """The other two families are ported: each builds at full width and
    samples finite gestures on the CPU (their parity with JAX is
    ``tests/test_torch_generators.py``)."""
    model = Generator(ModelConfig(generator_type=generator_type, time_head="monotone"),
                      prng.PRNGKey(0))
    proto, z = _inputs(10, 3, 128, 32)
    with torch.no_grad():
        out = model(torch.from_numpy(proto), torch.from_numpy(z), inference=True)
    assert out.shape == (3, 128, 3) and torch.isfinite(out).all()
    assert torch.all(out[..., 0, 2] == 0) and torch.all(out[..., 1:, 2] >= out[..., :-1, 2])
