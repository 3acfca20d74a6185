"""The port's MLP and transformer generators against the JAX package, on the CPU.

Small sizes: transformer d_model 16, 2 heads, 2 layers; MLP widths (32, 32);
L = 32, B = 8, Z = 8. Inputs come from numpy seeds, weights are JAX's
``generator_init`` carried over by ``interop.from_jax``. Tolerances, each
stated at its test: forward 1e-5 abs in float32 and 2e-2 abs in bfloat16
(one bf16 rounding of the activations, summed in another order); the bf16
layer norm bit-equal;
gradients 1e-4 of each leaf's largest |gradient|; one fixed-length
``gan_train_step`` per family: losses 1e-4 relative to max(1, |loss|),
gradients (Adam's moments after a step at lr=0) 1e-3 of each leaf's largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test worker

from wordgesture_gan_tpu.configs import ModelConfig as JaxModelConfig
from wordgesture_gan_tpu.configs import TrainingConfig as JaxTrainingConfig
from wordgesture_gan_tpu.models import gan as jax_gan
from wordgesture_gan_tpu.models import generators as jax_generators
from wordgesture_gan_tpu.train import gan_train_step as jax_gan_train_step
from wordgesture_gan_tpu.train import init_gan_state as jax_init_gan_state
from wordgesture_gan_tpu_torch.configs import ModelConfig, TrainingConfig
from wordgesture_gan_tpu_torch.interop.from_jax import (adam_moments, flatten_tree,
                                                        generator_family, generator_from_jax,
                                                        train_state_from_jax)
from wordgesture_gan_tpu_torch.models import generators
from wordgesture_gan_tpu_torch.models.gan import Generator, generator_apply, generator_init
from wordgesture_gan_tpu_torch.train.gan_step import gan_train_step
from wordgesture_gan_tpu_torch.train.state import MODELS, init_gan_state
from wordgesture_gan_tpu_torch.utils import prng

B, L, Z = 8, 32, 8
SMALL = dict(seq_length=L, latent_dim=Z, tfm_d_model=16, tfm_num_heads=2, tfm_num_layers=2,
             tfm_mlp_ratio=4, mlp_gen_hidden_dims=(32, 32), time_head="monotone")
FAMILIES = ("mlp", "transformer")
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}


def _configs(family, **overrides):
    fields = {**SMALL, "generator_type": family, **overrides}
    return JaxModelConfig(**fields), ModelConfig(**fields)


def _pair(family, seed=0, **overrides):
    """(JAX config, JAX params, port config, port Generator with those weights)."""
    jcfg, cfg = _configs(family, **overrides)
    params = jax.device_get(jax_gan.generator_init(jax.random.PRNGKey(seed), jcfg))
    model = Generator(cfg)
    model.load_state_dict(generator_from_jax(params))
    return jcfg, params, cfg, model


def _inputs(seed):
    """Prototype, z and a padding mask: varied lengths, one all-zero row."""
    rng = np.random.default_rng(seed)
    proto = rng.uniform(-1, 1, (B, L, 3)).astype(np.float32)
    z = rng.normal(size=(B, Z)).astype(np.float32)
    lengths = rng.integers(2, L + 1, B)
    lengths[0], lengths[1] = L, 0
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    return proto, z, mask


def _jax_apply(family, params, proto, z, jcfg, mask):
    if family == "transformer":
        return jax_generators.transformer_generator_apply(params, proto, z, jcfg, pad_mask=mask)
    return jax_generators.mlp_generator_apply(params, proto, z, jcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_forward_matches_jax(family, dtype):
    """Both families, both dtypes; the transformer under a padding mask with
    an all-zero row, whose output is finite (a uniform softmax) as in JAX."""
    jcfg, params, cfg, model = _pair(family, 1, compute_dtype=dtype)
    proto, z, mask = _inputs(2)
    jmask = jnp.asarray(mask) if family == "transformer" else None
    ref = np.asarray(_jax_apply(family, params, jnp.asarray(proto), jnp.asarray(z), jcfg, jmask))
    with torch.no_grad():
        out = model(torch.from_numpy(proto), torch.from_numpy(z),
                    pad_mask=torch.from_numpy(mask) if family == "transformer" else None)
    assert out.shape == (B, L, 3) and out.dtype == torch.float32
    assert torch.isfinite(out).all() and np.isfinite(ref).all()
    np.testing.assert_allclose(out.numpy(), ref, atol=TOLERANCE[dtype])


@pytest.mark.parametrize("family", FAMILIES)
def test_generator_apply_dispatches_like_jax(family):
    """``generator_apply`` without a mask == JAX's ``generator_apply``
    (whose dispatch passes no mask), and ``inference`` changes nothing."""
    jcfg, params, cfg, model = _pair(family, 3)
    proto, z, _ = _inputs(4)
    ref = np.asarray(jax_gan.generator_apply(params, jnp.asarray(proto), jnp.asarray(z), jcfg))
    with torch.no_grad():
        for inference in (False, True):
            out = generator_apply(model.tree(), torch.from_numpy(proto), torch.from_numpy(z),
                                  cfg, inference=inference)
            np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("family", FAMILIES)
def test_gradients_match_jax(family):
    """d(Σ out·w)/d(params, z) against ``jax.grad``, float32, masked for the
    transformer: 1e-4 of each leaf's largest |gradient|."""
    jcfg, params, cfg, model = _pair(family, 5)
    proto, z, mask = _inputs(6)
    w = np.random.default_rng(7).normal(size=(B, L, 3)).astype(np.float32)
    jmask = jnp.asarray(mask) if family == "transformer" else None

    def jax_loss(p, zz):
        return jnp.sum(_jax_apply(family, p, jnp.asarray(proto), zz, jcfg, jmask) * w)

    ref_p, ref_z = jax.grad(jax_loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, params),
                                                      jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    out = model(torch.from_numpy(proto), zt,
                pad_mask=torch.from_numpy(mask) if family == "transformer" else None)
    (out * torch.from_numpy(w)).sum().backward()
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    want = {k.replace("/", "."): v for k, v in flatten_tree(jax.device_get(ref_p)).items()}
    assert set(got) == set(want)
    for name, g in list(got.items()) + [("z", zt.grad.numpy())]:
        ref = np.asarray(want[name] if name != "z" else ref_z)
        np.testing.assert_allclose(g, ref, atol=1e-4 * max(np.abs(ref).max(), 1e-30),
                                   err_msg=name)


@pytest.mark.parametrize("family", FAMILIES)
def test_layouts_match_the_jax_tree(family):
    """The port's init gives the JAX tree's paths and shapes, and the
    converter fills exactly the module's parameters."""
    jcfg, params, cfg, model = _pair(family, 8)
    ours = {k: v.shape for k, v in flatten_tree(
        generator_init(cfg, prng.PRNGKey(0))).items()}
    theirs = {k: tuple(np.shape(v)) for k, v in flatten_tree(params).items()}
    assert ours == theirs
    state = generator_from_jax(params)
    assert set(state) == set(model.state_dict())
    assert generator_family(params) == family
    tree = model.tree()
    assert generator_family(tree) == family
    if family == "transformer":
        assert state["pos"].shape == (L, 16) and state["blocks.1.qkv.w"].shape == (16, 48)
        np.testing.assert_array_equal(tree["blocks"][1]["mlp2"]["w"].detach().numpy(),
                                      np.asarray(params["blocks"][1]["mlp2"]["w"]))
    else:
        assert state["mlp.0.w"].shape == (L * 2 + Z, 32) and state["out.w"].shape == (32, L * 3)


def test_layernorm_keeps_the_jax_precision_order():
    """bf16 input: moments in float32, normalized value rounded to bf16
    before the (bf16) scale and bias — bit-equal to JAX's ``_layernorm``."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(4, 5, 16)).astype(np.float32) * 3 + 1
    p = {"scale": rng.normal(size=16).astype(np.float32),
         "bias": rng.normal(size=16).astype(np.float32)}
    ref = jax_generators._layernorm({k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(x, jnp.bfloat16))
    out = generators._layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                                torch.from_numpy(x).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))
    ref32 = jax_generators._layernorm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    out32 = generators._layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                                  torch.from_numpy(x))
    np.testing.assert_allclose(out32.numpy(), np.asarray(ref32), atol=1e-5)


# -- one fixed-length train step per family ----------------------------------------------------

STEP_MODEL = dict(enc_hidden_dims=(24, 16))
STEP_TRAINING = dict(batch_size=B, n_critic=2)


def _batch_and_noise(seed):
    rng = np.random.default_rng(seed)
    gesture = rng.uniform(-1, 1, (B, L, 3)).astype(np.float32)
    gesture[..., 2] = np.sort(rng.uniform(0, 1, (B, L)), axis=1)
    batch = {"gesture": gesture, "prototype": rng.uniform(-1, 1, (B, L, 3)).astype(np.float32)}
    noise = {"z_rand": rng.normal(size=(2, B, Z)), "eps_enc": rng.normal(size=(2, B, Z)),
             "z1": rng.normal(size=(B, Z)), "eps_rec": rng.normal(size=(B, Z)),
             "eps2": rng.normal(size=(B, Z))}
    return batch, {k: v.astype(np.float32) for k, v in noise.items()}


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _paths(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree) for p, v in _paths(x, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("family", FAMILIES)
def test_gan_train_step_matches_jax(family):
    """One ``gan_train_step`` at lr=0 from one JAX state, with the same batch
    and injected noise: losses 1e-4 relative to max(1, |loss|); Adam's
    moments (the clipped gradients) 1e-3 of each leaf's largest."""
    jcfg, cfg = _configs(family, **STEP_MODEL)
    jtcfg, tcfg = JaxTrainingConfig(**STEP_TRAINING), TrainingConfig(**STEP_TRAINING)
    start = jax.device_get(jax_init_gan_state(0, jcfg, jtcfg))
    batch, noise = _batch_and_noise(10)
    ref_state, ref_metrics = jax.jit(
        lambda s, b, n: jax_gan_train_step(s, b, jnp.float32(0.0), jcfg, jtcfg, noise=n))(
        start, jax.tree.map(jnp.asarray, batch), jax.tree.map(jnp.asarray, noise))
    ref_state = jax.device_get(ref_state)
    state = train_state_from_jax(start, device="cpu")
    _, metrics = gan_train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, 0.0,
                                cfg, tcfg, noise={k: torch.from_numpy(v) for k, v in noise.items()})
    assert set(metrics) == set(ref_metrics)
    for k, v in metrics.items():
        want = float(ref_metrics[k])
        assert abs(v.item() - want) <= 1e-4 * max(1.0, abs(want)), (k, v.item(), want)
    for model in MODELS:
        ref = adam_moments(ref_state[model]["opt"])
        for part in ("mu", "nu"):
            want, got = _paths(ref[part]), _paths(state[model]["opt"][part])
            assert set(want) == set(got)
            for path, leaf in got.items():
                w = np.asarray(want[path])
                np.testing.assert_allclose(leaf.numpy(), w, atol=1e-3 * max(np.abs(w).max(), 1e-30),
                                           err_msg=f"{model} {part}{path}")


@pytest.mark.parametrize("family", FAMILIES)
def test_init_gan_state_builds_the_family(family):
    _, cfg = _configs(family, **STEP_MODEL)
    state = init_gan_state(0, cfg, device="cpu")
    assert generator_family(state["g"]["params"]) == family
    assert all(t.requires_grad for t in _paths(state["g"]["params"]).values())
