"""The port's bfloat16 arithmetic against the JAX package's, on the CPU.

JAX computes an elementwise op in the array's dtype: a Python constant is
rounded to that dtype first (0.2 is 0.2001953125 in bfloat16), and XLA's CPU
backend rounds after every op of a bfloat16 expression. Its float32 tanh is
a rational approximation with fused multiply-adds, and it fuses a multiply
feeding an add in float32. ``models/layers.py``'s ``gelu`` and
``leaky_relu`` follow those rules op by op; here they are held bit for bit
against ``jax.nn.gelu`` and ``jax.nn.leaky_relu``, forward and gradient.

Then the models at their full widths (``ModelConfig`` defaults: the
4-block transformer with d_model 64, the encoder (192, 96, 48, 32), both
critics) in bfloat16 against the JAX package's, on one batch, with two
bounds: the share of elements more than one bfloat16 ulp (of the JAX value)
away, and the signed mean difference of each channel (over batch and
positions, relative to the mean |JAX value|), its root mean square over
the channels. A systematic rounding difference moves every element of a
channel the same way; rounding flips that compound through the layers do
not. Each test states its bounds and the values measured.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import torch_threads  # noqa: F401  one torch thread per test worker

from wordgesture_gan_tpu.configs import ModelConfig as JaxModelConfig
from wordgesture_gan_tpu.models import gan as jax_gan
from wordgesture_gan_tpu.models import generators as jax_generators
from wordgesture_gan_tpu_torch.configs import ModelConfig
from wordgesture_gan_tpu_torch.models import gan, generators
from wordgesture_gan_tpu_torch.models.layers import gelu, leaky_relu
from wordgesture_gan_tpu_torch.utils.tree import tree_map

DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float32": (torch.float32, jnp.float32)}


def _grid(dtype: str) -> np.ndarray:
    """Every bfloat16 value (both zeros, subnormals, the extremes, infinities,
    NaNs), as float32; for float32 also N(0, 1.5^2) and N(0, 6^2) draws and
    float32's own extremes."""
    every = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    x = every.float().numpy()
    if dtype == "float32":
        rng = np.random.default_rng(0)
        info = np.finfo(np.float32)
        x = np.concatenate([x, rng.normal(0, 1.5, 200_000), rng.normal(0, 6, 100_000),
                            [info.tiny, -info.tiny, info.max, -info.max, info.smallest_subnormal,
                             -info.smallest_subnormal, 1e-4, -1e-4, 3.9e-4, 7.99, -8.0, 20.0,
                             -20.0, 1e30, -1e30]]).astype(np.float32)
    return x


def _jax_fn(name):
    return jax.nn.gelu if name == "gelu" else (lambda v: jax.nn.leaky_relu(v, 0.2))


def _port_fn(name):
    return gelu if name == "gelu" else leaky_relu


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ["gelu", "leaky_relu"])
def test_activation_is_jax_bit_for_bit(name, dtype):
    """Forward and gradient (against a cotangent drawn in numpy) bit-equal to
    JAX's jitted function over the grid, NaN equal to NaN, but for the
    subnormal range, which XLA's CPU backend flushes to zero and PyTorch
    keeps: JAX sees a subnormal input as a zero of its sign (so its
    leaky_relu returns the input unscaled, gradient 1), and turns a
    subnormal result into 0. So the port is evaluated at the input with its
    subnormals flushed, and a value that is subnormal on either side agrees
    within the smallest normal number; everything else is bit-equal.
    Measured: 0 differences outside the subnormal range in all four cases;
    on the bfloat16 grid without the flush 508 gelu and 415 leaky_relu
    forward values differ, each by less than 1.18e-38, and 127 leaky_relu
    gradients. Before the port followed JAX's rules (PyTorch's fused
    ``F.gelu`` and ``F.leaky_relu``, one rounding at the end, float32
    constants) 43.5% of bfloat16 gelu outputs on N(0, 1.5^2) differed, by up
    to 0.0156 and +2.2e-4 on average, and 20.5% of negative leaky_relu
    outputs."""
    tdt, jdt = DTYPES[dtype]
    x = _grid(dtype)
    g = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    y_ref, vjp = jax.vjp(jax.jit(_jax_fn(name)), jnp.asarray(x).astype(jdt))
    (dx_ref,) = vjp(jnp.asarray(g).astype(jdt))
    tiny = float(torch.finfo(tdt).tiny)
    flushed = np.where(np.abs(x) < tiny, np.copysign(0.0, x), x).astype(np.float32)
    xt = torch.from_numpy(flushed).to(tdt).requires_grad_()
    y = _port_fn(name)(xt)
    y.backward(torch.from_numpy(g).to(tdt))
    for got, want in ((y.detach(), y_ref), (xt.grad, dx_ref)):
        got = got.float().numpy()
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
        same = (got.view(np.int32) == want.view(np.int32)) | (np.isnan(got) & np.isnan(want))
        sub = (np.abs(got) < tiny) | (np.abs(want) < tiny)
        assert not (~same & ~sub).any(), x[~same & ~sub][:8]
        assert np.all(np.abs(got[~same] - want[~same]) <= tiny)


def test_leaky_relu_gradient_at_zero_is_one():
    """JAX's ``where(x >= 0, x, slope * x)`` passes the gradient through at
    x = 0 (and -0); PyTorch's ``F.leaky_relu`` gives the slope there."""
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.tensor([0.0, -0.0], dtype=dtype, requires_grad=True)
        leaky_relu(x).sum().backward()
        assert x.grad.tolist() == [1.0, 1.0]
    ref = jax.grad(lambda v: jnp.sum(jax.nn.leaky_relu(v, 0.2)))(jnp.zeros(2, jnp.bfloat16))
    assert np.asarray(ref.astype(jnp.float32)).tolist() == [1.0, 1.0]


# -- the models at full width in bfloat16 -------------------------------------------------

L = 128


def _torch_tree(tree):
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32)), tree)


def _gestures(seed: int, batch: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    g = rng.uniform(-1, 1, (batch, L, 3)).astype(np.float32)
    g[..., 2] = np.sort(rng.uniform(0, 1, (batch, L)), axis=1)
    return g


def _bf16_ulp(y: np.ndarray) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(y), np.finfo(np.float32).tiny)))
    return 2.0 ** (e - 7)


def _stats(pairs, rms_pairs) -> dict:
    """Over (port, JAX) pairs of arrays whose last axis is the channel: the
    share of the elements of ``pairs`` more than one bfloat16 ulp away, and
    over ``rms_pairs`` the RMS over the channels of each channel's signed
    mean difference relative to the mean |JAX value| of its array (the
    largest over the arrays)."""
    far, total, rms = 0, 0, 0.0
    for got, want in pairs:
        d = np.asarray(got, np.float64) - want
        far += int((np.abs(d) > _bf16_ulp(want)).sum())
        total += d.size
    for got, want in rms_pairs:
        d = np.asarray(got, np.float64) - want
        channel = d.reshape(-1, d.shape[-1]).mean(axis=0) / np.abs(want).mean()
        rms = max(rms, float(np.sqrt(np.mean(channel ** 2))))
    return {"share_over_1ulp": far / total, "channel_mean_rms": rms}


def _transformer(monkeypatch, batch: int):
    """The transformer generator through both packages' own apply functions,
    the JAX one unjitted; the residual stream after the last block is read
    where each package passes it (cast to float32, exact) to the final layer
    norm, and compared with the gesture."""
    seen = {}
    jax_ln, port_ln = jax_generators._layernorm, generators._layernorm

    def jax_tap(p, x, eps=1e-5):
        if x.dtype == jnp.float32:
            seen["jax"] = np.asarray(x)
        return jax_ln(p, x, eps)

    def port_tap(p, x, eps=1e-5):
        if x.dtype == torch.float32:
            seen["port"] = x.numpy().copy()
        return port_ln(p, x, eps)

    monkeypatch.setattr(jax_generators, "_layernorm", jax_tap)
    monkeypatch.setattr(generators, "_layernorm", port_tap)
    fields = dict(compute_dtype="bfloat16", time_head="monotone", generator_type="transformer")
    jcfg, cfg = JaxModelConfig(**fields), ModelConfig(**fields)
    params = jax.device_get(jax_gan.generator_init(jax.random.PRNGKey(1), jcfg))
    rng = np.random.default_rng(2)
    proto = rng.uniform(-1, 1, (batch, L, 3)).astype(np.float32)
    z = rng.normal(size=(batch, cfg.latent_dim)).astype(np.float32)
    lengths = rng.integers(12, L + 1, batch)
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.float32)
    ref = jax_generators.transformer_generator_apply(params, proto, z, jcfg, pad_mask=mask)
    with torch.no_grad():
        out = generators.transformer_generator_apply(
            _torch_tree(params), torch.from_numpy(proto), torch.from_numpy(z), cfg,
            pad_mask=torch.from_numpy(mask))
    return [(seen["port"], seen["jax"]), (out.numpy(), np.asarray(ref))]


def _encoder(batch: int):
    fields = dict(compute_dtype="bfloat16")
    jcfg, cfg = JaxModelConfig(**fields), ModelConfig(**fields)
    params = jax.device_get(jax_gan.encoder_init(jax.random.PRNGKey(0), jcfg))
    x = _gestures(3, batch)
    eps = np.random.default_rng(4).normal(size=(batch, cfg.latent_dim)).astype(np.float32)
    ref = jax.jit(lambda p, v, e: jax_gan.encoder_apply(p, v, None, jcfg, eps=e))(params, x, eps)
    with torch.no_grad():
        out = gan.encoder_apply(_torch_tree(params), torch.from_numpy(x), cfg,
                                eps=torch.from_numpy(eps))
    return [(o.numpy(), np.asarray(r)) for o, r in zip(out, ref)]


def _critic(temporal: bool, batch: int):
    fields = dict(compute_dtype="bfloat16", use_temporal_disc=temporal)
    jcfg, cfg = JaxModelConfig(**fields), ModelConfig(**fields)
    params, sn = jax.device_get(jax_gan.disc_init(jax.random.PRNGKey(5), jcfg))
    x = _gestures(6, batch)
    scores, feats, _ = jax.jit(lambda p, s, v: jax_gan.disc_apply(p, s, v, True, jcfg))(
        params, sn, x)
    with torch.no_grad():
        got, got_feats, _ = gan.disc_apply(_torch_tree(params), _torch_tree(sn),
                                           torch.from_numpy(x), True, cfg)
    pairs = [(g.float().numpy(), np.asarray(f.astype(jnp.float32)))
             for g, f in zip(got_feats, feats)]
    return pairs + [(got.numpy(), np.asarray(scores))]


# model: (bound on the share over 1 ulp, bound on the channel-mean RMS)
MODEL_BOUNDS = {
    "transformer": (0.1, 2e-4),
    "encoder": (0.01, 1e-5),
    "mlp_critic": (0.02, 2.5e-4),
    "temporal_critic": (0.02, 5e-4),
}


@pytest.mark.parametrize("model", list(MODEL_BOUNDS))
def test_bf16_model_at_full_width_matches_jax(model, monkeypatch):
    """Bounds as MODEL_BOUNDS. Measured with the port's JAX rules: the
    transformer's residual stream after four blocks 5.2–6.0% of elements over
    one ulp (one op alone: 99.99% bit-equal; XLA's float32 exp and summation
    order flip a bfloat16 rounding now and then and the flips compound) and
    a channel-mean RMS of 6.2–7.4e-5 (B=64, three seeds); the encoder's
    outputs 1.2e-4 and 5.8e-7; the MLP critic 0.53% (its deepest tap 2.4%)
    and 9.1e-5; the temporal critic 0.09% (deepest 4.2%) and 1.7e-4, both
    at B=256. Before (``F.gelu``, ``F.leaky_relu``, a bias fused into the
    convolutions): the transformer 30% and 3.4e-4; the encoder 4.5% and
    1.5e-4; the MLP critic's taps 0.04–16% and 5.2e-4; the temporal
    critic's 7–32% and 1.7e-3."""
    if model == "transformer":
        pairs = _transformer(monkeypatch, batch=64)
    elif model == "encoder":
        pairs = _encoder(batch=256)
    else:
        pairs = _critic(model == "temporal_critic", batch=256)
    for got, want in pairs:
        assert got.shape == want.shape and np.isfinite(got).all()
    # The transformer's bfloat16 stream, the encoder's three outputs, the
    # critics' feature taps and scores; a critic's score (one channel of
    # bfloat16 values near 0.04) counts in the share only.
    share, rms = MODEL_BOUNDS[model]
    pairs = [(got, np.asarray(want, np.float64)) for got, want in pairs]
    if model == "transformer":
        pairs = pairs[:1]
    stats = _stats(pairs, pairs[:-1] if "critic" in model else pairs)
    assert stats["share_over_1ulp"] <= share, stats
    assert stats["channel_mean_rms"] <= rms, stats


def test_conv1d_adds_its_bias_after_rounding_like_jax():
    """The temporal critic's convolution in bfloat16: JAX rounds the
    convolution to bfloat16, then adds the bias and rounds again; a bias
    fused into ``F.conv1d`` rounds once. Bit-equal to JAX's
    ``layers.conv1d`` on a (64, 128, 3) -> 64 convolution, kernel 5."""
    from wordgesture_gan_tpu.models import layers as jax_layers
    from wordgesture_gan_tpu_torch.models import layers

    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (64, L, 3)).astype(np.float32)
    p = {"w": rng.uniform(-0.25, 0.25, (5, 3, 64)).astype(np.float32),
         "b": rng.uniform(-0.25, 0.25, (64,)).astype(np.float32)}
    ref = jax.jit(lambda q, v: jax_layers.conv1d(q, v, padding=2))(
        jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), p),
        jnp.asarray(x).astype(jnp.bfloat16))
    got = layers.conv1d({k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()},
                        torch.from_numpy(x).to(torch.bfloat16), padding=2)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    fused = F.conv1d(torch.from_numpy(x).to(torch.bfloat16).transpose(1, 2),
                     torch.from_numpy(p["w"]).to(torch.bfloat16).permute(2, 1, 0),
                     torch.from_numpy(p["b"]).to(torch.bfloat16), padding=2).transpose(1, 2)
    assert (fused.float().numpy() != np.asarray(ref.astype(jnp.float32))).any()
