"""The WordGesture-GAN models: the generator (BiLSTM, or the MLP and
transformer families of ``models/generators.py``) and its output head,
variational encoder, MLP and temporal (Conv1D) spectral-norm critics — the
port of the JAX package's ``models/gan.py``, with the FID feature
autoencoder.

Every model but the serving ``Generator`` module is an init/apply pair over
an explicit tree of float32 tensors in the JAX layout, so a JAX parameter
tree maps onto it leaf for leaf (``interop/from_jax.py``). Applies run in the
configured compute dtype through a cast view of the weights
(``layers.cast_floats``); heads, scores and losses stay float32.

The latent code enters the first LSTM layer as a static input, projected
once, with ``w_ih`` rows ordered [prototype | z] — the same as broadcasting
z along the sequence and concatenating it. The recurrence runs through
``ops.bilstm_fused`` (undifferentiated) or ``ops.bilstm_train``
(differentiated); the output ``dense`` and the time head run in float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs import DEFAULT_MODEL_CONFIG, ModelConfig
from ..ops.bias import add_bias
from ..ops.bilstm_fused import fused_bilstm_fwd
from ..ops.bilstm_train import bilstm_train_apply
from .generators import (mlp_generator_apply, mlp_generator_init, transformer_generator_apply,
                         transformer_generator_init)
from ..utils import prng
from .layers import (BiLSTM, Dense, Key, _key, batched_spectral_normalize, bilstm_apply,
                     cast_floats, conv1d, dense_init, leaky_relu, sn_conv1d_init, sn_dense_init)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(config: ModelConfig) -> torch.dtype:
    """The configured compute dtype (``ModelConfig.compute_dtype``)."""
    try:
        return _DTYPES[config.compute_dtype]
    except KeyError:
        raise ValueError(f"unknown compute_dtype {config.compute_dtype!r}") from None


def apply_time_head(raw: torch.Tensor, mode: str,
                    pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Output-head activation for a generator's raw (B, L, 3) pre-activations.

    ``mode="tanh"``: tanh on all three channels. ``mode="monotone"``: tanh on
    (x, y); the time channel is the cumsum of a softmax over the L-1
    increment logits (the position-0 logit is unused), so t[0] = 0,
    t[L-1] = 1 and t increases. The softmax runs in float32.

    ``pad_mask`` (B, L), 1 = valid, confines the softmax mass to valid
    increments (increment i is valid iff position i+1 is), so the clock spans
    0 → 1 over the valid segment and stays at 1 through padding."""
    if mode == "tanh":
        return torch.tanh(raw)
    if mode != "monotone":
        raise ValueError(f"unknown time_head mode: {mode!r}")
    xy = torch.tanh(raw[..., :2])
    logits = raw[..., 1:, 2].to(torch.float32)
    if pad_mask is not None:
        logits = torch.where(pad_mask[..., 1:] > 0, logits, torch.full_like(logits, -1e30))
    t = torch.cumsum(torch.softmax(logits, dim=-1), dim=-1)
    t = torch.cat([torch.zeros_like(t[..., :1]), t], dim=-1)
    return torch.cat([xy, t[..., None].to(xy.dtype)], dim=-1)


_FAMILY_INIT = {"mlp": mlp_generator_init, "transformer": transformer_generator_init}


def generator_init(config: ModelConfig = DEFAULT_MODEL_CONFIG, key: Key = None) -> Dict:
    """The generator's parameter tree for ``config.generator_type``, JAX
    layout, PyTorch-default init drawn from ``key`` as the JAX package's
    ``generator_init`` draws it. The BiLSTM's is ``{"lstm": [{"fwd": cell,
    "bwd": cell}, ...], "out": {"w", "b"}}``; "mlp" and "transformer" are
    ``models/generators.py``'s."""
    if config.generator_type in _FAMILY_INIT:
        return _FAMILY_INIT[config.generator_type](config, key)
    return Generator(config, key).tree()


def generator_apply(params: Dict, prototype: torch.Tensor, z: torch.Tensor,
                    config: ModelConfig = DEFAULT_MODEL_CONFIG, *,
                    inference: bool = False,
                    pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(prototype (B, L, 3), z (B, Z)) → gesture (B, L, 3), the port of the JAX
    package's ``generator_apply``, dispatching on ``config.generator_type``.

    ``pad_mask`` (B, L) reaches the transformer only (its attention and time
    head); ``inference`` matters to the BiLSTM only. For the BiLSTM,
    ``inference=True`` marks a forward that is never differentiated
    (serving, the critic loop's fakes): the stack runs through the inference
    kernel (``ops/bilstm_fused.py``), which carries no gradient.
    ``inference=False`` runs the differentiable training pair
    (``ops/bilstm_train.py``), whose backward gives every LSTM weight and z
    their gradients. A prototype with its time channel takes the plain
    recurrence with the stack cast to the compute dtype (the JAX package's
    scan path for that option)."""
    if config.generator_type == "mlp":
        return mlp_generator_apply(params, prototype, z, config)
    if config.generator_type == "transformer":
        return transformer_generator_apply(params, prototype, z, config, pad_mask=pad_mask)
    proto = prototype if config.prototype_has_time else prototype[..., :2]
    dtype = compute_dtype(config)
    layers = params["lstm"]
    if proto.shape[-1] == 2:
        if inference:
            h = fused_bilstm_fwd(layers, proto, config.gen_hidden_dim, z, dtype=dtype)
        else:
            h = bilstm_train_apply(layers, proto, z, config.gen_hidden_dim, dtype=dtype)
    else:
        h = bilstm_apply(cast_floats(layers, dtype), proto.to(dtype), config.gen_hidden_dim,
                         static=z.to(dtype))
    out = params["out"]
    return apply_time_head(add_bias(h.to(torch.float32) @ out["w"], out["b"]), config.time_head)


def _register_tree(module: nn.Module, tree: Dict) -> None:
    """Register a parameter tree on ``module``: a dict becomes a submodule, a
    list an ``nn.ModuleList`` of them, a tensor a parameter, so state-dict
    names are the tree's paths joined by dots (``blocks.0.qkv.w``)."""
    for key, value in tree.items():
        if isinstance(value, dict):
            module.add_module(key, _ParamTree(value))
        elif isinstance(value, (list, tuple)):
            module.add_module(key, nn.ModuleList(_ParamTree(v) for v in value))
        else:
            module.register_parameter(key, nn.Parameter(value))


def _module_tree(module: nn.Module, keys) -> Dict:
    """The tree ``_register_tree`` registered, holding the parameters."""
    out = {}
    for key in keys:
        value = getattr(module, key)
        if isinstance(value, nn.ModuleList):
            out[key] = [v.tree() for v in value]
        elif isinstance(value, _ParamTree):
            out[key] = value.tree()
        else:
            out[key] = value
    return out


class _ParamTree(nn.Module):
    def __init__(self, tree: Dict):
        super().__init__()
        self._keys = tuple(tree)
        _register_tree(self, tree)

    def tree(self) -> Dict:
        return _module_tree(self, self._keys)


class Generator(nn.Module):
    """The serving generator: (prototype (B, L, 3), z (B, Z)) → gesture (B, L, 3).

    It holds the tree of ``config.generator_type``, with parameter names
    following the JAX tree: ``lstm.{k}.{fwd,bwd}.{w_ih, w_hh, b_ih, b_hh}``
    and ``out.{w, b}`` for the BiLSTM; ``mlp.{i}.{w, b}`` and ``out.{w, b}``
    for the MLP; ``embed``, ``pos``, ``blocks.{i}.{ln1, qkv, attn_out, ln2,
    mlp1, mlp2}``, ``ln_f`` and ``out`` for the transformer. Weights are
    float32, drawn from ``key`` (``generator_init``; ``PRNGKey(0)`` when
    None, for a module whose weights are loaded next)."""

    def __init__(self, config: ModelConfig = DEFAULT_MODEL_CONFIG, key: Key = None):
        super().__init__()
        compute_dtype(config)
        self.config = config
        key = prng.PRNGKey(0) if key is None else key
        if config.generator_type in _FAMILY_INIT:
            tree = _FAMILY_INIT[config.generator_type](config, key)
            self._keys = tuple(tree)
            _register_tree(self, tree)
            return
        self._keys = None
        proto_dim = config.input_dim if config.prototype_has_time else 2
        k_lstm, k_out = prng.split(key)
        self.lstm = BiLSTM(proto_dim + config.latent_dim, config.gen_hidden_dim,
                           config.gen_num_layers, k_lstm)
        self.out = Dense(2 * config.gen_hidden_dim, config.input_dim, k_out)

    def tree(self) -> Dict:
        """The parameters as the JAX-layout tree ``generator_apply`` takes."""
        if self._keys is not None:
            return _module_tree(self, self._keys)
        return {"lstm": self.lstm.params(), "out": {"w": self.out.w, "b": self.out.b}}

    def forward(self, prototype: torch.Tensor, z: torch.Tensor, *, inference: bool = False,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``generator_apply`` on this module's parameters; serving passes
        ``inference=True``."""
        return generator_apply(self.tree(), prototype, z, self.config, inference=inference,
                               pad_mask=pad_mask)


# -- variational encoder ----------------------------------------------------------------


def _dense(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return add_bias(x @ p["w"], p["b"])


def encoder_init(config: ModelConfig = DEFAULT_MODEL_CONFIG, key: Key = None) -> Dict:
    """``{"mlp": [dense, ...], "mu": dense, "log_var": dense}``."""
    dims = (config.seq_length * config.input_dim,) + tuple(config.enc_hidden_dims)
    keys = prng.split(_key(key), len(dims) + 1)
    return {
        "mlp": [dense_init(dims[i], dims[i + 1], keys[i]) for i in range(len(dims) - 1)],
        "mu": dense_init(dims[-1], config.latent_dim, keys[-2]),
        "log_var": dense_init(dims[-1], config.latent_dim, keys[-1]),
    }


def encoder_apply(params: Dict, x: torch.Tensor, config: ModelConfig = DEFAULT_MODEL_CONFIG, *,
                  eps: Optional[torch.Tensor] = None, key: Key = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gesture (B, L, 3) → (z, mu, log_var) by the reparameterization trick,
    z = mu + eps·exp(log_var / 2). ``eps`` (B, Z) is injected, or is
    ``normal(key, mu.shape)`` on mu's device. The hidden MLP runs in the compute dtype; the (mu,
    log_var) heads and the reparameterization run in float32."""
    dtype = compute_dtype(config)
    h = x.reshape(x.shape[0], -1).to(dtype)
    for layer in cast_floats(params["mlp"], dtype):
        h = leaky_relu(_dense(layer, h))
    h = h.to(torch.float32)
    mu = _dense(params["mu"], h)
    log_var = _dense(params["log_var"], h)
    if eps is None:
        eps = prng.normal(_key(key).to(mu.device), mu.shape)
    return mu + eps * torch.exp(0.5 * log_var), mu, log_var


# -- critics ------------------------------------------------------------------------------


def mlp_disc_init(config: ModelConfig = DEFAULT_MODEL_CONFIG,
                  key: Key = None) -> Tuple[Dict, Dict]:
    """MLP critic: (params, spectral state)."""
    dims = (config.seq_length * config.input_dim,) + tuple(config.disc_hidden_dims)
    keys = prng.split(_key(key), len(dims))
    layers, us = [], []
    for i in range(len(dims) - 1):
        p, u = sn_dense_init(dims[i], dims[i + 1], keys[i])
        layers.append(p)
        us.append(u)
    out_p, out_u = sn_dense_init(dims[-1], 1, keys[-1])
    return {"layers": layers, "out": out_p}, {"layers": us, "out": out_u}


def mlp_disc_apply(params: Dict, state: Dict, x: torch.Tensor, update_stats: bool,
                   dtype: torch.dtype = torch.float32):
    """(B, L, 3) → (scores (B, 1) float32, features, new spectral state).
    Features are the post-LeakyReLU activations of every hidden layer."""
    layer_ps = list(params["layers"]) + [params["out"]]
    ws, new_us = batched_spectral_normalize([p["w"] for p in layer_ps],
                                            list(state["layers"]) + [state["out"]], update_stats)
    h = x.reshape(x.shape[0], -1).to(dtype)
    features = []
    for p, w in zip(layer_ps[:-1], ws[:-1]):
        h = leaky_relu(add_bias(h @ w.to(dtype), p["b"].to(dtype)))
        features.append(h)
    out = add_bias(h @ ws[-1].to(dtype), layer_ps[-1]["b"].to(dtype))
    return out.to(torch.float32), features, {"layers": new_us[:-1], "out": new_us[-1]}


_TCONV_SPEC = ((3, 64, 5, 2), (64, 64, 5, 2), (64, 32, 3, 1))  # in, out, kernel, padding
_POOL_BINS = 8


def temporal_disc_init(config: ModelConfig = DEFAULT_MODEL_CONFIG,
                       key: Key = None) -> Tuple[Dict, Dict]:
    """Temporal critic: three spectral-norm Conv1D layers, an 8-bin average
    pool, two spectral-norm dense layers and the score head."""
    keys = prng.split(_key(key), 6)
    convs, conv_us = [], []
    for i, (cin, cout, k, _pad) in enumerate(_TCONV_SPEC):
        p, u = sn_conv1d_init(cin, cout, k, keys[i])
        convs.append(p)
        conv_us.append(u)
    m1, u1 = sn_dense_init(_TCONV_SPEC[-1][1] * _POOL_BINS, 128, keys[3])
    m2, u2 = sn_dense_init(128, 64, keys[4])
    out, uo = sn_dense_init(64, 1, keys[5])
    return ({"convs": convs, "mlp": [m1, m2], "out": out},
            {"convs": conv_us, "mlp": [u1, u2], "out": uo})


def temporal_disc_apply(params: Dict, state: Dict, x: torch.Tensor, update_stats: bool,
                        dtype: torch.dtype = torch.float32):
    """(B, L, 3) → (scores (B, 1) float32, features, new spectral state).

    Convolutions take (B, L, C) activations and WIO weights, as the JAX
    package does; the three conv feature taps are flattened in that (L, C)
    order, followed by the two dense activations. The pool averages 8 equal
    chunks of L and is flattened channel-major, as torch's
    ``AdaptiveAvgPool1d`` output is. All six power iterations run as one
    batched computation."""
    B = x.shape[0]
    conv_ps, mlp_ps = params["convs"], params["mlp"]
    n_conv = len(conv_ps)
    ws, new_us = batched_spectral_normalize(
        [p["w"].reshape(-1, p["w"].shape[-1]) for p in conv_ps]
        + [p["w"] for p in mlp_ps] + [params["out"]["w"]],
        list(state["convs"]) + list(state["mlp"]) + [state["out"]], update_stats)

    h = x.to(dtype)
    features = []
    for p, w, (_cin, _cout, _k, pad) in zip(conv_ps, ws[:n_conv], _TCONV_SPEC):
        h = leaky_relu(conv1d({"w": w.reshape(p["w"].shape).to(dtype), "b": p["b"].to(dtype)},
                              h, padding=pad))
        features.append(h.reshape(B, -1))
    L, C = h.shape[1], h.shape[2]
    pooled = h.reshape(B, _POOL_BINS, L // _POOL_BINS, C).mean(dim=2)           # (B, 8, C)
    h2 = pooled.transpose(1, 2).reshape(B, -1)                                  # channel-major
    for p, w in zip(mlp_ps, ws[n_conv:-1]):
        h2 = leaky_relu(add_bias(h2 @ w.to(dtype), p["b"].to(dtype)))
        features.append(h2)
    out = add_bias(h2 @ ws[-1].to(dtype), params["out"]["b"].to(dtype))
    return out.to(torch.float32), features, {"convs": new_us[:n_conv],
                                              "mlp": new_us[n_conv:-1], "out": new_us[-1]}


def disc_init(config: ModelConfig = DEFAULT_MODEL_CONFIG,
              key: Key = None) -> Tuple[Dict, Dict]:
    """The critic ``config.use_temporal_disc`` selects: (params, spectral state)."""
    if config.use_temporal_disc:
        return temporal_disc_init(config, key)
    return mlp_disc_init(config, key)


def disc_apply(params: Dict, state: Dict, x: torch.Tensor, update_stats: bool,
               config: ModelConfig = DEFAULT_MODEL_CONFIG):
    """The configured critic in the configured compute dtype."""
    dtype = compute_dtype(config)
    if config.use_temporal_disc:
        return temporal_disc_apply(params, state, x, update_stats, dtype=dtype)
    return mlp_disc_apply(params, state, x, update_stats, dtype=dtype)


# -- FID feature autoencoder ----------------------------------------------------------------

_AE_DIMS = (192, 96, 48)


def autoencoder_init(config: ModelConfig = DEFAULT_MODEL_CONFIG, hidden_dim: int = 32,
                     positional: bool = False, key: Key = None) -> Dict:
    """FID feature autoencoder: ``{"enc": [dense, ...], "post_pool": dense,
    "pre_expand": dense, "dec": [dense, ...]}``.

    ``positional=False`` is the paper's architecture: its decoder broadcasts
    the latent identically to every timestep, so it can only emit a constant
    trace and its features only encode a gesture's central point.
    ``positional=True`` concatenates a [-1, 1] time ramp to the decoder's
    per-timestep input, so the encoder must embed the gesture's shape; same
    encoder and feature dimensionality. The mode is recoverable from the
    parameters (the first decoder layer's fan-in)."""
    enc_dims = (config.input_dim,) + _AE_DIMS + (hidden_dim,)
    dec_in = hidden_dim + (1 if positional else 0)
    dec_dims = (dec_in,) + _AE_DIMS[::-1] + (config.input_dim,)
    ki = iter(prng.split(_key(key), len(enc_dims) + len(dec_dims)))
    return {
        "enc": [dense_init(enc_dims[i], enc_dims[i + 1], next(ki))
                for i in range(len(enc_dims) - 1)],
        "post_pool": dense_init(hidden_dim, hidden_dim, next(ki)),
        "pre_expand": dense_init(hidden_dim, hidden_dim, next(ki)),
        "dec": [dense_init(dec_dims[i], dec_dims[i + 1], next(ki))
                for i in range(len(dec_dims) - 1)],
    }


def autoencoder_encode(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """(B, L, 3) → (B, hidden): per-timestep MLP, mean-pool over the
    sequence, then a linear head."""
    h = x
    for i, layer in enumerate(params["enc"]):
        h = _dense(layer, h)
        if i < len(params["enc"]) - 1:
            h = leaky_relu(h)
    return _dense(params["post_pool"], h.mean(dim=1))


def autoencoder_decode(params: Dict, z: torch.Tensor, seq_length: int) -> torch.Tensor:
    """(B, hidden) → (B, L, 3): the latent broadcast along the sequence
    (joined by the time ramp in positional mode), a per-timestep MLP, tanh."""
    h = _dense(params["pre_expand"], z)
    h = h[:, None, :].expand(h.shape[0], seq_length, h.shape[1])
    if params["dec"][0]["w"].shape[0] == h.shape[-1] + 1:
        ramp = torch.linspace(-1.0, 1.0, seq_length, dtype=h.dtype, device=h.device)
        h = torch.cat([h, ramp[None, :, None].expand(h.shape[0], seq_length, 1)], dim=-1)
    for i, layer in enumerate(params["dec"]):
        h = _dense(layer, h)
        if i < len(params["dec"]) - 1:
            h = leaky_relu(h)
    return torch.tanh(h)


def autoencoder_apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    return autoencoder_decode(params, autoencoder_encode(params, x), x.shape[1])
