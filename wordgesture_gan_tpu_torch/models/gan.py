"""The BiLSTM generator and its output head (the port of the generator half
of the JAX package's ``models/gan.py``; encoder, critics and autoencoder are
not ported yet).

The latent code enters the first LSTM layer as a static input, projected
once, with ``w_ih`` rows ordered [prototype | z] — the same as broadcasting
z along the sequence and concatenating it. The recurrence runs in the
configured compute dtype through ``ops.bilstm_fused``; the output ``dense``
and the time head run in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs import DEFAULT_MODEL_CONFIG, ModelConfig
from ..ops.bilstm_fused import fused_bilstm_fwd
from .layers import BiLSTM, Dense, bilstm_apply

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


class Generator(nn.Module):
    """BiLSTM generator: (prototype (B, L, 3), z (B, Z)) → gesture (B, L, 3).

    Parameter names follow the JAX tree (``lstm.{k}.{fwd,bwd}.{w_ih, w_hh,
    b_ih, b_hh}``, ``out.{w, b}``), in the JAX layout. Weights are float32;
    ``generator`` seeds their PyTorch-default initialization."""

    def __init__(self, config: ModelConfig = DEFAULT_MODEL_CONFIG,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.generator_type != "bilstm":
            raise NotImplementedError(
                f"generator_type={config.generator_type!r} is not ported yet; "
                f"the PyTorch port serves the 'bilstm' generator")
        compute_dtype(config)
        self.config = config
        proto_dim = config.input_dim if config.prototype_has_time else 2
        self.lstm = BiLSTM(proto_dim + config.latent_dim, config.gen_hidden_dim,
                           config.gen_num_layers, generator)
        self.out = Dense(2 * config.gen_hidden_dim, config.input_dim, generator)

    def forward(self, prototype: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        config = self.config
        proto = prototype if config.prototype_has_time else prototype[..., :2]
        dtype = compute_dtype(config)
        layers = self.lstm.params()
        if proto.shape[-1] == 2:
            h = fused_bilstm_fwd(layers, proto, config.gen_hidden_dim, z, dtype=dtype)
        else:
            # A prototype with its time channel: the plain recurrence, with
            # the whole stack cast to the compute dtype (the JAX package's
            # scan path for this option).
            layers = [{d: {k: v.to(dtype) for k, v in layer[d].items()} for d in layer}
                      for layer in layers]
            h = bilstm_apply(layers, proto.to(dtype), config.gen_hidden_dim, static=z.to(dtype))
        return apply_time_head(self.out(h.to(torch.float32)), config.time_head)
