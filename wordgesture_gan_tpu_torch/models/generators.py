"""The two other generator families: MLP and transformer (the port of the JAX
package's ``models/generators.py``).

* ``mlp`` — the flattened prototype and z through a dense stack.
* ``transformer`` — pre-LN encoder blocks over the L trace tokens with learned
  positions; an optional padding mask (B, L) masks the attention, which is
  what variable-length training uses (``train/masked_step.py``).

Both share the generator contract ``apply(params, prototype (B, L, 3),
z (B, Z)) → gesture (B, L, 3)`` and are init/apply pairs over trees of
float32 tensors in the JAX layout, like the rest of ``models/``. Their bias
adds run ``csrc/bias.cu`` on the card (``ops/bias.py``, the transformer's
residual adds folded into them); the other hand-written kernels they reach
are the transformer's attention core and its layer norms, which on the card
run ``csrc/attention.cu`` (``ops/attention.py``) and ``csrc/layernorm.cu``
(``ops/layernorm.py``) and on the CPU the plain chains (explicit products,
not ``scaled_dot_product_attention``; the norm op by op), so that their
precision and the padding rule are the JAX package's.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..configs import DEFAULT_MODEL_CONFIG, ModelConfig
from ..ops.attention import attention
from ..ops.bias import add_bias
from ..ops.layernorm import layernorm
from ..utils import prng
from .layers import Key, _key, cast_floats, dense_init, gelu, leaky_relu


def _proto_dim(config: ModelConfig) -> int:
    return config.input_dim if config.prototype_has_time else 2


def _dense(p: Dict[str, torch.Tensor], x: torch.Tensor,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w + b``, and with ``residual`` ``residual + (x @ w + b)``, the
    adds in one pass on the card (``ops/bias.py``)."""
    return add_bias(x @ p["w"], p["b"], residual)


def _compute_dtype(config: ModelConfig) -> torch.dtype:
    from .gan import compute_dtype

    return compute_dtype(config)


# -- MLP generator --------------------------------------------------------------------------


def mlp_generator_init(config: ModelConfig = DEFAULT_MODEL_CONFIG, key: Key = None) -> Dict:
    """``{"mlp": [dense, ...], "out": dense}``, PyTorch-default init."""
    in_dim = config.seq_length * _proto_dim(config) + config.latent_dim
    dims = (in_dim,) + tuple(config.mlp_gen_hidden_dims)
    keys = prng.split(_key(key), len(dims))
    return {
        "mlp": [dense_init(dims[i], dims[i + 1], keys[i]) for i in range(len(dims) - 1)],
        "out": dense_init(dims[-1], config.seq_length * config.input_dim, keys[-1]),
    }


def mlp_generator_apply(params: Dict, prototype: torch.Tensor, z: torch.Tensor,
                        config: ModelConfig = DEFAULT_MODEL_CONFIG) -> torch.Tensor:
    """The prototype flattened row-major ([x0, y0, x1, y1, ...]) joined by z,
    the hidden stack in the compute dtype, the output layer and the time
    head in float32."""
    from .gan import apply_time_head

    B, L = prototype.shape[:2]
    proto = prototype if config.prototype_has_time else prototype[..., :2]
    dtype = _compute_dtype(config)
    h = torch.cat([proto.reshape(B, -1), z], dim=-1).to(dtype)
    for layer in cast_floats(params["mlp"], dtype):
        h = leaky_relu(_dense(layer, h))
    out = _dense(params["out"], h.to(torch.float32))
    return apply_time_head(out.reshape(B, L, config.input_dim), config.time_head)


# -- transformer generator ------------------------------------------------------------------


def _layernorm_init(dim: int) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def _layernorm(params: Dict[str, torch.Tensor], x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Moments in float32 (population variance), the normalized value cast
    back to x's dtype before the scale and bias, which apply in that dtype:
    the card's kernels or ``plain_layernorm`` (``ops/layernorm.py``)."""
    return layernorm(x, params["scale"], params["bias"], eps)


def _block_init(d_model: int, mlp_dim: int, key: torch.Tensor) -> Dict:
    k = prng.split(key, 6)
    return {
        "ln1": _layernorm_init(d_model),
        "qkv": dense_init(d_model, 3 * d_model, k[0]),
        "attn_out": dense_init(d_model, d_model, k[1]),
        "ln2": _layernorm_init(d_model),
        "mlp1": dense_init(d_model, mlp_dim, k[2]),
        "mlp2": dense_init(mlp_dim, d_model, k[3]),
    }


def transformer_generator_init(config: ModelConfig = DEFAULT_MODEL_CONFIG,
                               key: Key = None) -> Dict:
    """``{"embed", "pos" (L, d), "blocks": [...], "ln_f", "out"}``; positions
    N(0, 0.02²), layer norms at identity, dense layers PyTorch-default."""
    d = config.tfm_d_model
    keys = prng.split(_key(key), config.tfm_num_layers + 3)
    return {
        "embed": dense_init(_proto_dim(config) + config.latent_dim, d, keys[0]),
        "pos": prng.normal(keys[1], (config.seq_length, d)) * 0.02,
        "blocks": [_block_init(d, config.tfm_mlp_ratio * d, keys[2 + i])
                   for i in range(config.tfm_num_layers)],
        "ln_f": _layernorm_init(d),
        "out": dense_init(d, config.input_dim, keys[-1]),
    }


def plain_attention(qkv: torch.Tensor, pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The attention core op by op, as the JAX package writes it: (B, L, 3,
    H, h) projections to (B, L, H * h). The logits are exact float32
    products of q and k (widened before the product, as JAX's
    ``preferred_element_type`` gives them) over sqrt(head); padding keys get
    -1e30, so an all-padding row is a uniform softmax and stays finite. The
    weights are cast to v's dtype, and the second product runs in it. The
    CPU's path and the oracle of the card's kernels (``ops/attention.py``)."""
    B, L, _, H, head = qkv.shape
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))                 # (B, H, L, h)
    logits = (q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2)) / math.sqrt(head)
    if pad_mask is not None:
        logits = torch.where(pad_mask[:, None, None, :] > 0, logits, -1e30)
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    return (attn @ v).transpose(1, 2).reshape(B, L, H * head)


def _attention(block: Dict, x: torch.Tensor, num_heads: int, pad_mask: Optional[torch.Tensor],
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head self-attention: the projections, the core (the card's
    kernels or ``plain_attention``), the output projection; ``residual``,
    when given, is added in the output projection's bias add."""
    B, L, D = x.shape
    qkv = _dense(block["qkv"], x).reshape(B, L, 3, num_heads, D // num_heads)
    return _dense(block["attn_out"], attention(qkv, pad_mask, plain_attention), residual)


def transformer_generator_apply(params: Dict, prototype: torch.Tensor, z: torch.Tensor,
                                config: ModelConfig = DEFAULT_MODEL_CONFIG,
                                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pre-LN transformer encoder over the trace tokens, each token the
    prototype point joined by z. Every block parameter and the positions run
    in the compute dtype; the final layer norm, the output layer and the
    time head run in float32 on the float32 parameters. ``pad_mask`` (B, L),
    1 = valid, masks the attention and the monotone time head; padding
    positions still emit outputs, which consumers mask."""
    from .gan import apply_time_head

    B, L = prototype.shape[:2]
    proto = prototype if config.prototype_has_time else prototype[..., :2]
    dtype = _compute_dtype(config)
    p = cast_floats({k: params[k] for k in ("embed", "pos", "blocks")}, dtype)
    tokens = torch.cat([proto, z[:, None, :].expand(B, L, z.shape[-1])], dim=-1)
    # A tuple index: a slice of the whole table is an alias, whose backward
    # launches nothing (``pos[:L]`` alone would zero and copy a table).
    h = add_bias(_dense(p["embed"], tokens.to(dtype)), p["pos"][:L, :])
    for block in p["blocks"]:
        h = _attention(block, _layernorm(block["ln1"], h), config.tfm_num_heads, pad_mask, h)
        m = _dense(block["mlp1"], _layernorm(block["ln2"], h))
        h = _dense(block["mlp2"], gelu(m), h)
    h = _layernorm(params["ln_f"], h.to(torch.float32))
    return apply_time_head(_dense(params["out"], h), config.time_head, pad_mask=pad_mask)
