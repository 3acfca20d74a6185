"""The plain reference of the models: the BiLSTM and transformer generators
with the monotone time head, the variational encoder and the temporal
spectral-norm critic, written from their published description in plain
float32 torch (no kernel, no cast, no graph), with the parameter layout of
the program's trees (dense weights (in, out), LSTM gates i, f, g, o).

Every product goes through ``Precision.mm`` (and ``Precision.q`` for the
convolutions and attention): float32 for the reference, or its operands
rounded to float8 e4m3 with one scale per tensor for the control, the step
below the bfloat16 the configurations state. Elementwise arithmetic stays
float32 in both. TF32 must be off while these run (``exact_products``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


class Precision:
    """How the products of the reference are computed: "float32" or
    "float8" (each operand scaled by 448 / its largest magnitude, rounded
    to float8 e4m3, scaled back)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "float8"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return x
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = FP8_MAX / amax
        return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)


FLOAT32 = Precision("float32")


@contextlib.contextmanager
def exact_products():
    """float32 products and convolutions without TF32, restored on exit."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = cuda.allow_tf32, cudnn.allow_tf32
    cuda.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = saved


def dense(p: Dict[str, torch.Tensor], x: torch.Tensor, P: Precision) -> torch.Tensor:
    return P.mm(x, p["w"]) + p["b"]


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.2 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of gelu."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


# -- generators ------------------------------------------------------------------------


def _lstm_direction(cell: Dict, x: torch.Tensor, hidden: int, static: Optional[torch.Tensor],
                    reverse: bool, P: Precision) -> torch.Tensor:
    """One direction of one LSTM layer, zero initial state: (B, L, D) → (B, L, H).
    ``static`` (B, S) occupies the last S rows of w_ih."""
    D = x.shape[-1]
    w_ih = cell["w_ih"]
    base = cell["b_ih"] + cell["b_hh"]
    if static is not None:
        base = (base + P.mm(static, w_ih[D:]))[:, None, :]
    gx = P.mm(x, w_ih[:D]) + base
    B, L = x.shape[0], x.shape[1]
    h = x.new_zeros((B, hidden))
    c = x.new_zeros((B, hidden))
    out: List[Optional[torch.Tensor]] = [None] * L
    w_hh = P.q(cell["w_hh"])
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        gates = gx[:, t] + P.q(h) @ w_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[t] = h
    return torch.stack(out, dim=1)


def bilstm(layers: List[Dict], x: torch.Tensor, hidden: int, static: torch.Tensor,
           P: Precision) -> torch.Tensor:
    """Stacked bidirectional LSTM, ``static`` fed to the first layer."""
    h = x
    for k, layer in enumerate(layers):
        s = static if k == 0 else None
        h = torch.cat([_lstm_direction(layer["fwd"], h, hidden, s, False, P),
                       _lstm_direction(layer["bwd"], h, hidden, s, True, P)], dim=-1)
    return h


def time_head(raw: torch.Tensor, pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The monotone head: tanh on (x, y); t the running sum of a softmax
    over the L-1 increment logits (confined to valid increments)."""
    xy = torch.tanh(raw[..., :2])
    logits = raw[..., 1:, 2]
    if pad_mask is not None:
        logits = torch.where(pad_mask[..., 1:] > 0, logits, torch.full_like(logits, -1e30))
    t = torch.cumsum(torch.softmax(logits, dim=-1), dim=-1)
    t = torch.cat([torch.zeros_like(t[..., :1]), t], dim=-1)
    return torch.cat([xy, t[..., None]], dim=-1)


def _head(raw: torch.Tensor, mode: str, pad_mask=None) -> torch.Tensor:
    if mode == "monotone":
        return time_head(raw, pad_mask)
    if mode == "tanh":
        return torch.tanh(raw)
    raise ValueError(f"unknown time head {mode!r}")


def layernorm(p: Dict[str, torch.Tensor], x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _attention(block: Dict, x: torch.Tensor, heads: int, pad_mask, P: Precision) -> torch.Tensor:
    B, L, D = x.shape
    hd = D // heads
    qkv = dense(block["qkv"], x, P).reshape(B, L, 3, heads, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    logits = (P.q(q) @ P.q(k).transpose(-1, -2)) / math.sqrt(hd)
    if pad_mask is not None:
        logits = torch.where(pad_mask[:, None, None, :] > 0, logits,
                             torch.full_like(logits, -1e30))
    out = (P.q(torch.softmax(logits, dim=-1)) @ P.q(v)).transpose(1, 2).reshape(B, L, D)
    return dense(block["attn_out"], out, P)


def generator(params: Dict, proto: torch.Tensor, z: torch.Tensor, model: Dict,
              P: Precision, pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(prototype (B, L, 3), z (B, Z)) → gesture (B, L, 3); the prototype's
    time channel is not seen (``prototype_has_time`` false)."""
    xy = proto[..., :2]
    kind = model["generator_type"]
    if kind == "bilstm":
        h = bilstm(params["lstm"], xy, model["gen_hidden_dim"], z, P)
        return _head(dense(params["out"], h, P), model["time_head"])
    if kind == "transformer":
        B, L = proto.shape[:2]
        tokens = torch.cat([xy, z[:, None, :].expand(B, L, z.shape[-1])], dim=-1)
        h = dense(params["embed"], tokens, P) + params["pos"][None, :L]
        for block in params["blocks"]:
            h = h + _attention(block, layernorm(block["ln1"], h), model["tfm_num_heads"],
                               pad_mask, P)
            h = h + dense(block["mlp2"], gelu(dense(block["mlp1"], layernorm(block["ln2"], h),
                                                    P)), P)
        h = layernorm(params["ln_f"], h)
        return _head(dense(params["out"], h, P), model["time_head"], pad_mask)
    raise ValueError(f"no reference for generator {kind!r}")


# -- encoder -----------------------------------------------------------------------------


def encoder(params: Dict, x: torch.Tensor, eps: torch.Tensor,
            P: Precision) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gesture (B, L, 3) → (z = mu + eps·exp(log_var/2), mu, log_var)."""
    h = x.reshape(x.shape[0], -1)
    for layer in params["mlp"]:
        h = leaky_relu(dense(layer, h, P))
    mu = dense(params["mu"], h, P)
    log_var = dense(params["log_var"], h, P)
    return mu + eps * torch.exp(0.5 * log_var), mu, log_var


# -- temporal critic ---------------------------------------------------------------------

CONV_PADDING = (2, 2, 1)
POOL_BINS = 8


def _l2n(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + 1e-12)


def spectral_normalize(w2d: torch.Tensor, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One power-iteration step, then w / sigma (gradient through sigma
    with respect to w only)."""
    with torch.no_grad():
        v = _l2n(w2d @ u)
        u = _l2n(v @ w2d)
    return w2d / (v @ w2d @ u), u


def critic(params: Dict, us: Dict, x: torch.Tensor,
           P: Precision) -> Tuple[torch.Tensor, List[torch.Tensor], Dict]:
    """(B, L, 3) → (scores (B, 1), features, advanced u's): three
    spectral-norm convolutions (weights (k, in, out)), an 8-bin mean pool
    flattened channel-major, two spectral-norm dense layers, the score."""
    B = x.shape[0]
    new = {"convs": [], "mlp": []}
    h = x
    feats = []
    for p, u, pad in zip(params["convs"], us["convs"], CONV_PADDING):
        w, u = spectral_normalize(p["w"].reshape(-1, p["w"].shape[-1]), u)
        new["convs"].append(u)
        w = w.reshape(p["w"].shape).permute(2, 1, 0)
        h = F.conv1d(P.q(h.transpose(1, 2)), P.q(w), padding=pad).transpose(1, 2) + p["b"]
        h = leaky_relu(h)
        feats.append(h.reshape(B, -1))
    L, C = h.shape[1], h.shape[2]
    h = h.reshape(B, POOL_BINS, L // POOL_BINS, C).mean(dim=2).transpose(1, 2).reshape(B, -1)
    for p, u in zip(params["mlp"], us["mlp"]):
        w, u = spectral_normalize(p["w"], u)
        new["mlp"].append(u)
        h = leaky_relu(P.mm(h, w) + p["b"])
        feats.append(h)
    w, new["out"] = spectral_normalize(params["out"]["w"], us["out"])
    return P.mm(h, w) + params["out"]["b"], feats, new
