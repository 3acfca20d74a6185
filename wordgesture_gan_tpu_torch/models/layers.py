"""Building blocks of the models: dense, LeakyReLU, the compute-dtype cast
view, spectral normalization over an explicit u state, conv1d, batch
normalization over explicit running statistics, LSTM cells and the plain
stacked BiLSTM (the port of the JAX package's
``models/layers.py``).

Weights keep the JAX package's layout — ``dense`` weights are (in, out) and
applied as ``x @ w + b``; LSTM ``w_ih`` is (in, 4H), ``w_hh`` is (H, 4H),
gate order i, f, g, o — so a JAX parameter tree maps onto the modules
without transposes (``interop/from_jax.py``). Initializers are PyTorch's
defaults (U(±1/sqrt(fan)) for linear and LSTM weights), drawn on the CPU
from a JAX-style key (``utils/prng.py``) that each splits as its JAX twin
does, so a key gives the JAX package's initial weights.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import prng

Key = Optional[torch.Tensor]


def _key(key: Key) -> torch.Tensor:
    """``key``, or ``PRNGKey(0)`` for a module whose weights are loaded later."""
    return prng.PRNGKey(0) if key is None else key


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.nn.functional.leaky_relu(x, slope)


def cast_floats(tree, dtype: torch.dtype):
    """The tree with every floating tensor cast to ``dtype``: the compute view
    of float32 weights. ``Tensor.to`` is differentiable and its gradient comes
    back in the source dtype, so gradients and Adam statistics stay float32."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    return tree.to(dtype) if torch.is_floating_point(tree) else tree


def _uniform(key: torch.Tensor, shape, bound: float) -> torch.Tensor:
    """U(-bound, bound) with the bound rounded to float32, as the JAX
    package's ``_uniform`` draws it."""
    return prng.uniform(key, shape, -bound, bound)


# -- spectral normalization ----------------------------------------------------------
#
# One power-iteration step per training forward, W normalized by
# sigma = v^T W u, differentiated through sigma with respect to W but not
# through u or v. u is an explicit state tensor the caller threads through
# (the critics return the advanced u); nothing here mutates it in place.


def _l2n(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + eps)


def spectral_init(fan_out: int, key: Key = None) -> torch.Tensor:
    """Initial left-singular estimate u (fan_out,) of a (fan_in, fan_out) matrix."""
    return _l2n(prng.normal(_key(key), (fan_out,)))


def spectral_normalize(w2d: torch.Tensor, u: torch.Tensor,
                       update: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w2d / sigma, new u) for a (fan_in, fan_out) weight; ``update`` runs
    the power iteration (training), otherwise u is reused."""
    with torch.no_grad():
        v = _l2n(w2d @ u)
        if update:
            u = _l2n(v @ w2d)
    sigma = v @ w2d @ u
    return w2d / sigma, u


def batched_spectral_normalize(ws2d: List[torch.Tensor], us: List[torch.Tensor],
                               update: bool) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """``spectral_normalize`` of every (w2d, u) pair as one batched
    computation: the matrices are zero-padded to a common (fan_in, fan_out)
    and stacked (zero rows and columns add nothing to any product or norm),
    so a critic's power iterations are three batched products instead of a
    chain of small launches per layer."""
    fan_in = max(w.shape[0] for w in ws2d)
    fan_out = max(w.shape[1] for w in ws2d)
    W = torch.stack([F.pad(w, (0, fan_out - w.shape[1], 0, fan_in - w.shape[0]))
                     for w in ws2d])                                            # (n, I, O)
    with torch.no_grad():
        U = torch.stack([F.pad(u, (0, fan_out - u.shape[0])) for u in us])      # (n, O)
        V = _l2n(torch.einsum("nio,no->ni", W, U))
        if update:
            U = _l2n(torch.einsum("ni,nio->no", V, W))
    sigma = (torch.einsum("ni,nio->no", V, W) * U).sum(dim=1)                   # (n,)
    return ([w / sigma[i] for i, w in enumerate(ws2d)],
            [U[i, :u.shape[0]] for i, u in enumerate(us)])


def sn_dense_init(in_dim: int, out_dim: int, key: Key = None):
    """Spectrally normalized dense layer: (params, u)."""
    kp, ku = prng.split(_key(key))
    return dense_init(in_dim, out_dim, kp), spectral_init(out_dim, ku)


def conv1d_init(in_ch: int, out_ch: int, kernel: int, key: Key = None) -> Dict[str, torch.Tensor]:
    """``nn.Conv1d`` default init, U(±1/sqrt(in_ch·kernel)), weight in the JAX
    ``(kernel, in, out)`` (WIO) layout."""
    kw, kb = prng.split(_key(key))
    bound = 1.0 / math.sqrt(in_ch * kernel)
    return {"w": _uniform(kw, (kernel, in_ch, out_ch), bound),
            "b": _uniform(kb, (out_ch,), bound)}


def conv1d(params: Dict[str, torch.Tensor], x: torch.Tensor, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """(B, L, C_in) → (B, L', C_out) with a WIO weight: the JAX layout at the
    interface, PyTorch's (B, C, L) and (out, in, k) inside."""
    w = params["w"].permute(2, 1, 0)
    return F.conv1d(x.transpose(1, 2), w, params["b"], stride=stride,
                    padding=padding).transpose(1, 2)


def sn_conv1d_init(in_ch: int, out_ch: int, kernel: int, key: Key = None):
    """Spectrally normalized conv1d: (params, u); power iteration views the
    kernel as a (kernel·in_ch, out_ch) matrix."""
    kp, ku = prng.split(_key(key))
    return conv1d_init(in_ch, out_ch, kernel, kp), spectral_init(out_ch, ku)


# -- batch normalization ----------------------------------------------------------------
#
# Functional, with the running statistics as an explicit state the caller
# threads through, as the JAX package does.


def batchnorm_init(dim: int) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(params {"scale", "bias"}, state {"mean", "var"}) of a BatchNorm over
    ``dim`` features."""
    params = {"scale": torch.ones(dim), "bias": torch.zeros(dim)}
    state = {"mean": torch.zeros(dim), "var": torch.ones(dim)}
    return params, state


def batchnorm(params: Dict[str, torch.Tensor], state: Dict[str, torch.Tensor], x: torch.Tensor,
              train: bool, momentum: float = 0.1, eps: float = 1e-5,
              mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Normalize over every axis but the last → (out, new state).

    Train mode uses the batch's mean and biased variance and returns running
    statistics advanced with PyTorch's convention, new = (1-m)·old + m·batch,
    the variance term unbiased (n / (n-1)); the new statistics carry no
    gradient. Eval mode uses the running statistics and returns ``state``.

    ``mesh`` with a process group (``parallel/mesh.py``; the counterpart of
    the JAX function's ``axis_name``) makes the moments, the running
    statistics and n those of the global batch, x being this rank's rows: a
    differentiable all-reduce of the sums and the count, then of the squared
    deviations from the global mean (two passes, as the single-process
    variance is computed)."""
    axes = tuple(range(x.ndim - 1))
    if train:
        if mesh is not None and mesh.active:
            from ..parallel.mesh import all_reduce_sum

            sums = all_reduce_sum(mesh, torch.cat([x.sum(dim=axes), x.new_tensor(
                [x.numel() // x.shape[-1]])]))
            n = sums[-1]
            mean = sums[:-1] / n
            var = all_reduce_sum(mesh, ((x - mean) ** 2).sum(dim=axes)) / n
            bessel = n / torch.clamp(n - 1, min=1)
        else:
            mean = x.mean(dim=axes)
            var = x.var(dim=axes, unbiased=False)
            n = x.numel() // x.shape[-1]
            bessel = n / max(n - 1, 1)
        with torch.no_grad():
            unbiased = var * bessel
            new_state = {"mean": (1 - momentum) * state["mean"] + momentum * mean,
                         "var": (1 - momentum) * state["var"] + momentum * unbiased}
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    out = (x - mean) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return out, new_state


def dense_init(in_dim: int, out_dim: int, key: Key = None) -> Dict[str, torch.Tensor]:
    """``nn.Linear`` default init, U(±1/sqrt(in_dim)) for weight and bias,
    in the (in, out) layout."""
    kw, kb = prng.split(_key(key))
    bound = 1.0 / math.sqrt(in_dim)
    return {"w": _uniform(kw, (in_dim, out_dim), bound), "b": _uniform(kb, (out_dim,), bound)}


def lstm_cell_init(in_dim: int, hidden: int, key: Key = None) -> Dict[str, torch.Tensor]:
    """``nn.LSTM`` default init: every tensor U(±1/sqrt(hidden))."""
    k1, k2, k3, k4 = prng.split(_key(key), 4)
    bound = 1.0 / math.sqrt(hidden)
    return {
        "w_ih": _uniform(k1, (in_dim, 4 * hidden), bound),
        "w_hh": _uniform(k2, (hidden, 4 * hidden), bound),
        "b_ih": _uniform(k3, (4 * hidden,), bound),
        "b_hh": _uniform(k4, (4 * hidden,), bound),
    }


class Dense(nn.Module):
    """Linear layer with the JAX layout: ``w`` is (in, out), ``x @ w + b``."""

    def __init__(self, in_dim: int, out_dim: int, key: Key = None):
        super().__init__()
        p = dense_init(in_dim, out_dim, key)
        self.w = nn.Parameter(p["w"])
        self.b = nn.Parameter(p["b"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class LSTMCell(nn.Module):
    """One direction of one LSTM layer: w_ih (in, 4H), w_hh (H, 4H), b_ih, b_hh."""

    def __init__(self, in_dim: int, hidden: int, key: Key = None):
        super().__init__()
        for name, value in lstm_cell_init(in_dim, hidden, key).items():
            setattr(self, name, nn.Parameter(value))

    def params(self) -> Dict[str, torch.Tensor]:
        return {"w_ih": self.w_ih, "w_hh": self.w_hh, "b_ih": self.b_ih, "b_hh": self.b_hh}


class BiLSTM(nn.ModuleList):
    """Stacked bidirectional LSTM weights: ``[k]["fwd" | "bwd"]`` cells; the
    first layer takes ``in_dim`` inputs, later ones the 2H of the layer below.
    Each layer splits (fwd, bwd, rest) off ``key``, as ``bilstm_init`` does."""

    def __init__(self, in_dim: int, hidden: int, num_layers: int, key: Key = None):
        layers = []
        d = in_dim
        key = _key(key)
        for _ in range(num_layers):
            kf, kb, key = prng.split(key, 3)
            layers.append(nn.ModuleDict({"fwd": LSTMCell(d, hidden, kf),
                                         "bwd": LSTMCell(d, hidden, kb)}))
            d = 2 * hidden
        super().__init__(layers)
        self.hidden = hidden

    def params(self) -> List[Dict[str, Dict[str, torch.Tensor]]]:
        """The weights as the list-of-dicts tree the apply functions take."""
        return [{d: layer[d].params() for d in ("fwd", "bwd")} for layer in self]


def _bilstm_layer(layer: Dict, x: torch.Tensor, hidden: int,
                  static: Optional[torch.Tensor]) -> torch.Tensor:
    """Both directions of one layer, advancing together: (B, L, D) → (B, L, 2H).

    ``static`` (B, D_static) is a time-constant input occupying the LAST
    D_static rows of w_ih, projected once into the gate base. The state
    (h, c) is carried in x's dtype, as the JAX scan carries it."""
    D = x.shape[-1]
    B, L = x.shape[0], x.shape[1]
    w_seq = torch.stack([layer["fwd"]["w_ih"][:D], layer["bwd"]["w_ih"][:D]])    # (2, D, 4H)
    w_hh = torch.stack([layer["fwd"]["w_hh"], layer["bwd"]["w_hh"]])             # (2, H, 4H)
    bias = torch.stack([layer["fwd"]["b_ih"] + layer["fwd"]["b_hh"],
                        layer["bwd"]["b_ih"] + layer["bwd"]["b_hh"]])            # (2, 4H)
    if static is not None:
        w_st = torch.stack([layer["fwd"]["w_ih"][D:], layer["bwd"]["w_ih"][D:]])
        base = torch.einsum("bi,dig->dbg", static, w_st) + bias[:, None, :]      # (2, B, 4H)
    else:
        base = bias[:, None, :].expand(2, B, -1)
    xs = torch.stack([x, x.flip(1)])                                             # (2, B, L, D)
    gx = torch.einsum("dblk,dkg->dblg", xs, w_seq)                               # (2, B, L, 4H)
    h = x.new_zeros((2, B, hidden))
    c = x.new_zeros((2, B, hidden))
    outs = []
    for t in range(L):
        gates = base + gx[:, :, t] + torch.bmm(h, w_hh)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    hs = torch.stack(outs, dim=2)                                                # (2, B, L, H)
    return torch.cat([hs[0], hs[1].flip(1)], dim=-1)


def bilstm_apply(layers: List[Dict], x: torch.Tensor, hidden: int,
                 static: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain stacked BiLSTM: (B, L, D) → (B, L, 2H), the port of the JAX
    package's ``bilstm_apply`` (gate order i, f, g, o; zero initial state).

    ``static``: optional (B, D_static) time-constant input to the FIRST layer,
    appended feature-wise after the sequence input — the same as
    concatenating it broadcast along L. The CPU reference of the recurrence;
    the generator's serving path goes through ``ops.bilstm_fused``."""
    h = x
    for i, layer in enumerate(layers):
        h = _bilstm_layer(layer, h, hidden, static if i == 0 else None)
    return h
