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

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import activations
from ..ops.bias import add_bias
from ..utils import prng

Key = Optional[torch.Tensor]


def _key(key: Key) -> torch.Tensor:
    """``key``, or ``PRNGKey(0)`` for a module whose weights are loaded later."""
    return prng.PRNGKey(0) if key is None else key


@contextlib.contextmanager
def jax_products():
    """Products as the JAX package computes them, for the code run inside:
    float32 matrix products and convolutions in float32 (PyTorch lets cuDNN
    run a float32 convolution in TF32 by default, 3e-4 relative), bfloat16
    products summed in float32 (cuBLAS may otherwise keep a reduction in
    bfloat16). Sets the three PyTorch flags and restores them on exit; a
    flag is read when an op is launched, so a step that runs inside it,
    backward and CUDA-graph capture included, takes these products."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = cuda.allow_tf32, cuda.allow_bf16_reduced_precision_reduction, cudnn.allow_tf32
    cuda.allow_tf32 = cuda.allow_bf16_reduced_precision_reduction = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cuda.allow_tf32, cuda.allow_bf16_reduced_precision_reduction, cudnn.allow_tf32 = saved


# -- elementwise activations in JAX's arithmetic ------------------------------------------
#
# JAX computes an elementwise op in the array's dtype: a Python constant is
# first rounded to that dtype (0.2 is 0.2001953125 in bfloat16), and XLA's
# CPU backend rounds after every op of a bfloat16 expression. PyTorch
# multiplies a bfloat16 tensor by a Python float in float32 and rounds once,
# and its fused activations round once at the end. The plain activations
# below (``plain_gelu``, ``plain_leaky_relu``) are written op by op with the
# constants in x's dtype, so each op rounds where JAX's does. They are what
# the CPU runs and the reference of the CUDA kernels (``ops/activations.py``),
# which compute the same chain in one pass and equal them bit for bit;
# ``gelu`` and ``leaky_relu`` take the kernels for a CUDA tensor (bfloat16 or
# float32) and the plain functions for a CPU tensor.


def _in_dtype(c: float, dtype: torch.dtype) -> float:
    """The Python float ``c`` rounded to ``dtype``, as JAX casts a weakly
    typed constant to the array's dtype."""
    return torch.tensor(c, dtype=dtype).item()


def plain_leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """``jax.nn.leaky_relu`` op by op: x where x >= 0, else x times the
    slope in x's dtype; its gradient at 0 is 1, as JAX's is."""
    return torch.where(x >= 0, x, x * _in_dtype(slope, x.dtype))


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """``jax.nn.leaky_relu``: ``plain_leaky_relu``'s bits, through the CUDA
    kernels where they take ``x``."""
    return activations.leaky_relu(x, _in_dtype(slope, x.dtype), plain_leaky_relu)


# XLA's CPU tanh for float32 (the rational approximation its LLVM backend
# emits, with the multiply-adds of both polynomials fused): torch's float32
# tanh differs from it in the last 1-5 ulp of over half of all inputs. In
# bfloat16 torch's tanh rounds to JAX's value for every one of the 65,536
# inputs, so only float32 takes this path.
_TANH_CLAMP = 7.99881172180175781
_TANH_SMALL = 0.0004
_TANH_NUM = (-2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
             5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
             4.89352455891786e-03)
_TANH_DEN = (1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
             4.89352518554385e-03)


def _poly(x2: torch.Tensor, coeffs) -> torch.Tensor:
    p = prng.fma(x2, coeffs[0], coeffs[1])
    for c in coeffs[2:]:
        p = prng.fma(x2, p, c)
    return p


def _tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh as JAX's CPU backend computes it in x's dtype."""
    if x.dtype != torch.float32:
        return torch.tanh(x)
    xc = x.clamp(-_TANH_CLAMP, _TANH_CLAMP)
    x2 = xc * xc
    r = xc * _poly(x2, _TANH_NUM) / _poly(x2, _TANH_DEN)
    r = torch.where(x.abs() < _TANH_SMALL, x, r)
    return torch.where(x.abs() >= 20, torch.copysign(torch.ones_like(x), x), r)


def _fused(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c as XLA computes it in a's dtype: one fused rounding in
    float32 (its CPU backend contracts the pair), two in bfloat16 (the
    product is rounded before the add)."""
    return prng.fma(a, b, c) if a.dtype == torch.float32 else a * b + c


class _Gelu(torch.autograd.Function):
    """``jax.nn.gelu(x, approximate=True)`` and its JAX gradient, op by op:
    the forward 0.5·x·(1 + tanh(c2·(x + c1·x³))) and the backward JAX's
    transposed JVP, each op in x's dtype with the constants c1 = 0.044715
    and c2 = sqrt(2/π) rounded to it."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * _Gelu.cdf(x)[0]

    @staticmethod
    def cdf(x):
        c1, c2 = _Gelu.constants(x.dtype)
        xx = x * x
        t = _tanh(_fused(xx * x, c1, x) * c2)
        return (t + 1.0) * 0.5, t, xx

    @staticmethod
    def constants(dtype):
        return _in_dtype(0.044715, dtype), _in_dtype(math.sqrt(2 / math.pi), dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        c1, c2 = _Gelu.constants(x.dtype)
        cdf, t, xx = _Gelu.cdf(x)
        p = (x * g) * 0.5 * (1.0 - t)
        r = _fused(p, t, p)                       # the tanh's JVP, (p + p·t)
        s = r * c2
        if x.dtype == torch.float32:
            # XLA folds c2·c1 into one constant and fuses the two adds.
            u = r * _in_dtype(c2 * c1, x.dtype)
            return prng.fma(u, xx * 3.0, prng.fma(g, cdf, s))
        return (g * cdf + s) + (s * c1) * (xx * 3.0)


def plain_gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh approximation, JAX's default) op by op, bit
    for bit in float32 and bfloat16 on the CPU, gradient included."""
    return _Gelu.apply(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``: ``plain_gelu``'s bits, through the CUDA kernels where
    they take ``x``."""
    return activations.gelu(x, plain_gelu)


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
    interface, PyTorch's (B, C, L) and (out, in, k) inside. The bias is
    added after the convolution has rounded to x's dtype, as JAX adds it
    (a bias fused into the convolution rounds once in bfloat16)."""
    w = params["w"].permute(2, 1, 0)
    out = F.conv1d(x.transpose(1, 2), w, stride=stride, padding=padding).transpose(1, 2)
    return add_bias(out, params["b"])


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
        return add_bias(x @ self.w, self.b)


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
