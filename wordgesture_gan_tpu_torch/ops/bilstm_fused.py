"""Fused whole-stack BiLSTM inference forward: the wrapper of the CUDA kernel
``csrc/bilstm_fused.cu``, its plain PyTorch version, and the weight layout
the kernel reads.

Port of the JAX package's ``ops/bilstm_fused.py`` (the Pallas TPU kernel
``_kernel``, launched by ``_fused_call``, wrapped by ``fused_bilstm_fwd``).
It computes the generator's stacked bidirectional LSTM — all layers, both
directions — for a 2-d prototype input and a time-constant latent that
enters layer 1 as a static input (``w_ih`` rows ordered [proto | z]).

Casting contract (the fused kernel's, not the plain scan's): gate sums,
nonlinearities and the cell state are float32; h is rounded to the compute
dtype every step; the layer-1 latent projection is float32 from float32
weights and z; sequence and recurrent weights are rounded to the compute
dtype, biases stay float32. The kernel's source note says what bounds it on
an H100 and how it is laid out.

Dispatch: tensors on the CPU take ``fused_bilstm_fwd_plain``; tensors on a
CUDA device launch the kernel, and a build or launch failure raises. There
is no other path. Inference only: nothing here is differentiated.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List

import torch

KERNEL = "bilstm_fused"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _gate_layout(w_fwd: torch.Tensor, w_bwd: torch.Tensor, hidden: int) -> torch.Tensor:
    """Two (rows, 4H) direction weights → (rows, 2, H, 4): the i, f, g, o
    weights of one hidden unit contiguous, as the kernel loads them."""
    w = torch.stack([w_fwd, w_bwd], dim=1)                         # (rows, 2, 4H)
    return w.reshape(w.shape[0], 2, 4, hidden).transpose(2, 3)     # (rows, 2, H, 4)


def kernel_weights(layers: List[Dict], hidden: int, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The stack's weights in the kernel's layout and types (see the shapes
    listed in ``csrc/bilstm_fused.cu``)."""
    l0 = layers[0]
    fwd = [layer["fwd"] for layer in layers]
    bwd = [layer["bwd"] for layer in layers]
    bias = torch.stack([
        _gate_layout((f["b_ih"] + f["b_hh"])[None], (b["b_ih"] + b["b_hh"])[None], hidden)[0]
        for f, b in zip(fwd, bwd)])
    whh = torch.stack([_gate_layout(f["w_hh"], b["w_hh"], hidden) for f, b in zip(fwd, bwd)])
    if len(layers) > 1:
        wih = torch.stack([_gate_layout(f["w_ih"], b["w_ih"], hidden)
                           for f, b in zip(fwd[1:], bwd[1:])])
    else:
        wih = whh.new_zeros((1,))   # never read by a one-layer stack
    return {
        "wseq1": _gate_layout(l0["fwd"]["w_ih"][:2], l0["bwd"]["w_ih"][:2], hidden).to(dtype).contiguous(),
        "wz": _gate_layout(l0["fwd"]["w_ih"][2:], l0["bwd"]["w_ih"][2:], hidden).float().contiguous(),
        "whh": whh.to(dtype).contiguous(),
        "wih": wih.to(dtype).contiguous(),
        "bias": bias.float().contiguous(),
    }


def fused_bilstm_fwd_plain(layers: List[Dict], x: torch.Tensor, hidden: int,
                           static: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with the same casting contract:
    (B, L, 2) prototype + static (B, Z) → (B, L, 2H) in ``dtype``.

    Every product is taken in float32 between operands already rounded to
    ``dtype``, as the kernel takes them; only the order of the sums differs."""
    return plain_stack(layers, x, hidden, static, dtype)[0]


def plain_stack(layers: List[Dict], x: torch.Tensor, hidden: int, static: torch.Tensor,
                dtype: torch.dtype, residuals: bool = False):
    """The stack's recurrence under the fused casting contract: returns the
    (B, L, 2H) output in ``dtype`` and, if ``residuals``, the training
    forward's residual rows (layers, 2, L, B, 6H) in ``dtype`` — per (layer,
    direction, position) the planes [h | c | i | f | g | o] after the
    nonlinearities (``ops/bilstm_train.py``), else None."""
    f32 = torch.float32
    H = hidden
    B, L, _ = x.shape

    def q(t):   # round to the compute dtype, compute in float32
        return t.to(dtype).to(f32)

    l0 = layers[0]
    static = static.to(f32)
    wseq1 = torch.stack([q(l0[d]["w_ih"][:2]) for d in ("fwd", "bwd")])          # (2, 2, 4H)
    base1 = torch.stack([static @ l0[d]["w_ih"][2:].to(f32) + l0[d]["b_ih"] + l0[d]["b_hh"]
                         for d in ("fwd", "bwd")])                                # (2, B, 4H)
    p = q(x)                                                                      # (B, L, 2)
    res = x.new_empty((len(layers), 2, L, B, 6 * H), dtype=dtype) if residuals else None
    prev = None
    for k, layer in enumerate(layers):
        whh = torch.stack([q(layer[d]["w_hh"]) for d in ("fwd", "bwd")])          # (2, H, 4H)
        if k == 0:
            gx = (base1[:, :, None, :]
                  + wseq1[:, None, None, 0, :] * p[None, :, :, 0:1]
                  + wseq1[:, None, None, 1, :] * p[None, :, :, 1:2])             # (2, B, L, 4H)
        else:
            wih = torch.stack([q(layer[d]["w_ih"]) for d in ("fwd", "bwd")])      # (2, 2H, 4H)
            bias = torch.stack([(layer[d]["b_ih"] + layer[d]["b_hh"]).to(f32)
                                for d in ("fwd", "bwd")])                         # (2, 4H)
            gx = torch.einsum("blk,dkg->dblg", prev, wih) + bias[:, None, None, :]
        gx = torch.stack([gx[0], gx[1].flip(1)])      # backward direction reads time reversed
        h = x.new_zeros((2, B, H), dtype=f32)
        c = x.new_zeros((2, B, H), dtype=f32)
        outs, rows = [], []
        for t in range(L):
            gates = gx[:, :, t] + torch.bmm(h, whh)
            i, f, g, o = gates.chunk(4, dim=-1)
            i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
            c = f * c + i * g
            h = q(o * torch.tanh(c))
            outs.append(h)
            if residuals:
                rows.append(torch.cat([h, c, i, f, g, o], dim=-1).to(dtype))      # (2, B, 6H)
        hs = torch.stack(outs, dim=2)                                             # (2, B, L, H)
        prev = torch.cat([hs[0], hs[1].flip(1)], dim=-1)                          # (B, L, 2H)
        if residuals:
            steps = torch.stack(rows, dim=1)                                      # (2, L, B, 6H)
            res[k, 0] = steps[0]
            res[k, 1] = steps[1].flip(0)          # step order → position order
    return prev.to(dtype), res


def _check(layers: List[Dict], x: torch.Tensor, hidden: int, static: torch.Tensor,
           dtype: torch.dtype) -> None:
    if x.dim() != 3 or x.shape[-1] != 2:
        raise ValueError(f"prototype must be (B, L, 2), got {tuple(x.shape)}")
    if static.dim() != 2 or static.shape[0] != x.shape[0]:
        raise ValueError(f"static must be (B, Z) with B={x.shape[0]}, got {tuple(static.shape)}")
    if layers[0]["fwd"]["w_ih"].shape[0] != 2 + static.shape[1]:
        raise ValueError("layer-1 w_ih rows must be [prototype (2) | static (Z)]")
    if layers[0]["fwd"]["w_hh"].shape != (hidden, 4 * hidden):
        raise ValueError(f"w_hh must be (H, 4H) with H={hidden}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library (built at first use) with its C signatures declared."""
    from .build import load

    lib = load(KERNEL)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wgg_bilstm_fused_fwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.wgg_bilstm_fused_fwd.restype = i
    lib.wgg_cuda_error_string.argtypes = [i]
    lib.wgg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(layers: List[Dict], x: torch.Tensor, hidden: int, static: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    lib = _library()
    device = x.device
    B, L, _ = x.shape
    w = kernel_weights(layers, hidden, dtype)
    for name, t in [("static", static), *w.items()]:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the prototype on {device}")
    proto = x.to(dtype).contiguous()
    z = static.to(torch.float32).contiguous()
    out = torch.empty((B, L, 2 * hidden), dtype=dtype, device=device)
    scratch = torch.empty_like(out) if len(layers) > 1 else out
    args = [proto, z, w["wseq1"], w["wz"], w["whh"], w["wih"], w["bias"], out, scratch]
    if any(t.data_ptr() % 16 for t in args):
        raise ValueError("kernel operands must be 16-byte aligned")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.wgg_bilstm_fused_fwd(*[t.data_ptr() for t in args], B, L, hidden,
                                       static.shape[1], len(layers), _DTYPE_CODES[dtype], stream)
    if err:
        raise RuntimeError(f"bilstm_fused kernel launch failed: "
                           f"{lib.wgg_cuda_error_string(err).decode()} (cudaError {err})")
    fused_bilstm_fwd.launches += 1
    return out


def fused_bilstm_fwd(layers: List[Dict], x: torch.Tensor, hidden: int,
                     static: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inference-only fused BiLSTM stack: (B, L, 2) + static (B, Z) → (B, L, 2H)
    in ``dtype``, any B >= 1.

    ``layers`` is the JAX-layout tree ``[k]["fwd" | "bwd"]["w_ih" | "w_hh" |
    "b_ih" | "b_hh"]`` (``BiLSTM.params()``). A CUDA ``x`` launches the kernel
    (``fused_bilstm_fwd.launches`` counts the launches); a CPU ``x`` runs
    ``fused_bilstm_fwd_plain``."""
    _check(layers, x, hidden, static, dtype)
    with torch.no_grad():
        if x.device.type == "cpu":
            return fused_bilstm_fwd_plain(layers, x, hidden, static, dtype)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        return _launch(layers, x, hidden, static, dtype)


fused_bilstm_fwd.launches = 0
