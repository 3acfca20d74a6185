"""The transformer generator's layer norm: the plain op chain, the wrapper of
the CUDA kernels in ``csrc/layernorm.cu``, and the dispatch between them.

``plain_layernorm`` is the JAX package's ``_layernorm`` op by op: moments in
float32 (population variance), the normalized value cast back to x's dtype
before the scale and bias, which apply in that dtype. It is the CPU's path
and the card's oracle. A CUDA tensor takes the kernels: one launch forward
and two backward (dx, dscale and dbias), in the chain's arithmetic; only
the sums run in another order (``csrc/layernorm.cu`` says where they round).
They take bfloat16 and float32 and a last dimension D up to ``MAX_DIM``;
another dtype or D on the card raises ValueError. Rows are read contiguous
in the last dimension: another input is copied first. The kernels launch on
the current stream, synchronise nothing and allocate through PyTorch's
caching allocator, so a captured CUDA graph records them; their sums run in
a fixed order, so two launches give the same bits.

``layernorm_launches.launches_by_path`` counts by direction and path,
``(op, "cuda" | "plain")`` for op in ``OPS``: the card's calls (an empty
tensor launches none) and the plain calls; ``.launches`` counts the card's
kernel launches (one a forward, two a backward). A replayed CUDA graph adds
what its capture counted (``train/step_graph.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

KERNEL = "layernorm"
OPS = ("layernorm_fwd", "layernorm_bwd")     # csrc/layernorm.cu's op codes, in order
PATHS = ("cuda", "plain")
MAX_DIM = 1024
_OP_CODES = {op: i for i, op in enumerate(OPS)}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BLOCKS_PER_SM = 8      # the most the backward's row pass keeps resident (256 threads)


class _Counter:
    """``launches``: the card's kernel launches; ``launches_by_path[(op,
    path)]``: the card's calls and the plain calls."""

    def __init__(self) -> None:
        self.launches = 0
        self.launches_by_path = {(op, path): 0 for op in OPS for path in PATHS}


layernorm_launches = _Counter()


def plain_layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """Moments in float32 (population variance), the normalized value cast
    back to x's dtype before the scale and bias, which apply in that dtype."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return out.to(x.dtype) * scale.to(x.dtype) + bias.to(x.dtype)


def check_shape(x: torch.Tensor) -> None:
    """Raises ValueError for an input the kernels do not take: another dtype
    than float32 or bfloat16, a last dimension outside 1..MAX_DIM."""
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"the layer norm kernels take float32 or bfloat16, got {x.dtype}")
    if x.dim() == 0 or not 1 <= x.shape[-1] <= MAX_DIM:
        raise ValueError(f"the layer norm kernels take a last dimension of 1 to {MAX_DIM}, "
                         f"got x of shape {tuple(x.shape)}")


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernels' library (built at first use) with its C signature declared."""
    from .build import load

    lib = load(KERNEL)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wgg_layernorm.argtypes = [i, i, p, p, p, p, p, p, p, p, p, p, ctypes.c_longlong, i,
                                  ctypes.c_float, i, p]
    lib.wgg_layernorm.restype = i
    lib.wgg_cuda_error_string.argtypes = [i]
    lib.wgg_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _count(op: str, path: str) -> None:
    layernorm_launches.launches_by_path[(op, path)] += 1


def _operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned: the kernels load 16 bytes at a
    time."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch(op: str, x: torch.Tensor, scale: torch.Tensor, out: torch.Tensor, *,
            bias: Optional[torch.Tensor] = None, g: Optional[torch.Tensor] = None,
            mean: Optional[torch.Tensor] = None, rstd: Optional[torch.Tensor] = None,
            partials: Optional[torch.Tensor] = None, dscale: Optional[torch.Tensor] = None,
            dbias: Optional[torch.Tensor] = None, eps: float = 0.0) -> None:
    rows, d = x.shape
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.wgg_layernorm(_OP_CODES[op], _DTYPE_CODES[x.dtype], x.data_ptr(),
                                scale.data_ptr(), _ptr(bias), _ptr(g), out.data_ptr(), _ptr(mean),
                                _ptr(rstd), _ptr(partials), _ptr(dscale), _ptr(dbias), rows, d,
                                eps, _sms(x.device.index), stream)
    if err:
        raise RuntimeError(f"layer norm kernel {op} failed to launch at x {tuple(x.shape)}: "
                           f"{lib.wgg_cuda_error_string(err).decode()} (cudaError {err})")
    layernorm_launches.launches += 1 if op == "layernorm_fwd" else 2


def _forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float,
             stats: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The norm of ``x`` (rows, D) in one launch, and with ``stats`` each
    row's float32 mean and rstd for the backward."""
    out = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean, rstd = (torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
                      for _ in range(2))
    if x.shape[0]:
        _launch("layernorm_fwd", x, scale, out, bias=bias, mean=mean, rstd=rstd, eps=eps)
        _count("layernorm_fwd", "cuda")
    return out, mean, rstd


def _backward(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
              rstd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dx (rows, D), dscale and dbias (D,) in two launches."""
    rows, d = x.shape
    dx = torch.empty_like(x)
    if not rows:
        return dx, torch.zeros_like(scale), torch.zeros_like(scale)
    dscale, dbias = torch.empty_like(scale), torch.empty_like(scale)
    partials = torch.empty(_BLOCKS_PER_SM * _sms(x.device.index) * 2 * d, dtype=torch.float32,
                           device=x.device)
    _launch("layernorm_bwd", x, scale, dx, g=g, mean=mean, rstd=rstd, partials=partials,
            dscale=dscale, dbias=dbias)
    _count("layernorm_bwd", "cuda")
    return dx, dscale, dbias


class _LayerNormKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        rows = _operand(x).view(-1, x.shape[-1])
        scale, bias = _operand(scale), _operand(bias)
        stats = any(ctx.needs_input_grad[:3])
        out, mean, rstd = _forward(rows, scale, bias, eps, stats)
        if stats:
            ctx.save_for_backward(rows, scale, mean, rstd)
        return out.view(x.shape)

    @staticmethod
    def backward(ctx, g):
        rows, scale, mean, rstd = ctx.saved_tensors
        dx, dscale, dbias = _backward(rows, scale, _operand(g).view(rows.shape), mean, rstd)
        return dx.view(g.shape), dscale, dbias, None


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """The layer norm of ``x`` over its last dimension with ``scale`` and
    ``bias`` (D,), each taken in x's dtype: through the kernels on the card
    (``check_shape`` raises for what they do not take), through
    ``plain_layernorm`` on the CPU."""
    if x.is_cuda:
        check_shape(x)
        d = x.shape[-1]
        if tuple(scale.shape) != (d,) or tuple(bias.shape) != (d,):
            raise ValueError(f"the layer norm of x {tuple(x.shape)} takes a scale and a bias of "
                             f"({d},), got {tuple(scale.shape)} and {tuple(bias.shape)}")
        return _LayerNormKernel.apply(x, scale.to(x.dtype), bias.to(x.dtype), eps)
    out = plain_layernorm(x, scale, bias, eps)
    _count("layernorm_fwd", "plain")
    if out.requires_grad:
        out.register_hook(lambda g: _count("layernorm_bwd", "plain"))
    return out
