"""gelu and leaky_relu on the card: the wrapper of the CUDA kernels in
``csrc/activations.cu``, and the dispatch between them and the plain
functions of ``models/layers.py``.

A CUDA tensor takes the kernels: one launch a forward and one a backward,
each a single pass over memory, equal bit for bit to the plain op-by-op chain
(one PyTorch kernel an op), gradient included, NaN where it gives NaN; they
take bfloat16 and float32, and any other dtype on the card raises
ValueError. leaky_relu's forward is PyTorch's own ``F.leaky_relu`` with the
slope in x's dtype, one kernel with the plain chain's bits (x * slope
computed in float32 and rounded once); its backward is a kernel here, since
PyTorch's gradient at 0 is the slope where JAX's is 1. A CPU tensor takes the plain function the caller passes, in any
dtype. Inputs that are non-overlapping and dense (a
transposed view plus a bias, say) are read in their own layout and the
output has it too; any other input is made contiguous first, and a view off
16-byte alignment is copied. A backward reads its cotangent in x's layout,
copying it only when the strides differ. The
kernels launch on the current stream, synchronise nothing and allocate
through PyTorch's caching allocator, so a captured CUDA graph records them.

``activation_launches.launches_by_path`` counts by activation and path,
``(op, "cuda" | "plain")`` for op in ``OPS``: the card's launches (an empty
tensor launches none) and the plain calls; ``.launches`` counts the card's
launches alone. A replayed CUDA graph adds what its capture counted
(``train/step_graph.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F

KERNEL = "activations"
OPS = ("gelu_fwd", "gelu_bwd", "leaky_fwd", "leaky_bwd")
KERNEL_OPS = ("gelu_fwd", "gelu_bwd", "leaky_bwd")   # csrc/activations.cu's, in its order
PATHS = ("cuda", "plain")
_OP_CODES = {op: i for i, op in enumerate(KERNEL_OPS)}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BLOCKS_PER_SM = 8      # of 256 threads: a full H100 SM


class _Counter:
    """``launches``: the card's launches; ``launches_by_path[(op, path)]``:
    those and the plain calls."""

    def __init__(self) -> None:
        self.launches = 0
        self.launches_by_path = {(op, path): 0 for op in OPS for path in PATHS}


activation_launches = _Counter()


def takes_kernel(x: torch.Tensor) -> bool:
    """Whether ``x`` goes through the kernels: a CUDA tensor. Raises
    ValueError for a dtype they do not take (bfloat16 and float32 only)."""
    if x.is_cuda and x.dtype not in _DTYPE_CODES:
        raise ValueError(f"the activation kernels take float32 or bfloat16, got {x.dtype}")
    return x.is_cuda


def is_dense(x: torch.Tensor) -> bool:
    """Whether ``x``'s elements fill a block of memory once each, in some
    order of its dimensions (non-overlapping and dense); dimensions of size
    1 may have any stride."""
    if x.numel() == 0:
        return True
    expected = 1
    for stride, size in sorted((st, n) for st, n in zip(x.stride(), x.shape) if n != 1):
        if stride != expected:
            return False
        expected *= size
    return True


def same_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` (one shape) order their elements alike in
    memory: equal strides wherever a dimension is longer than 1."""
    return all(sa == sb for n, sa, sb in zip(a.shape, a.stride(), b.stride()) if n != 1)


def in_layout_of(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``g`` with ``x``'s strides (``x`` dense): ``g`` itself when they agree,
    else a copy."""
    if same_layout(g, x):
        return g
    return torch.empty_like(x).copy_(g)


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernels' library (built at first use) with its C signature declared."""
    from .build import load

    lib = load(KERNEL)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wgg_activation.argtypes = [i, i, p, p, p, ctypes.c_longlong, ctypes.c_float, i, p]
    lib.wgg_activation.restype = i
    lib.wgg_cuda_error_string.argtypes = [i]
    lib.wgg_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _max_blocks(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count * _BLOCKS_PER_SM


def _count(op: str, path: str) -> None:
    activation_launches.launches_by_path[(op, path)] += 1


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy in its layout when its data is off 16-byte alignment
    (a view that starts inside an allocation): the kernels load 16 bytes at a
    time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(op: str, x: torch.Tensor, g: Optional[torch.Tensor] = None,
            slope: float = 0.0) -> torch.Tensor:
    """``op`` of dense ``x`` (and ``g`` in its layout) in one launch on the
    current stream; the output has ``x``'s layout."""
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    x, g = _aligned(x), None if g is None else _aligned(g)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.wgg_activation(_OP_CODES[op], _DTYPE_CODES[x.dtype], x.data_ptr(),
                                 None if g is None else g.data_ptr(), out.data_ptr(), x.numel(),
                                 slope, _max_blocks(x.device.index), stream)
    if err:
        raise RuntimeError(f"activation kernel {op} failed to launch: "
                           f"{lib.wgg_cuda_error_string(err).decode()} (cudaError {err})")
    _count(op, "cuda")
    activation_launches.launches += 1
    return out


def _leaky_forward(x: torch.Tensor, slope: float) -> torch.Tensor:
    """leaky_relu of dense ``x`` on the card: PyTorch's kernel, one launch,
    the output in ``x``'s layout."""
    out = F.leaky_relu(x, slope)
    if x.numel():
        _count("leaky_fwd", "cuda")
        activation_launches.launches += 1
    return out


def _dense(x: torch.Tensor) -> torch.Tensor:
    return x if is_dense(x) else x.contiguous()


class _GeluKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = _dense(x)
        ctx.save_for_backward(x)
        return _launch("gelu_fwd", x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _launch("gelu_bwd", x, in_layout_of(g, x))


class _LeakyKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slope):
        x = _dense(x)
        ctx.save_for_backward(x)
        ctx.slope = slope
        return _leaky_forward(x, slope)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _launch("leaky_bwd", x, in_layout_of(g, x), ctx.slope), None


def _plain(name: str, out: torch.Tensor) -> torch.Tensor:
    """Count a plain call of ``name`` and, once autograd reaches it, its
    backward."""
    _count(f"{name}_fwd", "plain")
    if out.requires_grad:
        out.register_hook(lambda g: _count(f"{name}_bwd", "plain"))
    return out


def gelu(x: torch.Tensor, plain: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """gelu of ``x`` through the kernels on the card, through ``plain`` on the
    CPU (``takes_kernel``)."""
    if takes_kernel(x):
        return _GeluKernel.apply(x)
    return _plain("gelu", plain(x))


def leaky_relu(x: torch.Tensor, slope: float,
               plain: Callable[[torch.Tensor, float], torch.Tensor]) -> torch.Tensor:
    """leaky_relu of ``x`` with ``slope`` (a number of x's dtype) through the
    kernels on the card, through ``plain(x, slope)`` on the CPU."""
    if takes_kernel(x):
        return _LeakyKernel.apply(x, slope)
    return _plain("leaky", plain(x, slope))
