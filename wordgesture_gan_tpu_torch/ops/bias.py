"""The models' bias adds: the plain chain, the wrapper of the CUDA kernel in
``csrc/bias.cu``, and the dispatch between them.

``add_bias(y, b)`` is ``y + b`` with ``b`` (contiguous, y's trailing
dimensions: ``(N,)`` after a dense layer or a convolution, ``(L, D)`` for
the transformer's positions) broadcast over y's leading ones;
``add_bias(y, b, residual)`` is ``residual + (y + b)``, rounded twice as
that chain rounds. A CUDA tensor takes the kernel: one launch, equal bit for
bit to the chain, in bfloat16 and float32 (another dtype on the card, or a
``b`` or residual of another dtype, raises ValueError). Its backward is the
chain's: the cotangent goes to y and the residual unchanged, and ``b`` gets
its sum over the broadcast dimensions from autograd's own reduction, run
only when b's gradient is asked for, as for the chain. A
CPU tensor takes the plain chain the caller passes (``plain_add_bias``
unless told otherwise), in any dtype.

y is read in its own layout when it is non-overlapping and dense and b's
dimensions lie in its memory in b's order (a row-major array, a
convolution's channel-first output seen through its (B, L, C) view), and
the output has that layout too, as the chain's has; any other y is made
contiguous first, and a residual in another layout is copied into y's. The
kernel launches on the current stream, synchronises nothing and allocates
through PyTorch's caching allocator, so a captured CUDA graph records it.

``bias_launches.launches_by_path`` counts by op and path, ``(op, "cuda" |
"plain")`` for op in ``OPS``: the card's launches (an empty tensor launches
none) and the plain calls; ``.launches`` counts the card's launches alone.
A replayed CUDA graph adds what its capture counted
(``train/step_graph.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import torch

from .activations import in_layout_of, is_dense

KERNEL = "bias"
OPS = ("bias", "bias_residual")
PATHS = ("cuda", "plain")
KINDS = ("vector", "scalar")     # csrc/bias.cu's loops, in its order
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BLOCKS_PER_SM = 8      # of 256 threads: a full H100 SM


class _Counter:
    """``launches``: the card's launches; ``launches_by_path[(op, path)]``:
    those and the plain calls."""

    def __init__(self) -> None:
        self.launches = 0
        self.launches_by_path = {(op, path): 0 for op in OPS for path in PATHS}


bias_launches = _Counter()


def plain_add_bias(y: torch.Tensor, b: torch.Tensor,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y + b``, then ``residual +`` that: one PyTorch kernel an add."""
    out = y + b
    return out if residual is None else residual + out


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library (built at first use) with its C signatures declared."""
    from .build import load

    lib = load(KERNEL)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.wgg_bias.argtypes = [i, p, p, p, p, ll, ll, ll, i, p]
    lib.wgg_bias.restype = i
    lib.wgg_bias_kind.argtypes = [i, p, p, p, ll]
    lib.wgg_bias_kind.restype = i
    lib.wgg_cuda_error_string.argtypes = [i]
    lib.wgg_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _max_blocks(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count * _BLOCKS_PER_SM


def _count(op: str, path: str) -> None:
    bias_launches.launches_by_path[(op, path)] += 1


def bias_stride(y: torch.Tensor, dims: int) -> Optional[int]:
    """y's memory stride of one step along the flattened last ``dims``
    dimensions, when those lie in memory in their own order (each one's
    stride that times the number of elements after it, dimensions of size 1
    left out), else None; 1 when they all have size 1."""
    s, inner = None, 1
    for size, stride in reversed(list(zip(y.shape[-dims:], y.stride()[-dims:]))):
        if size == 1:
            continue
        s = stride if s is None else s
        if stride != s * inner:
            return None
        inner *= size
    return 1 if s is None else s


def _operands(y: torch.Tensor, b: torch.Tensor, residual: Optional[torch.Tensor]):
    """(y, b, residual, s): y dense with b's dimensions in b's order (else
    contiguous), b contiguous, the residual in y's layout, and y's memory
    stride of b's step."""
    s = bias_stride(y, b.dim()) if is_dense(y) else None
    if s is None:
        y = y.contiguous()
        s = 1
    if residual is not None:
        residual = in_layout_of(residual, y)
    return y, b.contiguous(), residual, s


def path_of(y: torch.Tensor, b: torch.Tensor, residual: Optional[torch.Tensor] = None) -> str:
    """The kernel's loop for these card tensors: ``"vector"`` (16-byte
    vectors: y and the residual 16-byte aligned, y a whole number of them)
    or ``"scalar"`` (one element at a time). The output is allocated
    aligned."""
    y, b, residual, _ = _operands(y, b, residual)
    ptr = None if residual is None else residual.data_ptr()
    return KINDS[_library().wgg_bias_kind(_DTYPE_CODES[y.dtype], y.data_ptr(), ptr, None,
                                          y.numel())]


def _launch(y: torch.Tensor, b: torch.Tensor, residual: Optional[torch.Tensor]) -> torch.Tensor:
    """The sum in one launch on the current stream; the output in y's layout."""
    op = "bias" if residual is None else "bias_residual"
    y, b, residual, s = _operands(y, b, residual)
    out = torch.empty_like(y)
    if y.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = lib.wgg_bias(_DTYPE_CODES[y.dtype], y.data_ptr(), b.data_ptr(),
                           None if residual is None else residual.data_ptr(), out.data_ptr(),
                           y.numel(), s, b.numel(), _max_blocks(y.device.index), stream)
    if err:
        raise RuntimeError(f"bias kernel failed to launch at y {tuple(y.shape)}, b "
                           f"{tuple(b.shape)}: {lib.wgg_cuda_error_string(err).decode()} "
                           f"(cudaError {err})")
    _count(op, "cuda")
    bias_launches.launches += 1
    return out


class _BiasKernel(torch.autograd.Function):
    """The kernel's sum of y, b and the residual; b enters twice: detached,
    as the kernel reads it, and as ``b.expand_as(y)``, which takes the
    cotangent whole. Autograd's own expand backward then sums it down to b,
    the reduction the chain runs, and only when a caller asks for b's
    gradient: a custom backward cannot see which gradients the engine
    will drop."""

    @staticmethod
    def forward(ctx, y, b_wide, residual, b):
        return _launch(y, b, residual)

    @staticmethod
    def backward(ctx, g):
        return tuple(g if needed else None for needed in ctx.needs_input_grad[:3]) + (None,)


def _kernel_add(y: torch.Tensor, b: torch.Tensor,
                residual: Optional[torch.Tensor]) -> torch.Tensor:
    return _BiasKernel.apply(y, b.expand(y.shape), residual, b.detach())


def check_operands(y: torch.Tensor, b: torch.Tensor, residual: Optional[torch.Tensor]) -> None:
    """Raises ValueError for card tensors the kernel does not take: another
    dtype than float32 or bfloat16, b or the residual of another dtype or
    on another device, b not y's trailing dimensions, a residual of another
    shape."""
    if y.dtype not in _DTYPE_CODES:
        raise ValueError(f"the bias kernel takes float32 or bfloat16, got {y.dtype}")
    others = [b] + ([] if residual is None else [residual])
    if any(t.dtype != y.dtype or t.device != y.device for t in others):
        raise ValueError(f"the bias kernel takes b and the residual in y's dtype and device "
                         f"({y.dtype}, {y.device}), got "
                         f"{[(t.dtype, str(t.device)) for t in others]}")
    if b.dim() == 0 or b.dim() > y.dim() or tuple(b.shape) != tuple(y.shape[y.dim() - b.dim():]):
        raise ValueError(f"the bias kernel takes a b of y's trailing dimensions, got y "
                         f"{tuple(y.shape)} and b {tuple(b.shape)}")
    if residual is not None and residual.shape != y.shape:
        raise ValueError(f"the bias kernel takes a residual of y's shape {tuple(y.shape)}, "
                         f"got {tuple(residual.shape)}")


def add_bias(y: torch.Tensor, b: torch.Tensor, residual: Optional[torch.Tensor] = None,
             plain: Callable[..., torch.Tensor] = plain_add_bias) -> torch.Tensor:
    """``y + b``, or ``residual + (y + b)``: through the kernel on the card
    (``check_operands`` raises for what it does not take), through
    ``plain(y, b, residual)`` on the CPU."""
    op = "bias" if residual is None else "bias_residual"
    if y.is_cuda:
        check_operands(y, b, residual)
        return _kernel_add(y, b, residual)
    _count(op, "plain")
    return plain(y, b, residual)
