"""The transformer generator's attention core on the card: the wrapper of the
CUDA kernels in ``csrc/attention.cu``, and the dispatch between them and the
plain chain of ``models/generators.py``.

The core takes the packed projections ``qkv`` (B, L, 3, H, h) and an
optional padding mask (B, L) (> 0 marks a valid key) and returns the heads'
outputs (B, L, H * h), ready for the output projection. A CUDA tensor takes
the kernels: one launch a forward and one a backward (dq, dk, dv into one
gradient of qkv's shape), in the chain's arithmetic (``csrc/attention.cu``
says where they round); bfloat16 runs on the tensor cores, float32 on the
CUDA cores with float32 products. They take h a multiple of 8 up to 64 and
L up to 256; another shape or dtype on the card raises ValueError. A CPU
tensor takes the plain chain the caller passes. The kernels launch on the
current stream, synchronise nothing and allocate through PyTorch's caching
allocator, so a captured CUDA graph records them; their sums run in a fixed
order, so two launches give the same bits.

``attention_launches.launches_by_path`` counts by direction and path,
``(op, "cuda" | "plain")`` for op in ``OPS``: the card's launches (an empty
batch launches none) and the plain calls; ``.launches`` counts the card's
launches alone. A replayed CUDA graph adds what its capture counted
(``train/step_graph.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Optional

import torch

KERNEL = "attention"
OPS = ("attention_fwd", "attention_bwd")
PATHS = ("cuda", "plain")
MAX_LEN, MAX_HEAD = 256, 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class _Counter:
    """``launches``: the card's launches; ``launches_by_path[(op, path)]``:
    those and the plain calls."""

    def __init__(self) -> None:
        self.launches = 0
        self.launches_by_path = {(op, path): 0 for op in OPS for path in PATHS}


attention_launches = _Counter()


def check_shape(qkv: torch.Tensor) -> None:
    """Raises ValueError for a (B, L, 3, H, h) tensor the kernels do not
    take: another dtype than float32 or bfloat16, h not a multiple of 8 up to
    64, L above 256."""
    if qkv.dtype not in _DTYPE_CODES:
        raise ValueError(f"the attention kernels take float32 or bfloat16, got {qkv.dtype}")
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"the attention kernels take qkv of shape (B, L, 3, H, h), "
                         f"got {tuple(qkv.shape)}")
    L, h = qkv.shape[1], qkv.shape[4]
    if h % 8 or not 8 <= h <= MAX_HEAD or L > MAX_LEN:
        raise ValueError(f"the attention kernels take heads of a multiple of 8 up to {MAX_HEAD} "
                         f"and lengths up to {MAX_LEN}, got qkv of shape {tuple(qkv.shape)}")


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernels' library (built at first use) with its C signature declared."""
    from .build import load

    lib = load(KERNEL)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wgg_attention.argtypes = [i, i, p, p, p, p, i, i, i, i, ctypes.c_float, p]
    lib.wgg_attention.restype = i
    lib.wgg_cuda_error_string.argtypes = [i]
    lib.wgg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _count(op: str, path: str) -> None:
    attention_launches.launches_by_path[(op, path)] += 1


def _operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned: the kernels load 16 bytes at a
    time."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(op: str, qkv: torch.Tensor, mask: Optional[torch.Tensor],
            dout: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch on the current stream: the forward's (B, L, H * h) output,
    or the backward's gradient of ``qkv`` from ``dout``."""
    B, L, _, H, h = qkv.shape
    out = torch.empty((B, L, H * h) if dout is None else qkv.shape, dtype=qkv.dtype,
                      device=qkv.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.wgg_attention(int(dout is not None), _DTYPE_CODES[qkv.dtype], qkv.data_ptr(),
                                None if mask is None else mask.data_ptr(),
                                None if dout is None else dout.data_ptr(), out.data_ptr(),
                                B, L, H, h, math.sqrt(h), stream)
    if err:
        raise RuntimeError(f"attention kernel {op} failed to launch at qkv {tuple(qkv.shape)}: "
                           f"{lib.wgg_cuda_error_string(err).decode()} (cudaError {err})")
    _count(op, "cuda")
    attention_launches.launches += 1
    return out


class _AttentionKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, mask):
        qkv = _operand(qkv)
        if mask is not None:
            mask = mask.to(torch.float32).contiguous()
        ctx.save_for_backward(qkv, mask)
        return _launch("attention_fwd", qkv, mask)

    @staticmethod
    def backward(ctx, g):
        qkv, mask = ctx.saved_tensors
        return _launch("attention_bwd", qkv, mask, _operand(g)), None


def attention(qkv: torch.Tensor, pad_mask: Optional[torch.Tensor],
              plain: Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]
              ) -> torch.Tensor:
    """The attention core of ``qkv`` (B, L, 3, H, h) under ``pad_mask`` (B, L)
    or None: (B, L, H * h). Through the kernels on the card (``check_shape``
    raises for what they do not take), through ``plain`` on the CPU."""
    if qkv.is_cuda:
        check_shape(qkv)
        if pad_mask is not None and tuple(pad_mask.shape) != tuple(qkv.shape[:2]):
            raise ValueError(f"the padding mask of qkv {tuple(qkv.shape)} is (B, L), "
                             f"got {tuple(pad_mask.shape)}")
        return _AttentionKernel.apply(qkv, pad_mask)
    out = plain(qkv, pad_mask)
    _count("attention_fwd", "plain")
    if out.requires_grad:
        out.register_hook(lambda g: _count("attention_bwd", "plain"))
    return out
