"""The random draws of ``utils/prng.py`` on the card: the wrapper of the CUDA
kernel ``csrc/threefry.cu``.

One launch draws every row of a stack of keys: keys (n, 2) int64 on a CUDA
device and a shape give (n, *shape) numbers, row k from key k (a single key
(2,) gives ``shape``). The kernel reads the keys from device memory, so a
captured CUDA graph draws anew when the key buffer is rewritten before a
replay. Bits come back as int64, uniforms and normals as float32, each equal
bit for bit to the plain version in ``utils/prng.py``, which CPU keys take.
A key on a CUDA device launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

KERNEL = "threefry"
_MODES = {"bits": 0, "uniform": 1, "normal": 2}


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library (built at first use) with its C signatures declared."""
    from .build import load

    lib = load(KERNEL)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wgg_threefry_draw.argtypes = [p, i, ctypes.c_longlong, i, ctypes.c_float,
                                      ctypes.c_float, p, p]
    lib.wgg_threefry_draw.restype = i
    lib.wgg_cuda_error_string.argtypes = [i]
    lib.wgg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def threefry_draw(keys: torch.Tensor, shape: Tuple[int, ...], kind: str,
                  minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``kind`` ("bits", "uniform" on [minval, maxval), "normal" from the
    uniform on [minval, maxval) = (``prng.NORMAL_LO``, 1)) numbers of
    ``shape`` for each key of ``keys`` ((2,) or (n, 2) int64 on a CUDA
    device), in one launch on the current stream. ``threefry_draw.launches``
    counts the launches."""
    if keys.device.type != "cuda":
        raise ValueError(f"threefry_draw launches the CUDA kernel; keys are on {keys.device}")
    if keys.dtype != torch.int64 or keys.shape[-1:] != (2,) or keys.dim() > 2:
        raise ValueError(f"keys must be int64 (2,) or (n, 2), got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    n = keys.shape[0] if keys.dim() == 2 else 1
    m = math.prod(shape)
    out = torch.empty((*keys.shape[:-1], *shape),
                      dtype=torch.int64 if kind == "bits" else torch.float32, device=keys.device)
    if n == 0 or m == 0:
        return out
    keys = keys.contiguous()
    lib = _library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.wgg_threefry_draw(keys.data_ptr(), n, m, _MODES[kind], minval, maxval,
                                    out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"threefry kernel launch failed: "
                           f"{lib.wgg_cuda_error_string(err).decode()} (cudaError {err})")
    threefry_draw.launches += 1
    return out


threefry_draw.launches = 0
