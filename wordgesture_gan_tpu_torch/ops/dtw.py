"""Exact batched dynamic-time-warping distance: the wrappers of the CUDA
kernel ``csrc/dtw.cu``, its plain PyTorch version, and the (n, m) distance
matrix the metric suite takes.

Port of the JAX package's ``ops/dtw.py`` and ``ops/dtw_pallas.py`` (the
Pallas TPU kernel ``_dtw_kernel``, launched by ``dtw_pairs_pallas``,
dispatched by ``dtw_distance_matrix``). For sequences x, y of L points with D
features, the point cost is the Euclidean distance by direct differences,
``c[i, j] = sqrt(sum_d (x[i, d] - y[j, d])**2)``, and

    D[i, j] = c[i, j] + min(D[i-1, j], D[i-1, j-1], D[i, j-1]),

first row and column by prefix sums; the distance is ``D[L-1, L-1]``. This is
exact DTW (fastdtw, which the reference implementation calls, approximates it
from above).

Dispatch: tensors on the CPU take ``dtw_pairs_plain``; tensors on a CUDA
device launch the kernel, and a shape the kernel does not take, a build
failure or a launch failure raises. There is no other path. Forward only.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

KERNEL = "dtw"
MAX_LEN = 128          # the kernel keeps one row of the recurrence in registers
_BIG = 1e30            # guards the cells outside the matrix (not inf)
_PLAIN_PAIR_CHUNK = 8192


def dtw_pairs_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x, y (P, L, D) float32 → (P,).

    A sweep over the rows of the recurrence. With M[j] = min(D[i-1, j],
    D[i-1, j-1]) and S[j] the prefix sums of cost row i, the row has the
    closed form D[i, j] = S[j] + cummin_j(M[j] - S[j-1]), so each row is one
    ``cumsum`` and one ``cummin`` over all pairs at once. The cost rows are
    made on the fly from direct differences, as the kernel makes them; the
    kernel adds along the path instead of subtracting prefix sums, so the two
    differ in the last bits."""
    P, L, _ = x.shape
    x = x.to(torch.float32)
    y = y.to(torch.float32)

    def cost_row(i: int) -> torch.Tensor:
        diff = x[:, i, None, :] - y                                   # (P, L, D)
        return torch.sqrt((diff * diff).sum(dim=-1))

    def shift_right(t: torch.Tensor, fill: float) -> torch.Tensor:
        return torch.cat([t.new_full((P, 1), fill), t[:, :-1]], dim=1)

    d = torch.cumsum(cost_row(0), dim=1)
    for i in range(1, L):
        m = torch.minimum(d, shift_right(d, _BIG))                    # min(up, diag)
        s = torch.cumsum(cost_row(i), dim=1)
        d = s + torch.cummin(m - shift_right(s, 0.0), dim=1).values
    return d[:, L - 1]


def _check_pair_shapes(x: torch.Tensor, y: torch.Tensor, names: str) -> None:
    if x.dim() != 3 or y.dim() != 3 or x.shape[1:] != y.shape[1:]:
        raise ValueError(f"{names} must be (·, L, D) with equal L and D, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.shape[0] < 1 or y.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{names} must hold at least one sequence of at least one point")
    if x.device != y.device:
        raise ValueError(f"{names} are on {x.device} and {y.device}")


def _check_kernel_shapes(x: torch.Tensor) -> None:
    _, L, D = x.shape
    if D not in (2, 3):
        raise ValueError(f"the DTW kernel takes D in (2, 3) features; got D={D}")
    if L > MAX_LEN:
        raise ValueError(f"the DTW kernel takes sequences of at most {MAX_LEN} points; got L={L}")


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library (built at first use) with its C signatures declared."""
    from .build import load

    lib = load(KERNEL)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wgg_dtw_matrix.argtypes = [p, p, p, i, i, i, i, p]
    lib.wgg_dtw_matrix.restype = i
    lib.wgg_dtw_pairs.argtypes = [p, p, p, ctypes.c_longlong, i, i, p]
    lib.wgg_dtw_pairs.restype = i
    lib.wgg_cuda_error_string.argtypes = [i]
    lib.wgg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(entry: str, a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, *counts: int) -> None:
    """Launch one of the library's entries on the current stream: float32
    contiguous copies of ``a`` and ``b`` (n, L, D), then ``out``, the counts,
    L and D. Raises if the launch is refused."""
    _check_kernel_shapes(a)
    lib = _library()
    a, b = a.to(torch.float32).contiguous(), b.to(torch.float32).contiguous()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = getattr(lib, entry)(a.data_ptr(), b.data_ptr(), out.data_ptr(), *counts,
                                  a.shape[1], a.shape[2], stream)
    if err:
        raise RuntimeError(f"dtw kernel launch failed: "
                           f"{lib.wgg_cuda_error_string(err).decode()} (cudaError {err})")


def dtw_pairs(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """DTW distance of aligned pairs: x, y (P, L, D) → (P,) float32.

    CUDA tensors launch the kernel (D in (2, 3), L <= 128, any P >= 1;
    ``dtw_pairs.launches`` counts the launches); CPU tensors run
    ``dtw_pairs_plain``."""
    _check_pair_shapes(x, y, "x and y")
    if x.shape[0] != y.shape[0]:
        raise ValueError(f"aligned pairs need equal counts, got {x.shape[0]} and {y.shape[0]}")
    with torch.no_grad():
        if x.device.type == "cpu":
            return dtw_pairs_plain(x, y)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        out = torch.empty((x.shape[0],), dtype=torch.float32, device=x.device)
        _launch("wgg_dtw_pairs", x, y, out, x.shape[0])
        dtw_pairs.launches += 1
        return out


dtw_pairs.launches = 0


def dtw_matrix(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """All n·m DTW distances: real (n, L, D), fake (m, L, D) → (n, m) float32.

    CUDA tensors launch the kernel once for the whole matrix: it reads both
    sets in place and finds pair (r, f) itself, so nothing is gathered
    (``dtw_matrix.launches`` counts the launches). CPU tensors run
    ``dtw_pairs_plain`` over gathered chunks of 8192 pairs."""
    _check_pair_shapes(real, fake, "real and fake")
    n, m = real.shape[0], fake.shape[0]
    with torch.no_grad():
        if real.device.type == "cpu":
            flat = torch.arange(n * m)
            chunks = [dtw_pairs_plain(real[idx // m], fake[idx % m])
                      for idx in flat.split(_PLAIN_PAIR_CHUNK)]
            return torch.cat(chunks).reshape(n, m)
        if real.device.type != "cuda":
            raise ValueError(f"unsupported device {real.device}")
        out = torch.empty((n, m), dtype=torch.float32, device=real.device)
        _launch("wgg_dtw_matrix", real, fake, out, n, m)
        dtw_matrix.launches += 1
        return out


dtw_matrix.launches = 0


def dtw_distance_matrix(real: np.ndarray, fake: np.ndarray, device="cuda") -> np.ndarray:
    """Full (n, m) DTW distance matrix between two gesture sets given as
    numpy arrays, real (n, L, D) and fake (m, L, D), computed on ``device``
    (the counterpart of the JAX package's ``dtw_distance_matrix``; the device
    decides between the kernel and the plain version)."""
    device = torch.device(device)
    real_t = torch.as_tensor(np.asarray(real, np.float32), device=device)
    fake_t = torch.as_tensor(np.asarray(fake, np.float32), device=device)
    return dtw_matrix(real_t, fake_t).cpu().numpy()
