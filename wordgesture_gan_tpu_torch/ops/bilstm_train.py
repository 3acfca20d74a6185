"""Differentiable fused BiLSTM stack: the training forward with residuals
(kernel 2), the backward-through-time (kernel 3), their plain PyTorch
versions, and ``bilstm_train_apply``, the ``torch.autograd.Function`` that
ties them together.

Port of the JAX package's ``ops/bilstm_train.py`` (the Pallas TPU kernels
``_fwd_kernel``, launched by ``_fwd_call``, and ``_bwd_kernel``, launched by
``_bwd_call``, under the ``jax.custom_vjp`` ``_train_core``). The CUDA
kernels are in ``csrc/bilstm_train.cu`` (the forward step they share with
the inference kernel in ``csrc/bilstm_step.cuh``); the source notes say
what bounds them on an H100 and how they are laid out.

Casting contract (the TPU pair's):

* forward — the inference kernel's recurrence (``ops/bilstm_fused.py``):
  gate sums, nonlinearities and the carried cell state float32, h rounded to
  the compute dtype every step, the layer-1 latent projection float32; every
  residual row [h | c | i | f | g | o] is stored rounded to the compute dtype.
  The output agrees with the inference kernel's within the kernels'
  tolerance (the two sum in different orders);
* backward — dy is rounded to the compute dtype; every gradient product runs
  in float32 with the weights rounded to the compute dtype (the static-z rows
  too); c_prev and h_prev come from the stored, rounded residuals; the
  gradient passed down to the layer below is rounded to the compute dtype per
  direction and the two directions' parts are added in the compute dtype; the
  prototype gradient is two rounded per-direction streams added in the
  compute dtype; z is rounded for dW_z; dW, db and dz accumulate in float32
  and db is credited to both ``b_ih`` and ``b_hh``.

Residual layout: (layers, 2, L, B, 6H), indexed by sequence position (not by
step), planes [h | c | i | f | g | o].

Dispatch: CPU tensors take the plain versions; CUDA tensors launch the
kernels, and a build or launch failure raises. There is no other path.

Three kernel paths, chosen by ``kernel_path`` from the compute dtype and the
shape alone (never by trying one and falling back):

* ``"mma"`` — bfloat16 with H in {16, 32, 48} (the flagship recipe: H=48),
  any B, L, Z and depth: the tensor-core kernels (``mma.sync`` bf16 with
  float32 accumulation), weights held on chip for a whole layer, residual
  rows and gate gradients moved as whole blocks. The backward's float32 gate
  gradients enter the tensor cores split in two bfloat16 terms
  (``split_hi_lo``), both products accumulated in float32, so the products
  stay float32 products of rounded weights/residuals to about 2^-17;
* ``"fp32"`` — float32 at the same H: the float32 inference kernel's design
  (one direction per CTA of a two-CTA cluster, a layer's weights in
  registers, full float32 products on the CUDA cores, ``sample_tile``
  samples per cluster) for the forward and the reverse sweep, then a
  ``cp.async``-staged float32 product for the weight gradients;
* ``"general"`` — any other H <= 256 in either dtype: the first CUDA-core
  kernels, every product in full float32.

``bilstm_train_fwd.launches`` / ``bilstm_train_bwd.launches`` count all
launches, ``.launches_by_path`` the launches of each path. A replayed CUDA
graph of a train step adds the launches its capture counted
(``train/step_graph.py``): the counts are bumped in Python, which a replay
does not run.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .bilstm_fused import (_CELL, _DIRS, _DTYPE_CODES, MMA_HIDDEN, SAMPLE_TILE, _check,
                           _check_path_shape, _pointers, _raise_on, _unflatten, kernel_weights,
                           packed_sizes, packed_weights, plain_stack, sample_tile, scratch_shape,
                           unpack_weights)

__all__ = ["MMA_HIDDEN", "backward_weights", "bilstm_train_apply", "bilstm_train_bwd",
           "bilstm_train_bwd_plain", "bilstm_train_fwd", "bilstm_train_fwd_plain",
           "fp32_buffer_shapes", "fp32_dx_row_offset", "fp32_dy_rows", "fp32_gate_row_offset",
           "fp32_kernel_info", "fp32_row_strides", "fp32_wgrad_splits", "kernel_path",
           "mma_kernel_info", "packed_sizes", "packed_weights", "sample_tile", "split_hi_lo",
           "unpack_weights"]

KERNEL = "bilstm_train"
# Rows of the backward's weight-gradient product per split of the (L·B) sum.
_ROWS_PER_SPLIT = 2048
_MAX_SPLITS = 16
# The tensor-core path (hidden sizes ``MMA_HIDDEN``, ``SAMPLE_TILE`` samples per
# CTA: ops/bilstm_fused.py): how many CTAs the weight-gradient product should fill.
_WGRAD_CTAS = 132
# The float32 path's weight-gradient product: CTAs resident at once on an
# H100 (132 SMs x 2, ``fp32_kernel_info``), and the fewest rows of the sum a
# split takes.
_FP32_WGRAD_SLOTS = 2 * 132
_FP32_WGRAD_MIN_ROWS = 1024


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def bilstm_train_fwd_plain(layers: List[Dict], x: torch.Tensor, static: torch.Tensor,
                           hidden: int, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 2's function: (B, L, 2) prototype + static (B, Z) → (output
    (B, L, 2H) in ``dtype``, residuals (layers, 2, L, B, 6H) in ``dtype``)."""
    return plain_stack(layers, x, hidden, static, dtype, residuals=True)


def bilstm_train_bwd_plain(layers: List[Dict], x: torch.Tensor, static: torch.Tensor,
                           res: torch.Tensor, dy: torch.Tensor, hidden: int, dtype: torch.dtype,
                           gate_grads: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                           ) -> Tuple[List[Dict], torch.Tensor, torch.Tensor]:
    """Kernel 3's function: the stack's gradients from the forward's
    residuals and the output cotangent ``dy`` (B, L, 2H).

    Returns (per-layer gradient tree in the weights' layout, float32;
    d prototype (B, L, 2) float32; d static (B, Z) float32). Step by step as
    the kernel: the reverse sweep of both directions together, top layer
    first; the sums over (time, batch) are taken after each layer's sweep.

    ``gate_grads``, if given, maps each step's float32 gate gradients to the
    values that enter the products (the tensor-core path feeds them as
    ``hi + lo`` of ``split_hi_lo``); the default is the float32 values."""
    f32 = torch.float32
    H = hidden
    n, _, L, B, _ = res.shape

    def q(t):
        return t.to(dtype).to(f32)

    dy_in = q(dy)                                                        # (B, L, 2H)
    grads: List[Dict] = [None] * n
    dx = dz = None
    zero_row = res.new_zeros((1, B, 6 * H), dtype=f32)
    for k in range(n - 1, -1, -1):
        layer = layers[k]
        R = res[k].to(f32)                                               # (2, L, B, 6H)
        # Each direction's previous internal step: fwd reads position p-1,
        # bwd position p+1; the first step's is zero.
        R_prev = torch.stack([torch.cat([zero_row, R[0, :-1]]), torch.cat([R[1, 1:], zero_row])])
        whh = torch.stack([q(layer[d]["w_hh"]) for d in _DIRS])          # (2, H, 4H)
        dy_dir = dy_in.view(B, L, 2, H).permute(2, 1, 0, 3)              # (2, L, B, H)
        dG = R.new_empty((2, L, B, 4 * H))
        dh = R.new_zeros((2, B, H))
        dc = R.new_zeros((2, B, H))
        for u in range(L):
            def at(t):   # direction 0 at position L-1-u, direction 1 at u
                return torch.stack([t[0, L - 1 - u], t[1, u]])
            row, c_prev = at(R), at(R_prev)[..., H:2 * H]
            c_t, i, f, g, o = (row[..., s * H:(s + 1) * H] for s in range(1, 6))
            dh = dh + at(dy_dir)
            tanh_c = torch.tanh(c_t)
            do = dh * tanh_c
            dc = dc + dh * o * (1.0 - tanh_c * tanh_c)
            dg = torch.cat([dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                            dc * i * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)   # (2, B, 4H)
            if gate_grads is not None:
                dg = gate_grads(dg)
            dc = dc * f
            dh = torch.bmm(dg, whh.transpose(1, 2))
            dG[0, L - 1 - u] = dg[0]
            dG[1, u] = dg[1]

        dwhh = torch.einsum("dlbh,dlbg->dhg", R_prev[..., 0:H], dG)
        db = dG.sum(dim=(1, 2))                                          # (2, 4H)
        if k > 0:
            below = res[k - 1].to(f32)
            xin = torch.cat([below[0, ..., 0:H], below[1, ..., 0:H]], dim=-1)   # (L, B, 2H)
            dwih = torch.einsum("lbk,dlbg->dkg", xin, dG)
            wih = torch.stack([q(layer[d]["w_ih"]) for d in _DIRS])      # (2, 2H, 4H)
            dxa = torch.einsum("dlbg,dkg->dlbk", dG, wih).to(dtype)      # per direction, rounded
            dy_in = (dxa[0] + dxa[1]).to(f32).transpose(0, 1)            # (B, L, 2H)
        else:
            proto = q(x).transpose(0, 1)                                 # (L, B, 2)
            dwp = torch.einsum("lbc,dlbg->dcg", proto, dG)
            dgsum = dG.sum(dim=1)                                        # (2, B, 4H)
            dwz = torch.einsum("bz,dbg->dzg", q(static), dgsum)
            wz = torch.stack([q(layer[d]["w_ih"][2:]) for d in _DIRS])   # (2, Z, 4H)
            dz = torch.einsum("dbg,dzg->bz", dgsum, wz)
            wp = torch.stack([q(layer[d]["w_ih"][:2]) for d in _DIRS])   # (2, 2, 4H)
            dpa = torch.einsum("dlbg,dcg->dlbc", dG, wp).to(dtype)
            dx = (dpa[0] + dpa[1]).to(f32).transpose(0, 1)               # (B, L, 2)
            dwih = torch.cat([dwp, dwz], dim=1)                          # (2, 2+Z, 4H)
        grads[k] = {d: {"w_ih": dwih[i], "w_hh": dwhh[i], "b_ih": db[i], "b_hh": db[i].clone()}
                    for i, d in enumerate(_DIRS)}
    return grads, dx, dz


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernels' library (built at first use) with its C signatures declared."""
    from .build import load

    lib = load(KERNEL)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wgg_bilstm_train_fwd.argtypes = [p] * 9 + [i] * 6 + [p]
    lib.wgg_bilstm_train_fwd.restype = i
    lib.wgg_bilstm_train_bwd.argtypes = [p] * 14 + [i] * 7 + [p]
    lib.wgg_bilstm_train_bwd.restype = i
    lib.wgg_bilstm_train_fwd_mma.argtypes = [p] * 6 + [i] * 5 + [p]
    lib.wgg_bilstm_train_fwd_mma.restype = i
    lib.wgg_bilstm_train_bwd_mma.argtypes = [p] * 14 + [i] * 6 + [p]
    lib.wgg_bilstm_train_bwd_mma.restype = i
    lib.wgg_bilstm_train_mma_info.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    lib.wgg_bilstm_train_mma_info.restype = i
    lib.wgg_bilstm_train_fwd_fp32.argtypes = [p] * 6 + [i] * 6 + [p]
    lib.wgg_bilstm_train_fwd_fp32.restype = i
    lib.wgg_bilstm_train_bwd_fp32.argtypes = [p] * 15 + [i] * 7 + [p]
    lib.wgg_bilstm_train_bwd_fp32.restype = i
    lib.wgg_bilstm_train_fp32_info.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.wgg_bilstm_train_fp32_info.restype = i
    lib.wgg_cuda_error_string.argtypes = [i]
    lib.wgg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def backward_weights(layers: List[Dict], hidden: int, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The weights kernel 3 reads, rounded to ``dtype``, laid out so that a
    warp's threads (consecutive hidden units) read consecutive addresses:
    ``whhT`` (layers, 4H, 2, H), ``wihT`` (layers-1, 4H, 2, 2H), ``wpT``
    (4H, 2, 2) and the static rows ``wz`` (2, Z, 4H)."""
    def both(name, rows=slice(None)):
        return lambda layer: torch.stack([layer[d][name][rows] for d in _DIRS])   # (2, rows, 4H)

    whh = torch.stack([both("w_hh")(layer) for layer in layers])         # (layers, 2, H, 4H)
    if len(layers) > 1:
        wih = torch.stack([both("w_ih")(layer) for layer in layers[1:]]).permute(0, 3, 1, 2)
    else:
        wih = whh.new_zeros((1,))    # never read by a one-layer stack
    return {
        "whhT": whh.permute(0, 3, 1, 2).to(dtype).contiguous(),
        "wihT": wih.to(dtype).contiguous(),
        "wpT": both("w_ih", slice(0, 2))(layers[0]).permute(2, 0, 1).to(dtype).contiguous(),
        "wz": both("w_ih", slice(2, None))(layers[0]).to(dtype).contiguous(),
    }


def _splits(rows: int) -> int:
    """How many parts the (L·B)-row weight-gradient sum is cut into."""
    return max(1, min(_MAX_SPLITS, rows // _ROWS_PER_SPLIT))


def kernel_path(dtype: torch.dtype, hidden: int, seq: int, layers: int) -> str:
    """Which kernels a CUDA call takes: ``"mma"`` (tensor cores) for bfloat16
    and ``"fp32"`` (two-CTA clusters) for float32 with H in ``MMA_HIDDEN``,
    ``"general"`` (the first CUDA-core kernels) otherwise. A pure function of
    the dtype and the shape; every sequence length and depth is served by all
    three paths, so ``seq`` and ``layers`` do not change the answer."""
    _check_path_shape(seq, layers)
    if hidden not in MMA_HIDDEN:
        return "general"
    return "mma" if dtype == torch.bfloat16 else "fp32"


def split_hi_lo(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A float32 tensor as two bfloat16 terms, ``hi = bf16(t)`` and ``lo =
    bf16(t - hi)``: ``hi + lo`` reproduces ``t`` to about 2^-17 relative. The
    form in which the tensor-core backward feeds its float32 gate gradients to
    bf16 products (both terms' products accumulate in float32)."""
    hi = t.to(torch.bfloat16)
    lo = (t - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def mma_kernel_info(hidden: int) -> Dict[str, Dict[str, int]]:
    """What the tensor-core kernels occupy on the current CUDA device, asked
    of the built library: dynamic shared memory per CTA, threads per CTA and
    resident CTAs per SM, for the forward, the sweep and the weight-gradient
    product at this hidden size."""
    lib = _library()
    info = {}
    for code, name in enumerate(("train_fwd_mma", "train_bwd_sweep_mma", "train_bwd_wgrad_mma")):
        out = (ctypes.c_int * 3)()
        _raise_on(lib, lib.wgg_bilstm_train_mma_info(hidden, code, out), name)
        info[name] = {"smem_bytes_per_cta": out[0], "threads_per_cta": out[1],
                      "ctas_per_sm": out[2]}
    return info


def _wgrad_splits(seq: int, n_layers: int) -> int:
    """Parts the positions are cut into for the tensor-core weight-gradient
    product (one CTA per (layer, direction, part)); no part is empty."""
    per_split = -(-seq // max(1, min(seq, _WGRAD_CTAS // (2 * n_layers))))
    return -(-seq // per_split)


def _gradient_tree(dw: torch.Tensor, n: int, H: int, Z: int) -> List[Dict]:
    """The kernels' packed [dW_ih; dW_hh; db] matrices as the gradient tree."""
    grads, offset = [], 0
    for k in range(n):
        din = 2 + Z if k == 0 else 2 * H
        cells = {}
        for d in _DIRS:
            mat = dw[offset:offset + (din + H + 1) * 4 * H].view(din + H + 1, 4 * H)
            offset += mat.numel()
            cells[d] = {"w_ih": mat[:din], "w_hh": mat[din:din + H], "b_ih": mat[din + H],
                        "b_hh": mat[din + H].clone()}
        grads.append(cells)
    return grads


# The float32 path's row padding (floats): the backward's dy and
# input-gradient rows lie 16 bytes past their width in shared memory and, so
# that each moves as one block, in global memory too; a gate-gradient row
# holds each gate in a block 16 bytes past H and ends 20 floats later
# (csrc/bilstm_train.cu: fp32_dx_stride, fp32_gate_block, fp32_gate_stride).
_FP32_PAD = 4


def fp32_row_strides(hidden: int) -> Dict[str, int]:
    """Floats from one row to the next in the float32 backward's buffers:
    dy and input-gradient rows (H wide), gate-gradient rows (four gate
    blocks of ``"gate_block"`` floats, H of them used, and 20 more)."""
    block = hidden + _FP32_PAD
    return {"dx": block, "gate_block": block, "gates": 4 * block + 20}


def fp32_buffer_shapes(batch: int, seq: int, hidden: int, latent: int, n_layers: int, tile: int,
                       splits: int) -> Dict[str, Tuple[int, ...]]:
    """The float32 backward's buffers, in the kernels' layouts
    (csrc/bilstm_train.cu: wgg_bilstm_train_bwd_fp32): dy and the input
    gradients passed down, per (half, tile, position) one block of ``tile``
    padded rows (half d: the features of direction d; the input gradients
    also per ping-pong buffer and per direction that wrote them); the gate
    gradients per (layer, direction, position), whole tiles; the partial sums
    the last pass adds (splits of the product; tiles of the sweep's bias,
    prototype and z rows)."""
    tiles = -(-batch // tile)
    stride = fp32_row_strides(hidden)
    g = 4 * hidden
    return {
        "dy": (2, tiles, seq, tile, stride["dx"]),
        "dx": (2, 2, 2, tiles, seq, tile, stride["dx"]) if n_layers > 1 else (8,),
        "gates": (2 * n_layers, seq, tiles * tile, stride["gates"]),
        "ws": (splits, 2 * n_layers, 3 * hidden, g),
        "wsb": (tiles, 2 * n_layers, g),
        "wsp": (tiles, 2, 2, g),
        "wsz": (tiles, 2, max(latent, 1), g),
    }


def fp32_dx_row_offset(sample: int, pos: int, half: int, seq: int, batch: int, hidden: int,
                       tile: int, buffer: int = 0, stream: int = 0) -> int:
    """Offset (floats) of a sample's row at a position in the float32 sweep's
    dy (``buffer = stream = 0``) or input-gradient buffers: the kernels'
    arithmetic (``dx_block`` plus the sample's row)."""
    tiles = -(-batch // tile)
    block = (((buffer * 2 + stream) * 2 + half) * tiles + sample // tile) * seq + pos
    return (block * tile + sample % tile) * fp32_row_strides(hidden)["dx"]


def fp32_gate_row_offset(layer: int, direction: int, pos: int, sample: int, seq: int, batch: int,
                         hidden: int, tile: int) -> int:
    """Offset (floats) of a sample's gate-gradient row: rows r = pos · T +
    sample per (layer, direction), T = whole tiles of samples (the sweep's
    bulk store and the product's row index)."""
    padded = -(-batch // tile) * tile
    return (((layer * 2 + direction) * seq + pos) * padded + sample) * \
        fp32_row_strides(hidden)["gates"]


def fp32_dy_rows(dy: torch.Tensor, tile: int) -> torch.Tensor:
    """dy (B, L, 2H) in the float32 sweep's layout (``fp32_buffer_shapes``'
    ``"dy"``): float32, samples past B and the padding zero."""
    B, L, two_h = dy.shape
    H = two_h // 2
    tiles = -(-B // tile)
    out = dy.new_zeros((2, tiles, L, tile, H + _FP32_PAD), dtype=torch.float32)
    rows = torch.nn.functional.pad(dy.to(torch.float32), (0, 0, 0, 0, 0, tiles * tile - B))
    out[..., :H] = rows.reshape(tiles, tile, L, 2, H).permute(3, 0, 2, 1, 4)
    return out


def fp32_wgrad_splits(rows: int, n_layers: int) -> int:
    """Parts the float32 weight-gradient product cuts its ``rows`` (L x whole
    tiles of samples) into: as many as keep every CTA busy in one wave (one
    CTA per (layer, direction, operand part, split); layer 1 has one part),
    and no part under ``_FP32_WGRAD_MIN_ROWS`` rows. A second, partly filled
    wave would double the time."""
    busy_per_split = 2 * (3 * (n_layers - 1) + 1)
    return max(1, min(rows // _FP32_WGRAD_MIN_ROWS, _FP32_WGRAD_SLOTS // busy_per_split))


def fp32_kernel_info(hidden: int) -> Dict[str, Dict[str, int]]:
    """What the float32 kernels occupy on the current CUDA device, asked of the
    built library: dynamic shared memory per CTA, threads per CTA and
    resident CTAs per SM of the forward and the sweep at either sample tile,
    and of the weight-gradient product, at this hidden size."""
    lib = _library()
    info = {}
    for tile in (8, 4):
        for code, name in enumerate(("train_fwd_fp32", "train_bwd_sweep_fp32",
                                     "train_bwd_wgrad_fp32")):
            if code == 2 and tile == 4:
                continue
            out = (ctypes.c_int * 3)()
            key = name if code == 2 else f"{name}_tile{tile}"
            _raise_on(lib, lib.wgg_bilstm_train_fp32_info(hidden, tile, code, out), key)
            info[key] = {"smem_bytes_per_cta": out[0], "threads_per_cta": out[1],
                         "ctas_per_sm": out[2]}
    return info


def _launch_fwd_fp32(layers, x, static, hidden, dtype, tile=None):
    """The float32 forward. ``tile`` overrides ``sample_tile`` (a measurement
    of the other tile; the dispatch never passes it)."""
    lib = _library()
    device = x.device
    f32 = torch.float32
    B, L, _ = x.shape
    n = len(layers)
    tile = tile or sample_tile(dtype, B)
    wf = packed_weights(layers, dtype)[0]
    proto = x.to(f32).contiguous()
    z = static.to(f32).contiguous()
    res = torch.empty((n, 2, L, B, 6 * hidden), dtype=f32, device=device)
    out = torch.empty((B, L, 2 * hidden), dtype=f32, device=device)
    scratch = torch.empty(scratch_shape(B, L, hidden, n, tile) if n > 1 else (8,), dtype=f32,
                          device=device)
    ptrs = _pointers([proto, z, wf, res, out, scratch], device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.wgg_bilstm_train_fwd_fp32(*ptrs, B, L, hidden, static.shape[1], n, tile, stream)
    _raise_on(lib, err, "bilstm_train_fwd (float32 path)")
    return out, res


def _launch_bwd_fp32(layers, x, static, res, dy, hidden, dtype, tile=None):
    """The float32 backward: the sweep, the weight-gradient product and the
    fixed-order sum. ``tile`` as for ``_launch_fwd_fp32``."""
    lib = _library()
    device = x.device
    f32 = torch.float32
    n, _, L, B, _ = res.shape
    H, Z = hidden, static.shape[1]
    tile = tile or sample_tile(dtype, B)
    splits = fp32_wgrad_splits(L * -(-B // tile) * tile, n)
    shapes = fp32_buffer_shapes(B, L, H, Z, n, tile, splits)
    m_first, m_rest = 2 + Z + H + 1, 3 * H + 1

    def empty(shape):
        return torch.empty(shape, dtype=f32, device=device)

    operands = [
        res.contiguous(), fp32_dy_rows(dy, tile), x.to(f32).contiguous(),
        static.to(f32).contiguous(), packed_weights(layers, dtype)[0],
        empty(shapes["gates"]), empty(shapes["dx"]),
        empty((2, B, L, 2)),                                                     # dx streams
        empty((B, max(Z, 1))), empty((B, max(Z, 1))),                            # dz, its part
        empty(shapes["ws"]), empty(shapes["wsb"]), empty(shapes["wsp"]), empty(shapes["wsz"]),
        empty((2 * (m_first + (n - 1) * m_rest) * 4 * H,)),
    ]
    ptrs = _pointers(operands, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.wgg_bilstm_train_bwd_fp32(*ptrs, B, L, H, Z, n, splits, tile, stream)
    _raise_on(lib, err, "bilstm_train_bwd (float32 path)")
    dpa, dz, dw = operands[7], operands[8], operands[14]
    return _gradient_tree(dw, n, H, Z), dpa[0] + dpa[1], dz[:, :Z]


def _launch_fwd_mma(layers, x, static, hidden, dtype):
    lib = _library()
    device = x.device
    B, L, _ = x.shape
    n = len(layers)
    wf, wq = packed_weights(layers, dtype)
    proto = x.to(dtype).contiguous()
    z = static.to(torch.float32).contiguous()
    res = torch.empty((n, 2, L, B, 6 * hidden), dtype=dtype, device=device)
    out = torch.empty((B, L, 2 * hidden), dtype=dtype, device=device)
    ptrs = _pointers([proto, z, wq, wf, res, out], device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.wgg_bilstm_train_fwd_mma(*ptrs, B, L, hidden, static.shape[1], n, stream)
    _raise_on(lib, err, "bilstm_train_fwd (tensor-core path)")
    return out, res


def _launch_bwd_mma(layers, x, static, res, dy, hidden, dtype):
    lib = _library()
    device = x.device
    n, _, L, B, _ = res.shape
    H, Z = hidden, static.shape[1]
    f32 = torch.float32
    tiles = -(-B // SAMPLE_TILE)
    splits = _wgrad_splits(L, n)
    m_first, m_rest = 2 + Z + H + 1, 3 * H + 1

    def empty(shape, dt=f32):
        return torch.empty(shape, dtype=dt, device=device)

    operands = [
        res.contiguous(),
        empty((L, B, 2 * H), dtype).copy_(dy.transpose(0, 1)),                   # dy, position-major
        x.to(dtype).contiguous(), static.to(dtype).contiguous(), packed_weights(layers, dtype)[1],
        empty((n * 2, L, tiles, 2, 4 * H, SAMPLE_TILE), dtype),                 # split gate grads
        empty((2, 2, L, B, 2 * H) if n > 1 else (8,), dtype),                    # input gradients
        empty((2, B, L, 2), dtype),                                              # dx streams
        empty((B, max(Z, 1))),                                                   # dz
        empty((splits, 2 * n, 3 * H, 4 * H)),                                    # product partials
        empty((tiles, 2 * n, 4 * H)), empty((tiles, 2, 2, 4 * H)),               # bias, prototype
        empty((tiles, 2, max(Z, 1), 4 * H)),                                     # z rows
        empty((2 * (m_first + (n - 1) * m_rest) * 4 * H,)),
    ]
    ptrs = _pointers(operands, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.wgg_bilstm_train_bwd_mma(*ptrs, B, L, H, Z, n, splits, stream)
    _raise_on(lib, err, "bilstm_train_bwd (tensor-core path)")
    dpa, dz, dw = operands[7], operands[8], operands[13]
    return _gradient_tree(dw, n, H, Z), (dpa[0] + dpa[1]).to(f32), dz[:, :Z]


def _launch_fwd(layers, x, static, hidden, dtype):
    lib = _library()
    device = x.device
    B, L, _ = x.shape
    n = len(layers)
    w = kernel_weights(layers, hidden, dtype)
    proto = x.to(dtype).contiguous()
    z = static.to(torch.float32).contiguous()
    res = torch.empty((n, 2, L, B, 6 * hidden), dtype=dtype, device=device)
    out = torch.empty((B, L, 2 * hidden), dtype=dtype, device=device)
    ptrs = _pointers([proto, z, w["wseq1"], w["wz"], w["whh"], w["wih"], w["bias"], res, out],
                     device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.wgg_bilstm_train_fwd(*ptrs, B, L, hidden, static.shape[1], n,
                                       _DTYPE_CODES[dtype], stream)
    _raise_on(lib, err, "bilstm_train_fwd")
    return out, res


def _launch_bwd(layers, x, static, res, dy, hidden, dtype):
    lib = _library()
    device = x.device
    n, _, L, B, _ = res.shape
    H, Z = hidden, static.shape[1]
    f32 = torch.float32
    w = backward_weights(layers, hidden, dtype)
    m_first, m_rest = 2 + Z + H + 1, 3 * H + 1     # rows of [dW_ih; dW_hh; db] per layer
    m_max = max(m_first, m_rest) if n > 1 else m_first
    splits = _splits(L * B)
    operands = [
        res.contiguous(), dy.to(dtype).contiguous(), x.to(dtype).contiguous(),
        static.to(dtype).contiguous(), w["whhT"], w["wihT"], w["wpT"], w["wz"],
        torch.empty((n, 2, L, B, 4 * H), dtype=f32, device=device),                # gate grads
        torch.empty((2, 2, B, L, 2 * H) if n > 1 else (1,), dtype=dtype, device=device),
        torch.empty((2, B, L, 2), dtype=dtype, device=device),                     # dx streams
        torch.empty((B, Z), dtype=f32, device=device),                              # dz
        torch.empty((splits, 2 * n, m_max, 4 * H), dtype=f32, device=device),      # partials
        torch.empty((2 * (m_first + (n - 1) * m_rest) * 4 * H,), dtype=f32, device=device),
    ]
    ptrs = _pointers(operands, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.wgg_bilstm_train_bwd(*ptrs, B, L, H, Z, n, splits, _DTYPE_CODES[dtype], stream)
    _raise_on(lib, err, "bilstm_train_bwd")
    dpa, dz, dw = operands[10], operands[11], operands[13]
    return _gradient_tree(dw, n, H, Z), (dpa[0] + dpa[1]).to(f32), dz


_LAUNCHERS = {"mma": (_launch_fwd_mma, _launch_bwd_mma), "fp32": (_launch_fwd_fp32, _launch_bwd_fp32),
              "general": (_launch_fwd, _launch_bwd)}


def _count(wrapper, path: str) -> None:
    wrapper.launches += 1
    wrapper.launches_by_path[path] += 1


def _dispatch(x: torch.Tensor) -> bool:
    """True to launch the kernel (CUDA tensor), False for the plain version
    (CPU tensor); any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type == "cuda"


def bilstm_train_fwd(layers: List[Dict], x: torch.Tensor, static: torch.Tensor, hidden: int,
                     dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 2 on a CUDA ``x`` (``bilstm_train_fwd.launches`` counts the
    launches; the path is ``kernel_path``'s), ``bilstm_train_fwd_plain`` on a
    CPU one. Not differentiated."""
    _check(layers, x, hidden, static, dtype)
    with torch.no_grad():
        if _dispatch(x):
            path = kernel_path(dtype, hidden, x.shape[1], len(layers))
            result = _LAUNCHERS[path][0](layers, x, static, hidden, dtype)
            _count(bilstm_train_fwd, path)
            return result
        return bilstm_train_fwd_plain(layers, x, static, hidden, dtype)


def bilstm_train_bwd(layers: List[Dict], x: torch.Tensor, static: torch.Tensor,
                     res: torch.Tensor, dy: torch.Tensor, hidden: int, dtype: torch.dtype):
    """Kernel 3 on CUDA tensors (``bilstm_train_bwd.launches`` counts the
    launches; the path is ``kernel_path``'s), ``bilstm_train_bwd_plain`` on
    CPU ones. Not differentiated."""
    if res.shape != (len(layers), 2, x.shape[1], x.shape[0], 6 * hidden) or res.dtype != dtype:
        raise ValueError(f"residuals {tuple(res.shape)} {res.dtype} do not fit the stack")
    if dy.shape != (x.shape[0], x.shape[1], 2 * hidden):
        raise ValueError(f"dy must be (B, L, 2H), got {tuple(dy.shape)}")
    with torch.no_grad():
        if _dispatch(x):
            path = kernel_path(dtype, hidden, x.shape[1], len(layers))
            result = _LAUNCHERS[path][1](layers, x, static, res, dy, hidden, dtype)
            _count(bilstm_train_bwd, path)
            return result
        return bilstm_train_bwd_plain(layers, x, static, res, dy, hidden, dtype)


bilstm_train_fwd.launches = 0
bilstm_train_bwd.launches = 0
bilstm_train_fwd.launches_by_path = {"mma": 0, "fp32": 0, "general": 0}
bilstm_train_bwd.launches_by_path = {"mma": 0, "fp32": 0, "general": 0}


# ---------------------------------------------------------------------------
# The autograd Function
# ---------------------------------------------------------------------------


class _BiLSTMTrain(torch.autograd.Function):
    """Forward: kernel 2, residuals saved. Backward: kernel 3."""

    @staticmethod
    def forward(ctx, hidden, dtype, x, static, *weights):
        layers = _unflatten(weights, len(weights) // 8)
        y, res = bilstm_train_fwd(layers, x, static, hidden, dtype)
        ctx.hidden, ctx.dtype = hidden, dtype
        ctx.save_for_backward(x, static, res, *weights)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, static, res, *weights = ctx.saved_tensors
        layers = _unflatten(weights, len(weights) // 8)
        grads, dx, dz = bilstm_train_bwd(layers, x, static, res, dy, ctx.hidden, ctx.dtype)
        flat = [cell[d][name] for cell in grads for d in _DIRS for name in _CELL]
        return (None, None, dx if ctx.needs_input_grad[2] else None,
                dz.to(static.dtype) if ctx.needs_input_grad[3] else None,
                *[g.to(w.dtype) for g, w in zip(flat, weights)])


def bilstm_train_apply(layers: List[Dict], x: torch.Tensor, static: torch.Tensor, hidden: int,
                       dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Differentiable fused BiLSTM stack: (B, L, 2) + static (B, Z) → (B, L, 2H)
    in ``dtype``, any B >= 1 (the JAX package's signature).

    ``layers`` is the tree ``[k]["fwd" | "bwd"]["w_ih" | "w_hh" | "b_ih" |
    "b_hh"]``. Every weight, ``static`` and, where asked for, ``x`` receive a
    gradient from kernel 3 (CUDA) or its plain version (CPU)."""
    _check(layers, x, hidden, static, dtype)
    weights = [layer[d][name] for layer in layers for d in _DIRS for name in _CELL]
    return _BiLSTMTrain.apply(hidden, dtype, x, static, *weights)
