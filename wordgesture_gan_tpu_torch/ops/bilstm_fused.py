"""Fused whole-stack BiLSTM inference forward: the wrapper of the CUDA kernels
in ``csrc/bilstm_fused.cu``, its plain PyTorch version, and the weight
layouts the kernels read.

Port of the JAX package's ``ops/bilstm_fused.py`` (the Pallas TPU kernel
``_kernel``, launched by ``_fused_call``, wrapped by ``fused_bilstm_fwd``).
It computes the generator's stacked bidirectional LSTM — all layers, both
directions — for a 2-d prototype input and a time-constant latent that
enters layer 1 as a static input (``w_ih`` rows ordered [proto | z]).

Casting contract (the fused kernel's, not the plain scan's): gate sums,
nonlinearities and the cell state are float32; h is rounded to the compute
dtype every step; the layer-1 latent projection is float32 from float32
weights and z; sequence and recurrent weights are rounded to the compute
dtype, biases stay float32. The kernels' source note says what bounds them
on an H100 and how they are laid out.

Dispatch: tensors on the CPU take ``fused_bilstm_fwd_plain``; tensors on a
CUDA device launch a kernel, and a build or launch failure raises. There
is no other path. Inference only: nothing here is differentiated.

Three kernel paths, chosen by ``kernel_path`` from the compute dtype and the
shape alone (never by trying one and falling back):

* ``"mma"`` — bfloat16 with H in {16, 32, 48} (the flagship recipe and
  serving: H=48), any B, L, Z and depth: the tensor-core kernel (``mma.sync``
  bf16 with float32 accumulation, 8 samples per CTA), W_hh held in registers
  for a whole layer, the input projection on producer warps ahead of the
  recurrence; the step the training forward shares (``csrc/bilstm_step.cuh``);
* ``"fp32"`` — float32 (the default compute dtype) at the same H: full
  float32 products on the CUDA cores, one direction per CTA of a two-CTA
  cluster so that a layer's weights stay in registers, the input projection
  on producer threads fed by bulk copies; ``sample_tile`` samples per cluster;
* ``"general"`` — any other H <= 256 in either dtype: the first CUDA-core
  kernel, which reads ``kernel_weights``' re-laid-out weights.

The first two read the packed weights (``packed_weights``: one flat buffer in
the model's own layout, one concatenation and one cast per call).
``fused_bilstm_fwd.launches`` counts all launches, ``.launches_by_path`` the
launches of each path. The counts are bumped in Python where a launch is
made; a replayed CUDA graph of a train step makes none there, so each replay
adds the launches its capture counted (``train/step_graph.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch

KERNEL = "bilstm_fused"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CELL = ("w_ih", "w_hh", "b_ih", "b_hh")
_DIRS = ("fwd", "bwd")
# Hidden sizes the tensor-core kernels (and the float32 inference kernel) are
# instantiated for, and the samples a CTA of the tensor-core kernels owns.
MMA_HIDDEN = (16, 32, 48)
SAMPLE_TILE = 8
# The float32 inference kernel owns 8 samples per two-CTA cluster, or 4 where
# 8 would leave more than half of an H100's 132 SMs without a CTA.
_FP32_SMALL_BATCH = 264


# ---------------------------------------------------------------------------
# Which kernel, and the layouts the kernels read
# ---------------------------------------------------------------------------


def _check_path_shape(seq: int, layers: int) -> None:
    if seq < 1 or layers < 1:
        raise ValueError(f"need at least one position and one layer, got L={seq}, {layers} layers")


def kernel_path(dtype: torch.dtype, hidden: int, seq: int, layers: int) -> str:
    """Which kernel a CUDA call of ``fused_bilstm_fwd`` takes: ``"mma"``
    (tensor cores) for bfloat16 and ``"fp32"`` for float32 with H in
    ``MMA_HIDDEN``, ``"general"`` otherwise. A pure function of the dtype and
    the shape; every sequence length and depth is served by all three, so
    ``seq`` and ``layers`` do not change the answer."""
    _check_path_shape(seq, layers)
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
    if hidden not in MMA_HIDDEN:
        return "general"
    return "mma" if dtype == torch.bfloat16 else "fp32"


def sample_tile(dtype: torch.dtype, batch: int) -> int:
    """Samples per CTA (``"mma"``) or per two-CTA cluster (``"fp32"``): the
    granularity of the scratch layout. A pure function of dtype and batch."""
    if dtype == torch.bfloat16:
        return SAMPLE_TILE
    return 4 if batch <= _FP32_SMALL_BATCH else 8


def scratch_shape(batch: int, seq: int, hidden: int, n_layers: int, tile: int) -> Tuple[int, ...]:
    """The buffers through which the rows of the layers under the top one pass
    (``"mma"`` and ``"fp32"`` paths): (buffers, tiles, L, tile, 2H), layer k
    writing buffer k % 2 and reading buffer (k - 1) % 2. The tiles are whole:
    samples past the batch are computed from zeros and stay here."""
    return (min(n_layers - 1, 2), -(-batch // tile), seq, tile, 2 * hidden)


def scratch_row_offset(sample: int, pos: int, seq: int, hidden: int, tile: int) -> int:
    """Offset (in elements, within one buffer) of sample ``sample``'s row at
    position ``pos``: the kernels' own arithmetic. Each tile's rows are one
    contiguous block of L·tile·2H elements."""
    return ((sample // tile * seq + pos) * tile + sample % tile) * 2 * hidden


def packed_sizes(hidden: int, latent: int, n_layers: int) -> List[Tuple[int, ...]]:
    """Shapes of the packed weights' tensors, in their order: per layer, per
    direction, w_ih (din, 4H), w_hh (H, 4H), b_ih (4H,), b_hh (4H,), with
    din = 2 + Z for layer 1 and 2H above (``csrc/bilstm_step.cuh``:
    ``cell_offsets``)."""
    shapes = []
    for k in range(n_layers):
        din = 2 + latent if k == 0 else 2 * hidden
        for _ in _DIRS:
            shapes += [(din, 4 * hidden), (hidden, 4 * hidden), (4 * hidden,), (4 * hidden,)]
    return shapes


def packed_weights(layers: List[Dict], dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stack's weights for the ``"mma"`` and ``"fp32"`` kernels (and the
    tensor-core training kernels): one flat float32 buffer of every tensor in
    the model's own (row-major) layout and order, and the same buffer rounded
    to ``dtype``. No padding and no transposition: the kernels build their
    register operands from this layout once per layer. Two small launches (one
    concatenation, one cast)."""
    flat = torch.cat([layer[d][name].reshape(-1).to(torch.float32)
                      for layer in layers for d in _DIRS for name in _CELL])
    return flat, flat.to(dtype)


def _unflatten(weights, n_layers: int) -> List[Dict]:
    it = iter(weights)
    return [{d: {name: next(it) for name in _CELL} for d in _DIRS} for _ in range(n_layers)]


def unpack_weights(flat: torch.Tensor, hidden: int, latent: int, n_layers: int) -> List[Dict]:
    """The inverse of ``packed_weights``: views of ``flat`` as the model's tree."""
    shapes = packed_sizes(hidden, latent, n_layers)
    sizes = [int(torch.Size(shape).numel()) for shape in shapes]
    if flat.numel() != sum(sizes):
        raise ValueError(f"packed weights hold {flat.numel()} values, the stack {sum(sizes)}")
    parts = iter(t.view(shape) for t, shape in zip(flat.split(sizes), shapes))
    return _unflatten(parts, n_layers)


def _gate_layout(w_fwd: torch.Tensor, w_bwd: torch.Tensor, hidden: int) -> torch.Tensor:
    """Two (rows, 4H) direction weights → (rows, 2, H, 4): the i, f, g, o
    weights of one hidden unit contiguous, as the kernel loads them."""
    w = torch.stack([w_fwd, w_bwd], dim=1)                         # (rows, 2, 4H)
    return w.reshape(w.shape[0], 2, 4, hidden).transpose(2, 3)     # (rows, 2, H, 4)


def kernel_weights(layers: List[Dict], hidden: int, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The stack's weights in the general kernels' layout and types (see the
    shapes listed in ``csrc/bilstm_fused.cu``)."""
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
    """The kernels' library (built at first use) with its C signatures declared."""
    from .build import load

    lib = load(KERNEL)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wgg_bilstm_fused_fwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.wgg_bilstm_fused_fwd.restype = i
    lib.wgg_bilstm_fused_fwd_mma.argtypes = [p] * 6 + [i] * 5 + [p]
    lib.wgg_bilstm_fused_fwd_mma.restype = i
    lib.wgg_bilstm_fused_fwd_fp32.argtypes = [p] * 5 + [i] * 6 + [p]
    lib.wgg_bilstm_fused_fwd_fp32.restype = i
    lib.wgg_bilstm_fused_info.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    lib.wgg_bilstm_fused_info.restype = i
    lib.wgg_cuda_error_string.argtypes = [i]
    lib.wgg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.wgg_cuda_error_string(err).decode()} (cudaError {err})")


def _pointers(tensors: List[torch.Tensor], device: torch.device) -> List[int]:
    for t in tensors:
        if t.device != device:
            raise ValueError(f"kernel operand on {t.device}, the prototype on {device}")
        if t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")
    return [t.data_ptr() for t in tensors]


def fused_kernel_info(hidden: int) -> Dict[str, Dict[str, int]]:
    """What the ``"mma"`` and ``"fp32"`` kernels occupy on the current CUDA
    device, asked of the built library: dynamic shared memory per CTA, threads
    per CTA and resident CTAs per SM at this hidden size."""
    lib = _library()
    info = {}
    for code, name in enumerate(("bilstm_fused_mma", "bilstm_fused_fp32_tile8",
                                 "bilstm_fused_fp32_tile4")):
        out = (ctypes.c_int * 3)()
        _raise_on(lib, lib.wgg_bilstm_fused_info(hidden, code, out), name)
        info[name] = {"smem_bytes_per_cta": out[0], "threads_per_cta": out[1],
                      "ctas_per_sm": out[2]}
    return info


def _launch_packed(layers: List[Dict], x: torch.Tensor, hidden: int, static: torch.Tensor,
                   dtype: torch.dtype, tile: Optional[int] = None) -> torch.Tensor:
    """The ``"mma"`` (bfloat16) or ``"fp32"`` (float32) kernel. ``tile``
    overrides ``sample_tile`` (a measurement of the float32 kernel's other
    tile; ``fused_bilstm_fwd`` never passes it)."""
    lib = _library()
    device = x.device
    B, L, _ = x.shape
    n = len(layers)
    tile = tile or sample_tile(dtype, B)
    wf, wq = packed_weights(layers, dtype)
    proto = x.to(dtype).contiguous()
    z = static.to(torch.float32).contiguous()
    out = torch.empty((B, L, 2 * hidden), dtype=dtype, device=device)
    scratch = torch.empty(scratch_shape(B, L, hidden, n, tile) if n > 1 else (8,), dtype=dtype,
                          device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if dtype == torch.bfloat16:
            ptrs = _pointers([proto, z, wq, wf, out, scratch], device)
            err = lib.wgg_bilstm_fused_fwd_mma(*ptrs, B, L, hidden, static.shape[1], n, stream)
        else:
            ptrs = _pointers([proto, z, wf, out, scratch], device)
            err = lib.wgg_bilstm_fused_fwd_fp32(*ptrs, B, L, hidden, static.shape[1], n, tile,
                                                stream)
    _raise_on(lib, err, f"bilstm_fused ({kernel_path(dtype, hidden, L, n)} path)")
    return out


def _launch_general(layers: List[Dict], x: torch.Tensor, hidden: int, static: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    lib = _library()
    device = x.device
    B, L, _ = x.shape
    w = kernel_weights(layers, hidden, dtype)
    proto = x.to(dtype).contiguous()
    z = static.to(torch.float32).contiguous()
    out = torch.empty((B, L, 2 * hidden), dtype=dtype, device=device)
    scratch = torch.empty_like(out) if len(layers) > 1 else out
    ptrs = _pointers([proto, z, w["wseq1"], w["wz"], w["whh"], w["wih"], w["bias"], out, scratch],
                     device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.wgg_bilstm_fused_fwd(*ptrs, B, L, hidden, static.shape[1], len(layers),
                                       _DTYPE_CODES[dtype], stream)
    _raise_on(lib, err, "bilstm_fused")
    return out


_LAUNCHERS = {"mma": _launch_packed, "fp32": _launch_packed, "general": _launch_general}


def fused_bilstm_fwd(layers: List[Dict], x: torch.Tensor, hidden: int,
                     static: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inference-only fused BiLSTM stack: (B, L, 2) + static (B, Z) → (B, L, 2H)
    in ``dtype``, any B >= 1.

    ``layers`` is the JAX-layout tree ``[k]["fwd" | "bwd"]["w_ih" | "w_hh" |
    "b_ih" | "b_hh"]`` (``BiLSTM.params()``). A CUDA ``x`` launches the kernel
    ``kernel_path`` names (``fused_bilstm_fwd.launches`` counts the launches,
    ``.launches_by_path`` those of each path); a CPU ``x`` runs
    ``fused_bilstm_fwd_plain``."""
    _check(layers, x, hidden, static, dtype)
    with torch.no_grad():
        if x.device.type == "cpu":
            return fused_bilstm_fwd_plain(layers, x, hidden, static, dtype)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        path = kernel_path(dtype, hidden, x.shape[1], len(layers))
        out = _LAUNCHERS[path](layers, x, hidden, static, dtype)
        fused_bilstm_fwd.launches += 1
        fused_bilstm_fwd.launches_by_path[path] += 1
        return out


fused_bilstm_fwd.launches = 0
fused_bilstm_fwd.launches_by_path = {"mma": 0, "fp32": 0, "general": 0}
