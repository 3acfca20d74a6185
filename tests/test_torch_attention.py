"""The attention core's dispatch (``ops/attention.py``) on the CPU.

``models/generators.py``'s ``_attention`` hands the packed projections to
``ops.attention.attention``: a CUDA tensor takes the kernels of
``csrc/attention.cu``, a CPU tensor the plain chain ``plain_attention``.
Here: the CPU path equals the chain as it was written inline before the
kernels, bit for bit, forward and gradients, in bfloat16 and float32, with
and without a padding mask (one row all padding); the counter of plain
calls; the shapes and dtypes the kernels refuse; the graph's launch
counters; the kernel source's limits against the wrapper's (that the
wrapper imports no JAX is ``tests/test_torch_serving.py``'s). The kernels
themselves are held against the plain chain on the card in
``tests/test_torch_cuda.py``. No JAX.
"""

import math
import re

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test worker

from wordgesture_gan_tpu_torch.models import generators
from wordgesture_gan_tpu_torch.models.layers import dense_init
from wordgesture_gan_tpu_torch.ops import attention
from wordgesture_gan_tpu_torch.ops.attention import attention_launches
from wordgesture_gan_tpu_torch.ops.build import CSRC_DIR, library_path
from wordgesture_gan_tpu_torch.train import step_graph
from wordgesture_gan_tpu_torch.utils import prng

B, L, HEADS, HEAD = 3, 12, 2, 8


def _inline_attention(block, x, num_heads, pad_mask):
    """``generators._attention`` as it was written before the kernels: the
    chain inline, the padding logits from ``torch.full_like``."""
    B, L, D = x.shape
    head = D // num_heads
    qkv = generators._dense(block["qkv"], x).reshape(B, L, 3, num_heads, head)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    logits = (q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2)) / math.sqrt(head)
    if pad_mask is not None:
        logits = torch.where(pad_mask[:, None, None, :] > 0, logits,
                             torch.full_like(logits, -1e30))
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    out = (attn @ v).transpose(1, 2).reshape(B, L, D)
    return generators._dense(block["attn_out"], out)


def _inputs(dtype):
    D = HEADS * HEAD
    keys = prng.split(prng.PRNGKey(5), 2)
    block = {"qkv": dense_init(D, 3 * D, keys[0]), "attn_out": dense_init(D, D, keys[1])}
    block = {name: {k: v.to(dtype) for k, v in p.items()} for name, p in block.items()}
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(0, 2, (B, L, D)).astype(np.float32)).to(dtype)
    lengths = [L, 5, 0]                              # the last row is all padding
    mask = torch.tensor([[1.0 if j < n else 0.0 for j in range(L)] for n in lengths])
    g = torch.from_numpy(rng.normal(size=(B, L, D)).astype(np.float32)).to(dtype)
    return block, x, mask, g


def _run(fn, block, x, mask, g):
    """Output, and the gradients of x and of the projection weights."""
    x = x.detach().clone().requires_grad_()
    leaves = {name: {k: v.detach().clone().requires_grad_() for k, v in p.items()}
              for name, p in block.items()}
    out = fn(leaves, x, HEADS, mask)
    out.backward(g)
    return [out, x.grad] + [leaves[n][k].grad for n in ("qkv", "attn_out") for k in ("w", "b")]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().view(torch.int32)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_path_equals_the_inline_chain_bit_for_bit(dtype, masked):
    """The dispatcher's CPU path (``plain_attention``, the scalar -1e30)
    gives the inline chain's bits: the output, x's gradient and the
    projections' gradients; a row of padding keys only stays finite."""
    block, x, mask, g = _inputs(dtype)
    mask = mask if masked else None
    got = _run(generators._attention, block, x, mask, g)
    want = _run(_inline_attention, block, x, mask, g)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    assert all(torch.isfinite(t).all() for t in got)


def test_cpu_tensors_count_plain_calls():
    """One plain forward and, once autograd reaches it, one plain backward; no
    launch counted."""
    block, x, mask, g = _inputs(torch.float32)
    before = dict(attention_launches.launches_by_path), attention_launches.launches
    _run(generators._attention, block, x, mask, g)
    moved = {k: v - before[0][k] for k, v in attention_launches.launches_by_path.items()
             if v != before[0][k]}
    assert moved == {("attention_fwd", "plain"): 1, ("attention_bwd", "plain"): 1}
    assert attention_launches.launches == before[1]


@pytest.mark.parametrize("shape,dtype,match", [
    ((2, 12, 3, 2, 8), torch.float16, "float32 or bfloat16"),
    ((2, 12, 3, 2, 12), torch.bfloat16, "multiple of 8"),
    ((2, 12, 3, 2, 72), torch.float32, "multiple of 8"),
    ((2, 257, 3, 2, 16), torch.bfloat16, "lengths up to 256"),
    ((2, 12, 2, 16), torch.bfloat16, r"\(B, L, 3, H, h\)"),
])
def test_shapes_the_kernels_refuse_raise(shape, dtype, match):
    """A shape or dtype off the kernels' ground raises ValueError naming it."""
    with pytest.raises(ValueError, match=match):
        attention.check_shape(torch.zeros(shape, dtype=dtype))


@pytest.mark.parametrize("shape", [(1, 1, 3, 1, 8), (1024, 128, 3, 4, 16), (512, 128, 3, 8, 8),
                                   (2, 256, 3, 1, 64), (2, 200, 3, 3, 40)])
def test_shapes_the_kernels_take_pass(shape):
    attention.check_shape(torch.empty(shape, dtype=torch.bfloat16, device="meta"))


def test_step_graph_replays_add_the_attention_launches():
    assert attention_launches in step_graph.COUNTED
    assert set(attention_launches.launches_by_path) == {
        (op, path) for op in attention.OPS for path in attention.PATHS}


def test_kernel_source_states_the_wrappers_limits():
    """``csrc/attention.cu``'s length and head limits are the wrapper's, its
    padding logit the chain's -1e30, its kernels carry the prefix the
    benchmark finds them by, and its library is named like the others."""
    source = (CSRC_DIR / "attention.cu").read_text()
    assert int(re.search(r"kMaxLen = (\d+);", source).group(1)) == attention.MAX_LEN
    assert int(re.search(r"kMaxHead = (\d+);", source).group(1)) == attention.MAX_HEAD
    assert float(re.search(r"kMasked = ([-0-9.e]+)f;", source).group(1)) == -1e30
    kernels = re.findall(r"__global__ void __launch_bounds__\(.*?\)\s+(\w+)\(", source)
    assert len(kernels) == 4 and all(k.startswith("attn_core_") for k in kernels)
    assert library_path(attention.KERNEL).name.startswith("libattention-")

