"""The layer norm's dispatch (``ops/layernorm.py``) on the CPU.

``models/generators.py``'s ``_layernorm`` hands x, the scale and the bias to
``ops.layernorm.layernorm``: a CUDA tensor takes the kernels of
``csrc/layernorm.cu``, a CPU tensor the plain chain ``plain_layernorm``.
Here: the CPU path equals the chain as it was written inline before the
kernels, bit for bit, forward and gradients, in bfloat16 and float32; the
plain chain against the JAX package's ``_layernorm`` on the same arrays
(float32 within float32 rounding, gradients included; the bfloat16 forward
bit for bit, as ``tests/test_torch_bf16_parity.py`` holds the model's norms);
the counters of plain calls; the shapes and dtypes the kernels refuse; the
graph's launch counters; the kernel source's op codes and limits against
the wrapper's. The kernels themselves are held against the plain chain on
the card in ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 5n.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test worker

from wordgesture_gan_tpu.models import generators as jax_generators
from wordgesture_gan_tpu_torch.models import generators
from wordgesture_gan_tpu_torch.ops import layernorm
from wordgesture_gan_tpu_torch.ops.build import CSRC_DIR, library_path
from wordgesture_gan_tpu_torch.ops.layernorm import layernorm_launches, plain_layernorm
from wordgesture_gan_tpu_torch.train import step_graph

SHAPE = (4, 9, 16)


def _inline_layernorm(params, x, eps=1e-5):
    """``generators._layernorm`` as it was written before the kernels."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return out.to(x.dtype) * params["scale"].to(x.dtype) + params["bias"].to(x.dtype)


def _arrays(seed: int = 9, shape=SHAPE):
    """x (N(1, 3^2)), scale, bias and a cotangent, float32 numpy."""
    rng = np.random.default_rng(seed)
    d = shape[-1]
    return (rng.normal(1, 3, shape).astype(np.float32), rng.normal(1, 0.3, d).astype(np.float32),
            rng.normal(0, 0.3, d).astype(np.float32), rng.normal(size=shape).astype(np.float32))


def _run(fn, x, scale, bias, g):
    """Output and the gradients of x, scale and bias."""
    leaves = [t.detach().clone().requires_grad_() for t in (x, scale, bias)]
    out = fn({"scale": leaves[1], "bias": leaves[2]}, leaves[0])
    out.backward(g)
    return [out] + [t.grad for t in leaves]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().view(torch.int32)


@pytest.mark.parametrize("params_dtype", [torch.float32, "x"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_path_equals_the_inline_chain_bit_for_bit(dtype, params_dtype):
    """The dispatcher's CPU path gives the inline chain's bits: the output
    and the gradients of x, the scale and the bias, with float32 parameters
    (cast inside) and with parameters already in x's dtype (the blocks'
    norms, after ``cast_floats``)."""
    x, scale, bias, g = (torch.from_numpy(a) for a in _arrays())
    x, g = x.to(dtype), g.to(dtype)
    pdtype = dtype if params_dtype == "x" else params_dtype
    scale, bias = scale.to(pdtype), bias.to(pdtype)
    got = _run(generators._layernorm, x, scale, bias, g)
    want = _run(_inline_layernorm, x, scale, bias, g)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _jax_layernorm(x, scale, bias, g, dtype):
    """JAX's ``_layernorm`` of x in ``dtype`` with float32 parameters: the
    output and the gradients of x, scale and bias (``jax.vjp``)."""
    fn = lambda x_, s, b: jax_generators._layernorm({"scale": s, "bias": b}, x_)
    out, vjp = jax.vjp(fn, jnp.asarray(x, dtype), jnp.asarray(scale), jnp.asarray(bias))
    return [np.asarray(t, np.float32) for t in (out, *vjp(jnp.asarray(g, dtype)))]


def test_plain_chain_equals_jax_in_float32():
    """float32: the output within 1e-6 and each gradient within 1e-5 of its
    largest magnitude (the sums' order and autodiff's form of the variance)."""
    arrays = _arrays(seed=3)
    want = _jax_layernorm(*arrays, jnp.float32)
    fn = lambda p, x: plain_layernorm(x, p["scale"], p["bias"])
    got = _run(fn, *(torch.from_numpy(a) for a in arrays))
    np.testing.assert_allclose(got[0].detach().numpy(), want[0], rtol=0, atol=1e-6)
    for name, a, b in zip(("dx", "dscale", "dbias"), got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("seed", [3, 4])
def test_plain_chain_equals_jax_in_bfloat16_forward_bit_for_bit(seed):
    """bfloat16 x with float32 parameters, as the blocks' norms run under
    JAX's rules: the output bit-equal to JAX's."""
    x, scale, bias, _ = _arrays(seed=seed, shape=(6, 11, 64))
    want = jax_generators._layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                                     jnp.asarray(x, jnp.bfloat16))
    got = plain_layernorm(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(scale),
                          torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def _moved(before: dict) -> dict:
    return {k: v - before[k] for k, v in layernorm_launches.launches_by_path.items()
            if v != before[k]}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16, torch.float64])
def test_cpu_tensors_count_plain_calls(dtype):
    """Every CPU tensor, whatever its dtype, takes the plain chain: one plain
    forward and, once autograd reaches it, one plain backward; no launch."""
    x, scale, bias, g = (torch.from_numpy(a).to(dtype) for a in _arrays())
    before, launches = dict(layernorm_launches.launches_by_path), layernorm_launches.launches
    _run(generators._layernorm, x, scale, bias, g)
    assert _moved(before) == {("layernorm_fwd", "plain"): 1, ("layernorm_bwd", "plain"): 1}
    assert layernorm_launches.launches == launches


def test_plain_path_without_autograd_counts_no_backward():
    x, scale, bias, _ = (torch.from_numpy(a) for a in _arrays())
    before = dict(layernorm_launches.launches_by_path)
    with torch.no_grad():
        layernorm.layernorm(x, scale, bias)
    layernorm.layernorm(x, scale, bias)          # no input asks for a gradient
    assert _moved(before) == {("layernorm_fwd", "plain"): 2}


@pytest.mark.parametrize("shape,dtype,match", [
    ((4, 64), torch.float16, "float32 or bfloat16"),
    ((4, 64), torch.float64, "float32 or bfloat16"),
    ((4, 0), torch.bfloat16, "last dimension of 1 to 1024"),
    ((2, 3, 1025), torch.float32, "last dimension of 1 to 1024"),
    ((), torch.float32, "last dimension of 1 to 1024"),
])
def test_shapes_the_kernels_refuse_raise(shape, dtype, match):
    """A shape or dtype off the kernels' ground raises ValueError naming it."""
    with pytest.raises(ValueError, match=match):
        layernorm.check_shape(torch.zeros(shape, dtype=dtype))


@pytest.mark.parametrize("shape", [(1, 1), (1024, 128, 64), (512, 128, 64), (3, 37), (2, 1024),
                                   (5, 100), (0, 48)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_shapes_the_kernels_take_pass(shape, dtype):
    layernorm.check_shape(torch.empty(shape, dtype=dtype, device="meta"))


def test_step_graph_replays_add_the_layernorm_launches():
    """A replayed graph (``StepGraph``, and ``SampleGraph`` through the same
    list) adds the launches its capture counted, the layer norms' among
    them, by direction and path."""
    assert layernorm_launches in step_graph.COUNTED
    assert set(layernorm_launches.launches_by_path) == {
        (op, path) for op in layernorm.OPS for path in layernorm.PATHS}


def test_kernel_op_codes_follow_the_source():
    """``OPS`` names the ops of ``csrc/layernorm.cu`` in the order of its
    ``Op`` codes; its widest row is the wrapper's; the backward's scratch
    holds as many blocks as a multiprocessor keeps of its 256-thread blocks;
    its kernels carry the ``layernorm_`` prefix; its library is named like
    the others."""
    source = (CSRC_DIR / "layernorm.cu").read_text()
    enum = re.search(r"enum Op \{([^}]*)\}", source).group(1)
    codes = {name.strip(): int(code) for name, code in
             (item.split("=") for item in enum.split(","))}
    named = {"k" + {"fwd": "Forward", "bwd": "Backward"}[op.split("_")[-1]]: i
             for i, op in enumerate(layernorm.OPS)}
    assert codes == named
    assert int(re.search(r"kMaxDim = (\d+);", source).group(1)) == layernorm.MAX_DIM
    threads = int(re.search(r"kThreads = (\d+);", source).group(1))
    assert layernorm._BLOCKS_PER_SM * threads == 2048     # an H100 SM's most threads
    kernels = re.findall(r"__global__ void __launch_bounds__\(.*?\)\s+(\w+)\(", source)
    assert len(kernels) == 3 and all(k.startswith("layernorm_") for k in kernels)
    assert library_path(layernorm.KERNEL).name.startswith("liblayernorm-")
