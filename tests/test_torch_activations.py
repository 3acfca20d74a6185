"""The activations' dispatch (``ops/activations.py``) on the CPU.

``models/layers.py``'s ``gelu`` and ``leaky_relu`` take the CUDA kernels for
a CUDA tensor in bfloat16 or float32 and the plain op-by-op functions
(``plain_gelu``, ``plain_leaky_relu``) for any other tensor. Here: CPU
tensors of every dtype take the plain path, and the counter says so; the
dispatcher's results on the CPU are the plain functions' bit for bit,
gradients included; the layout helpers that hand the kernels their
operands; the graph's launch counters; the kernel source's bfloat16
constants against the plain path's. The kernels themselves are held against
the plain functions on the card in ``tests/test_torch_cuda.py``. No JAX.
"""

import re

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test worker

from wordgesture_gan_tpu_torch.models import layers
from wordgesture_gan_tpu_torch.ops import activations
from wordgesture_gan_tpu_torch.ops.activations import activation_launches
from wordgesture_gan_tpu_torch.ops.build import CSRC_DIR, library_path
from wordgesture_gan_tpu_torch.train import step_graph

ACTIVATIONS = {"gelu": (layers.gelu, layers.plain_gelu, "gelu"),
               "leaky_relu": (layers.leaky_relu, layers.plain_leaky_relu, "leaky")}


def _grid(dtype: torch.dtype) -> torch.Tensor:
    """Every bfloat16 value; in float32 also N(0, 3^2) draws and the edges of
    XLA's tanh (its clamp, saturation and small-argument branch)."""
    every = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    if dtype == torch.bfloat16:
        return every
    rng = np.random.default_rng(0)
    edges = [7.99881172180175781, -7.99881172180175781, 20.0, -20.0, 3.9e-4, -3.9e-4, 4e-4]
    return torch.cat([every.float(), torch.from_numpy(rng.normal(0, 3, 1 << 16).astype(np.float32)),
                      torch.tensor(edges)])


def _bits_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements whose bits differ (NaN counts as equal to NaN)."""
    a, b = a.detach().float(), b.detach().float()
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())
    return int((~same).sum())


def _forward_backward(fn, x: torch.Tensor, g: torch.Tensor):
    x = x.detach().clone().requires_grad_()
    y = fn(x)
    y.backward(g)
    return y, x.grad


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16, torch.float64])
@pytest.mark.parametrize("name", list(ACTIVATIONS))
def test_cpu_tensors_take_the_plain_path(name, dtype):
    """Every CPU tensor, whatever its dtype, takes the plain function: one
    plain forward and, once autograd reaches it, one plain backward; no
    kernel launch."""
    fn, plain, op = ACTIVATIONS[name]
    x = torch.linspace(-3, 3, 17, dtype=dtype)
    assert not activations.takes_kernel(x)
    before = dict(activation_launches.launches_by_path), activation_launches.launches
    y, dx = _forward_backward(fn, x, torch.ones_like(x))
    want_y, want_dx = _forward_backward(plain, x, torch.ones_like(x))
    assert torch.equal(y, want_y) and torch.equal(dx, want_dx)
    moved = {k: v - before[0][k] for k, v in activation_launches.launches_by_path.items()
             if v != before[0][k]}
    assert moved == {(f"{op}_fwd", "plain"): 1, (f"{op}_bwd", "plain"): 1}
    assert activation_launches.launches == before[1]


@pytest.mark.parametrize("name", list(ACTIVATIONS))
def test_plain_path_without_autograd_counts_no_backward(name):
    fn, _, op = ACTIVATIONS[name]
    before = dict(activation_launches.launches_by_path)
    with torch.no_grad():
        fn(torch.randn(4, 3, requires_grad=True))
    assert activation_launches.launches_by_path[(f"{op}_fwd", "plain")] == \
        before[(f"{op}_fwd", "plain")] + 1
    assert activation_launches.launches_by_path[(f"{op}_bwd", "plain")] == \
        before[(f"{op}_bwd", "plain")]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(ACTIVATIONS))
def test_dispatcher_equals_the_plain_function_on_the_cpu(name, dtype):
    """The dispatcher's forward and gradient on the CPU are the plain
    function's bit for bit, over every bfloat16 input (and float32 draws),
    against a cotangent drawn in numpy."""
    fn, plain, _ = ACTIVATIONS[name]
    x = _grid(dtype)
    g = torch.from_numpy(np.random.default_rng(1).normal(size=x.shape[0]).astype(np.float32))
    got = _forward_backward(fn, x, g.to(dtype))
    want = _forward_backward(plain, x, g.to(dtype))
    assert got[0].dtype == dtype and got[1].dtype == dtype
    assert _bits_differ(got[0], want[0]) == 0
    assert _bits_differ(got[1], want[1]) == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_leaky_relu_gradient_sends_a_negative_zero_cotangent_back_as_zero(dtype):
    """The plain chain's gradient is autograd's of where(x >= 0, x, x *
    slope): where(c, g, 0) + where(c, 0, g) * slope, so a -0 cotangent comes
    back +0 on both sides of 0 (the kernel computes it the same way)."""
    x = torch.tensor([1.0, -1.0, 0.0, -0.0], dtype=dtype, requires_grad=True)
    layers.plain_leaky_relu(x).backward(torch.full((4,), -0.0, dtype=dtype))
    assert torch.equal(x.grad.float().view(torch.int32), torch.zeros(4, dtype=torch.int32))


def _conv_like(batch: int = 3, channels: int = 5, length: int = 7) -> torch.Tensor:
    """A conv1d output in the port's layout: (B, C, L) transposed to (B, L, C),
    plus a bias: dense, not contiguous."""
    out = torch.randn(batch, channels, length).transpose(1, 2)
    return out + torch.randn(channels)


@pytest.mark.parametrize("make,dense", [
    (lambda: torch.randn(4, 6), True),
    (lambda: torch.randn(4, 6).t(), True),
    (_conv_like, True),
    (lambda: torch.randn(4, 6)[:, ::2], False),
    (lambda: torch.randn(4, 1).expand(4, 6), False),
    (lambda: torch.randn(4, 6)[1:3], True),
    (lambda: torch.randn(4, 1, 6)[:, :, 2:3], False),
    (lambda: torch.randn(5, 1).as_strided((5, 1), (1, 7)), True),
    (lambda: torch.tensor(2.0), True),
    (lambda: torch.randn(0, 3), True),
])
def test_is_dense_names_what_the_kernels_read_in_place(make, dense):
    """Non-overlapping and dense, in some order of the dimensions: the
    kernels read such a tensor over its storage; any other is made
    contiguous first."""
    x = make()
    assert activations.is_dense(x) is dense
    assert activations.is_dense(x.contiguous())


def test_a_dense_input_keeps_its_layout_in_the_output():
    """``torch.empty_like`` of a dense tensor has its strides: the kernel's
    output lies in its input's order."""
    x = _conv_like()
    assert not x.is_contiguous()
    assert torch.empty_like(x).stride() == x.stride()


@pytest.mark.parametrize("make_g,copied", [
    (lambda x: torch.randn_like(x), False),
    (lambda x: torch.randn(x.shape).contiguous(), True),
    (lambda x: torch.ones(()).expand(x.shape), True),
])
def test_in_layout_of_copies_a_cotangent_only_when_its_strides_differ(make_g, copied):
    x = _conv_like()
    g = make_g(x)
    got = activations.in_layout_of(g, x)
    assert (got is not g) is copied
    assert activations.same_layout(got, x) and torch.equal(got, g)


def test_step_graph_replays_add_the_activation_launches():
    """A replayed graph adds the launches its capture counted, the
    activations' among them."""
    assert activation_launches in step_graph.COUNTED
    assert set(activation_launches.launches_by_path) == {
        (op, path) for op in activations.OPS for path in activations.PATHS}


def test_kernel_states_the_plain_paths_bfloat16_constants():
    """The bfloat16 constants written into ``csrc/activations.cu`` are the
    plain path's (0.044715 and sqrt(2/pi) rounded to bfloat16), and the
    kernel's library is named like every other kernel's."""
    source = (CSRC_DIR / "activations.cu").read_text()
    bf16 = source[source.index("struct BF16"):]
    stated = [float(re.search(rf"{name} = ([0-9.]+)f;", bf16).group(1)) for name in ("kC1", "kC2")]
    assert tuple(stated) == layers._Gelu.constants(torch.bfloat16)
    assert library_path(activations.KERNEL).name.startswith("libactivations-")


def test_kernel_op_codes_follow_the_source():
    """``KERNEL_OPS`` names the ops of ``csrc/activations.cu`` in the order of
    its ``Op`` codes; leaky_relu's forward is PyTorch's and has none."""
    source = (CSRC_DIR / "activations.cu").read_text()
    enum = re.search(r"enum Op \{([^}]*)\}", source).group(1)
    codes = {name.strip(): int(code) for name, code in
             (item.split("=") for item in enum.split(","))}
    named = {f"k{''.join(w.capitalize() for w in op.split('_'))}": i
             for i, op in enumerate(activations.KERNEL_OPS)}
    assert codes == named
    assert set(activations.KERNEL_OPS) == set(activations.OPS) - {"leaky_fwd"}
