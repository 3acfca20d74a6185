"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels are compiled by nvcc and run only on the card). The file imports no
JAX, so on the GPU machine it runs on its own:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: float32 with TF32 off 1e-4 (summation order and the device's
transcendentals); bfloat16 2e-2 (h and the residuals rounded to bf16, so a
one-ulp flip propagates). Kernel 1's outputs are compared in absolute terms;
kernels 2 and 3 relative to the largest magnitude of each compared tensor,
because their gradients span orders of magnitude between leaves. Kernels 2
and 3 have three paths (``ops/bilstm_train.py:kernel_path``): at H in
{16, 32, 48} bfloat16 runs on the tensor cores in tiles of 8 samples and
float32 on kernel 1's float32 cluster design (tiles of 4 or 8 samples, the
forward bit-equal to kernel 1's), everything else on the first CUDA-core
kernels; kernel 1 has three (``ops/bilstm_fused.py:kernel_path``):
the tensor-core kernel for bfloat16 and a float32 cluster kernel (tiles of 4
or 8 samples) at those H, the general CUDA-core kernel elsewhere; all are
covered below. Kernel 4
(DTW, float32 only) is held to 1e-4 of each distance: it adds costs along the
path where the plain version subtracts prefix sums. The activation kernels
(gelu, leaky_relu) equal their plain op-by-op chains bit for bit. The
attention kernels sum in another order than the plain chain: their results
are held to it within ``chip_smoke.ATTN_LIMIT`` (its comment gives the
reasons), against float8 controls that must fail; so are the layer norm
kernels' (``chip_smoke.LN_LIMIT``, the same limits, against a float8
control). The bias kernel equals the chain of adds bit for bit, backward
and whole graphed steps included.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test worker

from wordgesture_gan_tpu_torch.configs import ModelConfig
from wordgesture_gan_tpu_torch.models.gan import Generator
from wordgesture_gan_tpu_torch.models import layers
from wordgesture_gan_tpu_torch.models.layers import BiLSTM
from wordgesture_gan_tpu_torch.models import generators
from wordgesture_gan_tpu_torch.ops import attention
from wordgesture_gan_tpu_torch.ops.activations import activation_launches
from wordgesture_gan_tpu_torch.ops.attention import attention_launches
from wordgesture_gan_tpu_torch.ops import layernorm as layernorm_ops
from wordgesture_gan_tpu_torch.ops.layernorm import layernorm_launches
from wordgesture_gan_tpu_torch.ops import bias as bias_ops
from wordgesture_gan_tpu_torch.ops.bias import bias_launches
from wordgesture_gan_tpu_torch.ops import bilstm_fused
from wordgesture_gan_tpu_torch.ops.bilstm_fused import (fused_bilstm_fwd, fused_bilstm_fwd_plain,
                                                        sample_tile)
from wordgesture_gan_tpu_torch.ops import bilstm_train
from wordgesture_gan_tpu_torch.ops.bilstm_train import (bilstm_train_apply, bilstm_train_bwd,
                                                        bilstm_train_bwd_plain, bilstm_train_fwd,
                                                        bilstm_train_fwd_plain, kernel_path)
from wordgesture_gan_tpu_torch.ops.dtw import (dtw_distance_matrix, dtw_matrix, dtw_pairs,
                                               dtw_pairs_plain)
from wordgesture_gan_tpu_torch.utils import prng

pytestmark = pytest.mark.cuda

ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
PLANES = ("h", "c", "i", "f", "g", "o")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is compiled and run only on the GPU")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _case(device, batch, seq, hidden, layers, latent, seed=0):
    stack = BiLSTM(2 + latent, hidden, layers, prng.PRNGKey(seed)).to(device)
    rng = np.random.default_rng(seed + 1)
    x = torch.from_numpy(rng.uniform(-1, 1, (batch, seq, 2)).astype(np.float32)).to(device)
    z = torch.from_numpy(rng.normal(size=(batch, latent)).astype(np.float32)).to(device)
    return stack.params(), x, z


@pytest.mark.parametrize("batch", [1, 131, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_full_width(cuda_device, dtype, batch):
    layers, x, z = _case(cuda_device, batch, 128, 48, 4, 32)
    before = fused_bilstm_fwd.launches
    got = fused_bilstm_fwd(layers, x, 48, z, dtype=dtype)
    torch.cuda.synchronize()
    assert fused_bilstm_fwd.launches == before + 1
    want = fused_bilstm_fwd_plain(layers, x, 48, z, dtype=dtype)
    assert got.dtype == dtype and got.shape == (batch, 128, 96)
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("batch", [7, 8, 9, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_around_its_tiles(cuda_device, dtype, batch):
    """Batches around the 8-sample tile (and the float32 kernel's 4-sample
    one), and two waves of CTAs; the launch is counted on the new path and a
    second launch gives the same bits."""
    layers, x, z = _case(cuda_device, batch, 128, 48, 4, 32, seed=batch)
    path = "mma" if dtype == torch.bfloat16 else "fp32"
    assert bilstm_fused.kernel_path(dtype, 48, 128, 4) == path
    before = dict(fused_bilstm_fwd.launches_by_path)
    got = fused_bilstm_fwd(layers, x, 48, z, dtype=dtype)
    again = fused_bilstm_fwd(layers, x, 48, z, dtype=dtype)
    torch.cuda.synchronize()
    took = {k: fused_bilstm_fwd.launches_by_path[k] - before[k] for k in before}
    assert took == {"mma": 0, "fp32": 0, "general": 0, path: 2}
    want = fused_bilstm_fwd_plain(layers, x, 48, z, dtype=dtype)
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL[dtype], rtol=0)
    assert torch.equal(got, again)


@pytest.mark.parametrize("batch", [5, 131, 512])
def test_float32_kernel_with_either_sample_tile(cuda_device, batch):
    """The float32 cluster kernel with 4 and with 8 samples per cluster (the
    wrapper picks one from the batch; the other is launched directly): both
    agree with the plain version."""
    layers, x, z = _case(cuda_device, batch, 128, 48, 4, 32, seed=batch)
    want = fused_bilstm_fwd_plain(layers, x, 48, z, dtype=torch.float32)
    assert sample_tile(torch.float32, batch) == (4 if batch <= 264 else 8)
    for tile in (4, 8):
        got = bilstm_fused._launch_packed(layers, x, 48, z, torch.float32, tile=tile)
        torch.testing.assert_close(got, want, atol=ATOL[torch.float32], rtol=0)


@pytest.mark.parametrize("hidden,path", [(8, "general"), (16, "new"), (32, "new"), (64, "general")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_takes_the_path_its_dtype_and_shape_name(cuda_device, dtype, hidden, path):
    if path == "new":
        path = "mma" if dtype == torch.bfloat16 else "fp32"
    stack, x, z = _case(cuda_device, 19, 24, hidden, 3, 6, seed=hidden)
    assert bilstm_fused.kernel_path(dtype, hidden, 24, 3) == path
    before = dict(fused_bilstm_fwd.launches_by_path)
    got = fused_bilstm_fwd(stack, x, hidden, z, dtype=dtype)
    torch.cuda.synchronize()
    took = {k: fused_bilstm_fwd.launches_by_path[k] - before[k] for k in before}
    assert took == {"mma": 0, "fp32": 0, "general": 0, path: 1}
    want = fused_bilstm_fwd_plain(stack, x, hidden, z, dtype=dtype)
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("layers", [1, 2, 3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_depths_alternate_the_scratch_buffers(cuda_device, dtype, layers):
    """One layer (no scratch), two (one buffer), and odd and even depths above."""
    stack, x, z = _case(cuda_device, 11, 20, 16, layers, 4, seed=layers)
    got = fused_bilstm_fwd(stack, x, 16, z, dtype=dtype)
    want = fused_bilstm_fwd_plain(stack, x, 16, z, dtype=dtype)
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("seq,hidden,layers", [(1, 16, 1), (3, 16, 2), (7, 5, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_small_shapes(cuda_device, dtype, seq, hidden, layers):
    stack, x, z = _case(cuda_device, 5, seq, hidden, layers, 8, seed=seq)
    got = fused_bilstm_fwd(stack, x, hidden, z, dtype=dtype)
    want = fused_bilstm_fwd_plain(stack, x, hidden, z, dtype=dtype)
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL[dtype], rtol=0)


def test_kernel_refuses_too_wide_a_stack(cuda_device):
    stack, x, z = _case(cuda_device, 2, 4, 300, 1, 4)
    with pytest.raises(RuntimeError, match="launch failed"):
        fused_bilstm_fwd(stack, x, 300, z, dtype=torch.float32)


def test_generator_on_cuda_matches_cpu(cuda_device):
    config = ModelConfig(time_head="monotone", compute_dtype="bfloat16")
    model = Generator(config, prng.PRNGKey(3)).eval()
    rng = np.random.default_rng(4)
    proto = torch.from_numpy(rng.uniform(-1, 1, (6, 128, 3)).astype(np.float32))
    z = torch.from_numpy(rng.normal(size=(6, 32)).astype(np.float32))
    with torch.no_grad():
        want = model(proto, z, inference=True)
        got = model.to(cuda_device)(proto.to(cuda_device), z.to(cuda_device),
                                    inference=True).cpu()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=0)


# -- kernels 2 and 3: the training pair ------------------------------------------------


def _rel_err(got, want) -> float:
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def train_pair_errors(device, batch, seq, hidden, layers, latent, dtype, seed=0,
                      launchers=None) -> dict:
    """Kernel 2 and kernel 3 against their plain versions on the same inputs
    (kernel 3 and its plain version both read kernel 2's residuals): max |err|
    relative to max |want| for the output, each residual plane and each
    gradient. ``launchers`` (a pair of ``bilstm_train._LAUNCHERS``) runs
    a path directly instead of through the dispatch."""
    stack, x, z = _case(device, batch, seq, hidden, layers, latent, seed)
    dy = torch.randn((batch, seq, 2 * hidden), generator=torch.Generator().manual_seed(seed))
    dy = dy.to(device)
    if launchers is None:
        launches = (bilstm_train_fwd.launches, bilstm_train_bwd.launches)
        y, res = bilstm_train_fwd(stack, x, z, hidden, dtype)
        grads, dx, dz = bilstm_train_bwd(stack, x, z, res, dy, hidden, dtype)
        torch.cuda.synchronize()
        assert (bilstm_train_fwd.launches, bilstm_train_bwd.launches) == (launches[0] + 1,
                                                                           launches[1] + 1)
    else:
        y, res = launchers[0](stack, x, z, hidden, dtype)
        grads, dx, dz = launchers[1](stack, x, z, res, dy, hidden, dtype)
        torch.cuda.synchronize()
    y_p, res_p = bilstm_train_fwd_plain(stack, x, z, hidden, dtype)
    grads_p, dx_p, dz_p = bilstm_train_bwd_plain(stack, x, z, res, dy, hidden, dtype)
    assert y.dtype == dtype and y.shape == (batch, seq, 2 * hidden)
    assert res.shape == res_p.shape and res.dtype == dtype
    errors = {"y": _rel_err(y, y_p), "dx": _rel_err(dx, dx_p), "dz": _rel_err(dz, dz_p)}
    for p, name in enumerate(PLANES):
        rows = slice(p * hidden, (p + 1) * hidden)
        errors[f"res_{name}"] = _rel_err(res[..., rows], res_p[..., rows])
    for k in range(layers):
        for d in ("fwd", "bwd"):
            for leaf in ("w_ih", "w_hh", "b_ih", "b_hh"):
                errors[f"{k}.{d}.{leaf}"] = _rel_err(grads[k][d][leaf], grads_p[k][d][leaf])
    return errors


@pytest.mark.parametrize("batch", [1, 7, 8, 9, 131, 512, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_pair_matches_plain_full_width(cuda_device, dtype, batch):
    errors = train_pair_errors(cuda_device, batch, 128, 48, 4, 32, dtype)
    worst = max(errors, key=errors.get)
    assert errors[worst] <= ATOL[dtype], (worst, errors[worst])


@pytest.mark.parametrize("seq,hidden,layers,batch", [(1, 16, 1, 3), (7, 5, 3, 5), (9, 16, 2, 1),
                                                     (4, 8, 2, 37)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_pair_matches_plain_small_shapes(cuda_device, dtype, seq, hidden, layers, batch):
    errors = train_pair_errors(cuda_device, batch, seq, hidden, layers, 8, dtype, seed=seq)
    worst = max(errors, key=errors.get)
    assert errors[worst] <= ATOL[dtype], (worst, errors[worst])


def test_train_forward_equals_inference_kernel(cuda_device):
    """Kernel 2's output against kernel 1's. In float32 at H=48 both run the
    one float32 cluster recurrence of csrc/bilstm_step.cuh (``fp32_stack``)
    at the same sample tile, the same sums in the same order: bit-equal, at
    either tile. In bfloat16 the two sum in another order: equal within kernel
    1's tolerance. At H=8 both take their general kernels, which sum in one
    order: bit-equal."""
    for batch in (64, 512):
        stack, x, z = _case(cuda_device, batch, 128, 48, 4, 32, seed=5)
        y, _ = bilstm_train_fwd(stack, x, z, 48, torch.float32)
        torch.testing.assert_close(y, fused_bilstm_fwd(stack, x, 48, z, dtype=torch.float32),
                                   atol=0, rtol=0)
        other = 12 - sample_tile(torch.float32, batch)
        y, _ = bilstm_train._launch_fwd_fp32(stack, x, z, 48, torch.float32, tile=other)
        torch.testing.assert_close(
            y, bilstm_fused._launch_packed(stack, x, 48, z, torch.float32, tile=other),
            atol=0, rtol=0)
    y, _ = bilstm_train_fwd(stack, x, z, 48, torch.bfloat16)
    torch.testing.assert_close(y.float(),
                               fused_bilstm_fwd(stack, x, 48, z, dtype=torch.bfloat16).float(),
                               atol=ATOL[torch.bfloat16], rtol=0)
    stack, x, z = _case(cuda_device, 9, 16, 8, 2, 4, seed=6)
    y, _ = bilstm_train_fwd(stack, x, z, 8, torch.float32)
    torch.testing.assert_close(y, fused_bilstm_fwd(stack, x, 8, z, dtype=torch.float32),
                               atol=0, rtol=0)


@pytest.mark.parametrize("dtype,hidden,path", [(torch.bfloat16, 48, "mma"),
                                               (torch.bfloat16, 16, "mma"),
                                               (torch.bfloat16, 8, "general"),
                                               (torch.float32, 48, "fp32"),
                                               (torch.float32, 16, "fp32"),
                                               (torch.float32, 8, "general")])
def test_train_pair_takes_the_path_its_dtype_and_shape_name(cuda_device, dtype, hidden, path):
    """The full-width bfloat16 call runs the tensor-core kernels, the float32
    one the float32 cluster kernels; the counters per path show which
    kernels a call launched."""
    batch, seq, layers = (512, 128, 4) if hidden == 48 else (5, 6, 2)
    assert kernel_path(dtype, hidden, seq, layers) == path
    stack, x, z = _case(cuda_device, batch, seq, hidden, layers, 32)
    dy = torch.ones((batch, seq, 2 * hidden), device=cuda_device)
    before = dict(bilstm_train_fwd.launches_by_path), dict(bilstm_train_bwd.launches_by_path)
    _, res = bilstm_train_fwd(stack, x, z, hidden, dtype)
    bilstm_train_bwd(stack, x, z, res, dy, hidden, dtype)
    torch.cuda.synchronize()
    for counter, was in zip((bilstm_train_fwd, bilstm_train_bwd), before):
        took = {k: counter.launches_by_path[k] - was[k] for k in was}
        assert took == {"mma": 0, "fp32": 0, "general": 0, path: 1}


@pytest.mark.parametrize("batch", [9, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_backward_is_bit_equal_across_launches(cuda_device, dtype, batch):
    """Kernel 3 adds its partial sums in a fixed order (no float atomics):
    two launches on the same inputs give the same bits."""
    stack, x, z = _case(cuda_device, batch, 128, 48, 4, 32, seed=7)
    dy = torch.randn((batch, 128, 96), generator=torch.Generator().manual_seed(8)).to(cuda_device)
    _, res = bilstm_train_fwd(stack, x, z, 48, dtype)
    first = bilstm_train_bwd(stack, x, z, res, dy, 48, dtype)
    second = bilstm_train_bwd(stack, x, z, res, dy, 48, dtype)
    torch.cuda.synchronize()
    for k in range(4):
        for d in ("fwd", "bwd"):
            for leaf in ("w_ih", "w_hh", "b_ih", "b_hh"):
                assert torch.equal(first[0][k][d][leaf], second[0][k][d][leaf]), (k, d, leaf)
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])


@pytest.mark.parametrize("batch", [1, 4, 5, 7, 8, 9, 131, 264, 265, 512, 2048])
@pytest.mark.parametrize("hidden", [16, 32, 48])
def test_float32_pair_matches_plain_at_every_width(cuda_device, hidden, batch):
    """The float32 pair at each hidden size it is built for, full depth and
    length, around its 4- and 8-sample tiles and the batch where the tile
    changes (264 / 265): every output, residual plane and gradient within
    1e-4 of the largest, and the calls counted on the ``"fp32"`` path."""
    before = (bilstm_train_fwd.launches_by_path["fp32"], bilstm_train_bwd.launches_by_path["fp32"])
    errors = train_pair_errors(cuda_device, batch, 128, hidden, 4, 32, torch.float32, seed=hidden)
    assert (bilstm_train_fwd.launches_by_path["fp32"],
            bilstm_train_bwd.launches_by_path["fp32"]) == (before[0] + 1, before[1] + 1)
    worst = max(errors, key=errors.get)
    assert errors[worst] <= ATOL[torch.float32], (worst, errors[worst])


@pytest.mark.parametrize("batch", [5, 131, 512])
def test_float32_pair_with_either_sample_tile(cuda_device, batch):
    """The float32 pair launched with the tile the dispatch rule does not
    pick at this batch holds to its plain version too."""
    other = 12 - sample_tile(torch.float32, batch)
    pair = (lambda *a: bilstm_train._launch_fwd_fp32(*a, tile=other),
            lambda *a: bilstm_train._launch_bwd_fp32(*a, tile=other))
    errors = train_pair_errors(cuda_device, batch, 128, 48, 4, 32, torch.float32, launchers=pair)
    worst = max(errors, key=errors.get)
    assert errors[worst] <= ATOL[torch.float32], (worst, errors[worst])


@pytest.mark.parametrize("hidden,batch", [(8, 37), (48, 131)])
def test_general_pair_still_matches_plain_in_float32(cuda_device, hidden, batch):
    """The first CUDA-core kernels, which every other width takes (H=8), and
    which stay the measured baseline at full width, in float32."""
    assert kernel_path(torch.float32, 8, 128, 4) == "general"
    errors = train_pair_errors(cuda_device, batch, 32, hidden, 3, 8, torch.float32,
                               launchers=bilstm_train._LAUNCHERS["general"])
    worst = max(errors, key=errors.get)
    assert errors[worst] <= ATOL[torch.float32], (worst, errors[worst])


def test_train_pair_refuses_too_wide_a_stack(cuda_device):
    stack, x, z = _case(cuda_device, 2, 4, 300, 1, 4)
    with pytest.raises(RuntimeError, match="launch failed"):
        bilstm_train_fwd(stack, x, z, 300, torch.float32)
    res = torch.zeros((1, 2, 4, 2, 1800), device=cuda_device)
    with pytest.raises(RuntimeError, match="launch failed"):
        bilstm_train_bwd(stack, x, z, res, torch.zeros((2, 4, 600), device=cuda_device), 300,
                         torch.float32)


def test_autograd_function_on_cuda_matches_cpu(cuda_device):
    """Gradients through ``bilstm_train_apply`` on the card (kernels 2 and 3)
    equal those on the CPU (the plain pair), float32."""
    stack = BiLSTM(2 + 8, 16, 2, prng.PRNGKey(1))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.uniform(-1, 1, (6, 12, 2)).astype(np.float32))
    z = torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(6, 12, 32)).astype(np.float32))
    results = []
    for device in ("cpu", cuda_device):
        model = BiLSTM(2 + 8, 16, 2)
        model.load_state_dict(stack.state_dict())
        model = model.to(device)
        xs, zs = x.to(device).requires_grad_(), z.to(device).requires_grad_()
        y = bilstm_train_apply(model.params(), xs, zs, 16, dtype=torch.float32)
        grads = torch.autograd.grad((y * dy.to(device)).sum(), [xs, zs, *model.parameters()])
        results.append([g.cpu() for g in grads])
    for a, b in zip(*results):
        torch.testing.assert_close(b, a, atol=1e-4 * max(1.0, a.abs().max().item()), rtol=0)


@pytest.mark.parametrize("recipe", ["reference", "flagship"])
def test_train_step_on_cuda_matches_cpu(cuda_device, recipe):
    """One full-width float32 ``gan_train_step`` on the card (kernels 1-3)
    against the CPU's plain path from the same state, batch and noise, with
    the tolerances ``chip_smoke.STEP_RECIPES`` states; it raises otherwise."""
    import chip_smoke

    line = chip_smoke.step_vs_cpu_recipe(cuda_device, recipe, batch=16)
    assert line["max_grad_err_rel"] <= chip_smoke.STEP_RECIPES[recipe][1]


# -- kernel 4: exact batched DTW ----------------------------------------------------------

DTW_RTOL = 1e-4


def _walks(seed, count, seq, dims, device):
    rng = np.random.default_rng(seed)
    walk = np.clip(np.cumsum(rng.normal(0.0, 0.05, (count, seq, dims)), axis=1), -1.0, 1.0)
    return torch.from_numpy(walk.astype(np.float32)).to(device)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("pairs,seq", [(1, 128), (31, 128), (131, 128), (4099, 128), (67, 50),
                                       (5, 1)])
def test_dtw_pairs_kernel_matches_plain(cuda_device, pairs, seq, dims):
    x, y = _walks(0, pairs, seq, dims, cuda_device), _walks(1, pairs, seq, dims, cuda_device)
    before = dtw_pairs.launches
    got = dtw_pairs(x, y)
    torch.cuda.synchronize()
    assert dtw_pairs.launches == before + 1
    assert got.shape == (pairs,) and got.dtype == torch.float32 and got.is_cuda
    torch.testing.assert_close(got, dtw_pairs_plain(x, y), rtol=DTW_RTOL, atol=1e-6)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("n,m", [(64, 64), (37, 13), (1, 1), (33, 5)])
def test_dtw_matrix_kernel_matches_aligned_pairs_and_plain(cuda_device, n, m, dims):
    real, fake = _walks(2, n, 128, dims, cuda_device), _walks(3, m, 128, dims, cuda_device)
    before = dtw_matrix.launches
    got = dtw_matrix(real, fake)
    torch.cuda.synchronize()
    assert dtw_matrix.launches == before + 1 and got.shape == (n, m)
    idx = torch.arange(n * m, device=cuda_device)
    rx, fy = real[idx // m], fake[idx % m]
    torch.testing.assert_close(got.reshape(-1), dtw_pairs(rx, fy), rtol=0, atol=0)
    torch.testing.assert_close(got.reshape(-1), dtw_pairs_plain(rx, fy), rtol=DTW_RTOL, atol=1e-6)
    host = dtw_distance_matrix(real.cpu().numpy(), fake.cpu().numpy(), device=cuda_device)
    np.testing.assert_array_equal(host, got.cpu().numpy())


def test_dtw_kernel_takes_strided_and_wider_inputs(cuda_device):
    gestures = _walks(4, 9, 128, 3, cuda_device)
    xy = gestures[:, :, :2]                              # a non-contiguous (x, y) view
    torch.testing.assert_close(dtw_matrix(xy, xy), dtw_matrix(xy.contiguous(), xy.contiguous()),
                               rtol=0, atol=0)
    assert dtw_matrix(xy, xy).diagonal().abs().max().item() == 0.0


@pytest.mark.parametrize("shape", [(4, 129, 2), (4, 16, 4), (4, 16, 1)])
def test_dtw_cuda_tensor_with_an_unsupported_shape_raises(cuda_device, shape):
    x = torch.zeros(shape, device=cuda_device)
    before = dtw_pairs.launches, dtw_matrix.launches
    with pytest.raises(ValueError):
        dtw_pairs(x, x)
    with pytest.raises(ValueError):
        dtw_matrix(x, x)
    assert (dtw_pairs.launches, dtw_matrix.launches) == before


# -- the scale metrics and the contrastive encoder (no kernel of their own) ------------------


def test_contrastive_step_on_cuda_matches_cpu(cuda_device):
    """One contrastive train step (SupCon, clip, Adam) on the card against
    the CPU from the same weights and batch, float32 with TF32 off, with the
    tolerances ``chip_smoke.CONTRASTIVE_TOL`` states; it raises otherwise."""
    import chip_smoke

    line = chip_smoke.contrastive_step_vs_cpu(cuda_device, batch_words=8)
    assert all(line["errors"][k] <= tol for k, tol in chip_smoke.CONTRASTIVE_TOL.items())


def test_scale_metrics_on_cuda_match_cpu(cuda_device):
    """``evaluate_large_scale`` on the card against the CPU at n = 600 with
    injected draws (Sinkhorn on subsamples of 128): the estimators agree to
    1e-4, precision and recall within one sample; the k-NN pass's padding
    path runs (600 rows in chunks of 2048 → one padded chunk)."""
    import chip_smoke
    from wordgesture_gan_tpu_torch.metrics.large_scale import evaluate_large_scale

    rng = np.random.default_rng(0)
    n = 600
    real = np.clip(np.cumsum(rng.normal(0, 0.08, (n, 128, 3)), axis=1), -1, 1).astype(np.float32)
    fake = np.clip(np.cumsum(rng.normal(0.005, 0.08, (n, 128, 3)), axis=1), -1,
                   1).astype(np.float32)
    draws = chip_smoke._large_draws(n, 256, 128, 2)
    runs = [evaluate_large_scale(real, fake, device=dev, draws=draws, sinkhorn_n_sub=128,
                                 sinkhorn_repeats=2) for dev in (cuda_device, "cpu")]
    got, want = runs
    for k in ("sliced_w2", "sinkhorn_matched_cost", "sinkhorn_matched_cost_extrapolated"):
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), k
    assert abs(got["energy_distance"] - want["energy_distance"]) <= 1e-4
    for k in ("precision", "recall"):
        assert abs(got[k] - want[k]) <= 1.0 / n + 1e-9, k


# -- the realism report's DTW shape, and data parallelism on the card ------------------------


@pytest.mark.parametrize("pairs", [1, 131, 14000])
def test_dtw_pairs_kernel_at_the_realism_shape(cuda_device, pairs):
    """Kernel 4 at the realism report's shape: (x, y) pairs of 64 points."""
    x, y = _walks(2, pairs, 64, 2, cuda_device), _walks(3, pairs, 64, 2, cuda_device)
    torch.testing.assert_close(dtw_pairs(x, y), dtw_pairs_plain(x, y), rtol=DTW_RTOL, atol=1e-6)


def test_nccl_one_rank_steps_match_one_process(cuda_device, monkeypatch):
    """The GAN and contrastive steps (full width, float32) under a one-rank
    NCCL process group, one gradient all-reduce per gradient computation,
    against the same steps with no process group, with the tolerances
    ``chip_smoke.DP_TOL`` states."""
    import chip_smoke
    from wordgesture_gan_tpu_torch.parallel import (create_mesh, maybe_init_distributed,
                                                    shutdown_distributed)

    for k, v in {"WGG_DISTRIBUTED": "1", **chip_smoke.distributed_env(0, 1,
                                                                      chip_smoke.free_port())}.items():
        monkeypatch.setenv(k, v)
    assert maybe_init_distributed(cuda_device, verbose=False, timeout=120)
    try:
        assert torch.distributed.get_backend() == "nccl"
        got = chip_smoke.dp_steps(cuda_device, create_mesh(device=cuda_device))
    finally:
        shutdown_distributed()
    want = chip_smoke.dp_steps(cuda_device, None)
    for key in want:
        kind, lr = key.split("/")
        n_critic = chip_smoke.FLAGSHIP_TRAIN["n_critic"]
        err = chip_smoke._dp_errors(got[key], want[key], float(lr),
                                    {"d1": n_critic, "d2": n_critic} if kind == "gan" else {})
        assert err["loss"] <= chip_smoke.DP_TOL["loss"] and err["grad"] <= chip_smoke.DP_TOL["grad"]
        assert err["bn"] <= chip_smoke.DP_TOL["bn"] and err["param_in_lr_per_adam_step"] <= 2
        assert got[key]["collectives"] == (chip_smoke.DP_COLLECTIVES_PER_STEP if kind == "gan"
                                           else 1)


def test_two_gloo_ranks_on_the_card_match_one_process(cuda_device, tmp_path):
    """Phase 9b of chip_smoke.py: two gloo ranks sharing the card against one
    process on the card; it raises outside ``chip_smoke.DP_TOL``."""
    import chip_smoke

    line = chip_smoke.data_parallel_vs_single(cuda_device, tmp_path)
    assert set(line["collectives"].values()) <= {1, chip_smoke.DP_COLLECTIVES_PER_STEP}


# -- the scanned epoch: the train step captured as a CUDA graph ------------------------------


@pytest.mark.parametrize("kind", ["bfloat16", "float32", "masked"])
def test_graphed_epoch_equals_eager_epoch(cuda_device, kind):
    """``gan_train_epoch`` (flagship bf16, float32) and
    ``gan_train_epoch_masked`` at full width, B=64: one capture replayed for
    two epochs of 3 batches, against the same steps run eagerly from a copy
    of the state and its generator. Traces, every state tensor, Adam's
    counts and the generator's state bit-equal; the critics' u vectors move
    across replays; kernels 1-3 counted PER_STEP a step in the replays
    (``chip_smoke.graphed_vs_eager`` raises otherwise)."""
    import chip_smoke

    line = chip_smoke.graphed_vs_eager(cuda_device, kind, batch=64)
    assert line["bit_equal"] and line["rng_equal"]
    assert line["captures"] == 1 and line["replays"] == line["steps"] - 1


def test_graphed_epoch_refuses_a_gloo_group(cuda_device, tmp_path):
    """A gloo process group's collectives run on the host and cannot be
    captured: a graphed epoch on the card under one raises ValueError,
    naming the backend, before any step runs."""
    import torch.distributed as dist

    from wordgesture_gan_tpu_torch.configs import TrainingConfig
    from wordgesture_gan_tpu_torch.parallel.mesh import Mesh
    from wordgesture_gan_tpu_torch.train import gan_train_epoch
    from wordgesture_gan_tpu_torch.train.state import init_gan_state

    mcfg = ModelConfig(gen_hidden_dim=16, gen_num_layers=2, seq_length=16, latent_dim=4)
    state = init_gan_state(0, mcfg, cuda_device)
    batches = {k: torch.zeros((2, 8, 16, 3), device=cuda_device) for k in ("gesture", "prototype")}
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        mesh = Mesh(world_size=1, rank=0, group=dist.group.WORLD, device=cuda_device)
        with pytest.raises(ValueError, match="'gloo'"):
            gan_train_epoch(state, batches, 1e-4, mcfg, TrainingConfig(batch_size=8), mesh=mesh)
    finally:
        dist.destroy_process_group()
    assert state["epoch"] == 0 and all(state[m]["opt"]["count"] == 0 for m in ("g", "d1"))


# -- the activation kernels (ops/activations.py) against the plain op-by-op chain ------------

ACTIVATIONS = {"gelu": (layers.gelu, layers.plain_gelu, "gelu"),
               "leaky_relu": (layers.leaky_relu, layers.plain_leaky_relu, "leaky")}
ACTIVATION_F32_N = 1 << 20


def _activation_inputs(dtype, device, seed: int = 13):
    """(x, g): every bfloat16 value, or 2^20 float32 inputs from N(0, 3^2)
    with both zeros, both infinities, NaN, tanh's clamp (±7.99881), its
    saturation (±20) and small-argument (|x| < 4e-4) branches, the extremes;
    each against a cotangent from N(0, 1) that starts with ±0, ±inf, NaN."""
    rng = np.random.default_rng(seed)
    if dtype == torch.bfloat16:
        x = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    else:
        special = [0.0, -0.0, np.inf, -np.inf, np.nan, 7.99881172180175781, -7.99881172180175781,
                   20.0, -20.0, 19.999998, 4e-4, -4e-4, 3.9999998e-4, 1e-38, -1e-38, 1e-45,
                   3.4e38, -3.4e38]
        small = rng.uniform(-4e-4, 4e-4, 4096)
        x = torch.from_numpy(np.concatenate([special, small, rng.normal(
            0, 3, ACTIVATION_F32_N - len(special) - len(small))]).astype(np.float32))
    g = rng.normal(size=x.shape[0]).astype(np.float32)
    g[:5] = [0.0, -0.0, np.inf, -np.inf, np.nan]
    return x.to(device), torch.from_numpy(g).to(dtype).to(device)


def _every_bf16_cotangent(x: torch.Tensor) -> torch.Tensor:
    """Every bfloat16 value once, in a fixed shuffled order, against ``x``:
    the backward's second operand in its subnormals, zeros, infinities and
    NaNs too."""
    perm = torch.from_numpy(np.random.default_rng(29).permutation(x.shape[0]))
    every = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    return every[perm].to(x.device)


def _bits_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements whose bits differ (NaN counts as equal to NaN)."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())
    return int((~same).sum())


def _act_forward_backward(fn, x: torch.Tensor, g: torch.Tensor):
    x = x.detach().requires_grad_()     # x's own storage, offset and strides
    y = fn(x)
    y.backward(g)
    return y, x.grad


def _assert_act_equal(got, want):
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype
    assert (_bits_differ(got[0], want[0]), _bits_differ(got[1], want[1])) == (0, 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(ACTIVATIONS))
def test_activation_kernels_equal_the_plain_chain(cuda_device, name, dtype):
    """Forward and gradient bit-equal to the plain function on the card,
    over every bfloat16 input and the float32 sample: one kernel launch
    each way, no plain call. In bfloat16 the backward is held again
    against cotangents that take every bfloat16 value."""
    fn, plain, op = ACTIVATIONS[name]
    x, g = _activation_inputs(dtype, cuda_device)
    before = dict(activation_launches.launches_by_path)
    got = _act_forward_backward(fn, x, g)
    moved = {k: v - before[k] for k, v in activation_launches.launches_by_path.items()
             if v != before[k]}
    assert moved == {(f"{op}_fwd", "cuda"): 1, (f"{op}_bwd", "cuda"): 1}
    _assert_act_equal(got, _act_forward_backward(plain, x, g))
    if dtype == torch.bfloat16:
        g = _every_bf16_cotangent(x)
        _assert_act_equal(_act_forward_backward(fn, x, g), _act_forward_backward(plain, x, g))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(ACTIVATIONS))
def test_activation_kernels_keep_a_strided_dense_layout(cuda_device, name, dtype):
    """The temporal critic's operand: a conv output (B, C, L) transposed to
    (B, L, C) plus a bias, dense but not contiguous. The output keeps its
    strides; the cotangent comes in another layout (contiguous, and
    expanded from a sum). A slice that is not dense is made contiguous; a
    dense view one element off 16-byte alignment is copied to an aligned
    one."""
    fn, plain, _ = ACTIVATIONS[name]
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    conv = torch.randn(7, 33, 129, generator=gen, device=cuda_device).to(dtype)
    x = conv.transpose(1, 2) + torch.randn(33, generator=gen, device=cuda_device).to(dtype)
    assert not x.is_contiguous()
    y = fn(x)
    assert y.stride() == x.stride()
    g = torch.randn(x.shape, generator=gen, device=cuda_device).to(dtype)
    _assert_act_equal(_act_forward_backward(fn, x, g), _act_forward_backward(plain, x, g))
    ones = torch.ones((), dtype=dtype, device=cuda_device).expand(x.shape)
    _assert_act_equal(_act_forward_backward(fn, x, ones), _act_forward_backward(plain, x, ones))
    sliced = x[:, 1:, 3:]
    _assert_act_equal(_act_forward_backward(fn, sliced, g[:, 1:, 3:]),
                      _act_forward_backward(plain, sliced, g[:, 1:, 3:]))
    shifted, g_shifted = conv.reshape(-1)[1:], g.reshape(-1)[1:]
    assert shifted.data_ptr() % 16 != 0
    _assert_act_equal(_act_forward_backward(fn, shifted, g_shifted),
                      _act_forward_backward(plain, shifted, g_shifted))


@pytest.mark.parametrize("shape", [(0,), (0, 5), (1,), (), (3,), (9,), (4, 1, 3)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(ACTIVATIONS))
def test_activation_kernels_on_empty_and_small_tensors(cuda_device, name, dtype, shape):
    """Empty tensors launch nothing; one element and sizes below a 16-byte
    pack run through the tail."""
    fn, plain, _ = ACTIVATIONS[name]
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = (torch.randn(shape, generator=gen, device=cuda_device) * 3).to(dtype)
    g = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    got = _act_forward_backward(fn, x, g)
    assert got[0].shape == x.shape and got[1].shape == x.shape
    _assert_act_equal(got, _act_forward_backward(plain, x, g))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(ACTIVATIONS))
def test_activation_kernels_inside_a_captured_graph(cuda_device, name, dtype):
    """Forward and backward captured as one CUDA graph, replayed twice on new
    inputs written into its static buffers: each replay bit-equal to the
    plain chain on those inputs."""
    fn, plain, _ = ACTIVATIONS[name]
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    static_x = torch.randn(1024, 256, generator=gen, device=cuda_device).to(dtype)
    static_g = torch.randn(1024, 256, generator=gen, device=cuda_device).to(dtype)

    def step():
        x = static_x.detach().requires_grad_()
        y = fn(x)
        (dx,) = torch.autograd.grad(y, x, static_g)
        return y, dx

    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    for scale in (3.0, 0.25):
        static_x.copy_(torch.randn(static_x.shape, generator=gen, device=cuda_device) * scale)
        static_g.copy_(torch.randn(static_g.shape, generator=gen, device=cuda_device))
        graph.replay()
        torch.cuda.synchronize()
        _assert_act_equal(out, _act_forward_backward(plain, static_x, static_g))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
@pytest.mark.parametrize("name", list(ACTIVATIONS))
def test_other_dtypes_raise_on_the_card(cuda_device, name, dtype):
    """A card tensor of a dtype the kernels do not take raises, and counts
    nothing: the plain chain runs on the CPU only."""
    fn, _, _ = ACTIVATIONS[name]
    x = torch.linspace(-3, 3, 11, dtype=dtype, device=cuda_device)
    before = dict(activation_launches.launches_by_path), activation_launches.launches
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fn(x)
    assert (dict(activation_launches.launches_by_path), activation_launches.launches) == before


# -- the attention kernels (ops/attention.py) against the plain chain ------------------------

# (B, L, H, h, dtype, masked): the masked step's critic-loop call and joint-step call, head 8,
# no mask (a fixed-length generator), float32; then lengths and heads around the tiles.
ATTENTION_CASES = [(1024, 128, 4, 16, "bfloat16", True), (512, 128, 4, 16, "bfloat16", True),
                   (512, 128, 8, 8, "bfloat16", True), (512, 128, 4, 16, "bfloat16", False),
                   (512, 128, 4, 16, "float32", True), (3, 12, 2, 8, "bfloat16", True),
                   (7, 33, 2, 16, "bfloat16", True), (2, 129, 2, 56, "bfloat16", True),
                   (3, 256, 1, 64, "bfloat16", True), (7, 33, 2, 24, "float32", True)]


@pytest.mark.parametrize("case", ATTENTION_CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_kernels_match_the_plain_chain(cuda_device, case):
    """The forward's output and dq, dk, dv within ``chip_smoke.ATTN_LIMIT``
    of the plain chain on the card (relative L2 over each tensor: 2e-3 in
    bfloat16, a one-step flip in a quarter of the elements; 1e-5 in
    float32, the sums' order), finite (a row of padding keys only included);
    the float8 controls (P or the logits rounded) beyond it from L = 64 on;
    one launch each way, no plain call (``chip_smoke.check_attention``
    raises otherwise)."""
    import chip_smoke

    (line,) = chip_smoke.check_attention(cuda_device, cases=(case,))
    assert line["finite"] and line["deterministic"]


def _attention_grad(qkv, mask, g):
    x = qkv.detach().requires_grad_()
    out = attention.attention(x, mask, generators.plain_attention)
    (dqkv,) = torch.autograd.grad(out, x, g)
    return out, dqkv


def test_attention_backward_is_bit_equal_across_launches(cuda_device):
    """No atomics: two forwards and two backwards from the same inputs give
    the same bits."""
    import chip_smoke

    qkv, mask, g = chip_smoke.attention_inputs(cuda_device, 512, 128, 4, 16, torch.bfloat16)
    first, second = _attention_grad(qkv, mask, g), _attention_grad(qkv, mask, g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_attention_kernels_inside_a_captured_graph(cuda_device):
    """Forward and backward captured as one CUDA graph, replayed on new
    inputs written into its static buffers: each replay bit-equal to the
    kernels run eagerly on those inputs."""
    import chip_smoke

    static_qkv, static_mask, static_g = chip_smoke.attention_inputs(
        cuda_device, 64, 128, 4, 16, torch.bfloat16, seed=1)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        _attention_grad(static_qkv, static_mask, static_g)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _attention_grad(static_qkv, static_mask, static_g)
    for seed in (2, 3):
        qkv, mask, g = chip_smoke.attention_inputs(cuda_device, 64, 128, 4, 16, torch.bfloat16,
                                                   seed=seed)
        static_qkv.copy_(qkv)
        static_mask.copy_(mask)
        static_g.copy_(g)
        graph.replay()
        torch.cuda.synchronize()
        want = _attention_grad(qkv, mask, g)
        assert all(torch.equal(a, b) for a, b in zip(out, want))


def test_masked_step_calls_only_the_attention_kernels(cuda_device):
    """A graphed masked step (the transformer at full width, n_critic 5,
    B=64) makes 28 attention forwards (5 critic-loop generator calls and 2
    joint-step calls, 4 layers each) and 8 backwards, every one a kernel
    launch, none plain; a replay counts what its capture counted."""
    import chip_smoke
    from wordgesture_gan_tpu_torch.train.state import init_gan_state
    from wordgesture_gan_tpu_torch.train.step_graph import StepGraph

    mcfg, tcfg, batches, epoch_fn, _ = chip_smoke._graph_check_inputs(cuda_device, "masked",
                                                                      64, None)
    state = init_gan_state(0, mcfg, cuda_device)
    before = dict(attention_launches.launches_by_path)
    epoch_fn(state, batches, 1e-4, mcfg, tcfg, graph=StepGraph())
    torch.cuda.synchronize()
    steps = batches["gesture"].shape[0]
    moved = {k: (v - before[k]) / steps for k, v in attention_launches.launches_by_path.items()
             if v != before[k]}
    layers_n = mcfg.tfm_num_layers
    assert moved == {("attention_fwd", "cuda"): (tcfg.n_critic + 2) * layers_n,
                     ("attention_bwd", "cuda"): 2 * layers_n} == {
        ("attention_fwd", "cuda"): 28, ("attention_bwd", "cuda"): 8}


@pytest.mark.parametrize("shape,dtype", [((2, 12, 3, 2, 8), torch.float16),
                                         ((2, 12, 3, 2, 12), torch.bfloat16),
                                         ((2, 300, 3, 2, 16), torch.bfloat16),
                                         ((2, 12, 3, 1, 80), torch.float32)])
def test_attention_shapes_off_the_kernels_raise_on_the_card(cuda_device, shape, dtype):
    """A card tensor the kernels do not take raises ValueError naming it and
    counts nothing: the plain chain runs on the CPU only."""
    qkv = torch.zeros(shape, dtype=dtype, device=cuda_device)
    before = dict(attention_launches.launches_by_path)
    with pytest.raises(ValueError, match=r"attention kernels take"):
        attention.attention(qkv, None, generators.plain_attention)
    assert dict(attention_launches.launches_by_path) == before


# -- the layer norm kernels (ops/layernorm.py) against the plain chain -----------------------


# (rows, D, dtype): the masked step's calls at d_model 64 (2B and B rows of
# L = 128 in bfloat16, the final norm in float32), then odd and wide D.
LAYERNORM_CASES = [(131072, 64, "bfloat16"), (65536, 64, "bfloat16"), (131072, 64, "float32"),
                   (65536, 64, "float32"), (1000, 37, "bfloat16"), (1000, 37, "float32"),
                   (999, 100, "bfloat16"), (333, 1024, "bfloat16"), (333, 1024, "float32"),
                   (7, 48, "bfloat16"), (5, 6, "float32"), (3, 1, "bfloat16"), (1, 64, "bfloat16")]


@pytest.mark.parametrize("case", LAYERNORM_CASES, ids=lambda c: "-".join(map(str, c)))
def test_layernorm_kernels_match_the_plain_chain(cuda_device, case):
    """The output, dx, dscale and dbias within ``chip_smoke.LN_LIMIT`` of the
    plain chain on the card (relative L2 over each tensor: 2e-3 in
    bfloat16, 1e-5 in float32, the sums' order); the float8 control beyond
    it in every result from 64 rows on; two launches bit-equal; one call
    each way, no plain call (``chip_smoke.check_layernorm`` raises
    otherwise, and for a float16 tensor that does not raise)."""
    import chip_smoke

    (line,) = chip_smoke.check_layernorm(cuda_device, cases=(case,))
    assert line["finite"] and line["deterministic"]


def _layernorm_grads(x, scale, bias, g):
    leaves = [t.detach().requires_grad_() for t in (x, scale, bias)]
    out = layernorm_ops.layernorm(*leaves)
    return (out, *torch.autograd.grad(out, leaves, g))


def test_layernorm_kernels_inside_a_captured_graph(cuda_device):
    """Forward and backward through the dispatcher captured as one CUDA
    graph, replayed on new inputs written into its static buffers: each
    replay bit-equal to the kernels run eagerly on those inputs."""
    import chip_smoke

    static = chip_smoke.layernorm_inputs(cuda_device, 4096, 64, torch.bfloat16, seed=1)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        _layernorm_grads(*static)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _layernorm_grads(*static)
    for seed in (2, 3):
        fresh = chip_smoke.layernorm_inputs(cuda_device, 4096, 64, torch.bfloat16, seed=seed)
        for s, f in zip(static, fresh):
            s.copy_(f)
        graph.replay()
        torch.cuda.synchronize()
        want = _layernorm_grads(*fresh)
        assert all(torch.equal(a, b) for a, b in zip(out, want))


def test_masked_step_calls_only_the_layernorm_kernels(cuda_device):
    """A graphed masked step (the transformer at full width, n_critic 5,
    B=64) makes 63 layer norm forwards (5 critic-loop generator calls and 2
    joint-step calls, 9 norms each: 4 blocks x 2 and the final one) and 18
    backwards, every one on the kernels, none plain; a replay counts what
    its capture counted."""
    import chip_smoke
    from wordgesture_gan_tpu_torch.train.state import init_gan_state
    from wordgesture_gan_tpu_torch.train.step_graph import StepGraph

    mcfg, tcfg, batches, epoch_fn, _ = chip_smoke._graph_check_inputs(cuda_device, "masked",
                                                                      64, None)
    state = init_gan_state(0, mcfg, cuda_device)
    before = dict(layernorm_launches.launches_by_path)
    epoch_fn(state, batches, 1e-4, mcfg, tcfg, graph=StepGraph())
    torch.cuda.synchronize()
    steps = batches["gesture"].shape[0]
    moved = {k: (v - before[k]) / steps for k, v in layernorm_launches.launches_by_path.items()
             if v != before[k]}
    norms = 2 * mcfg.tfm_num_layers + 1
    assert moved == {("layernorm_fwd", "cuda"): (tcfg.n_critic + 2) * norms,
                     ("layernorm_bwd", "cuda"): 2 * norms} == {
        ("layernorm_fwd", "cuda"): 63, ("layernorm_bwd", "cuda"): 18}


@pytest.mark.parametrize("shape,dtype", [((4, 64), torch.float16), ((4, 64), torch.float64),
                                         ((2, 3, 1025), torch.bfloat16), ((4, 0), torch.float32)])
def test_layernorm_shapes_off_the_kernels_raise_on_the_card(cuda_device, shape, dtype):
    """A card tensor the kernels do not take raises ValueError naming it and
    counts nothing: the plain chain runs on the CPU only."""
    x = torch.zeros(shape, dtype=dtype, device=cuda_device)
    d = shape[-1]
    before = dict(layernorm_launches.launches_by_path)
    with pytest.raises(ValueError, match=r"layer norm kernels take"):
        layernorm_ops.layernorm(x, torch.ones(d, device=cuda_device),
                                torch.zeros(d, device=cuda_device))
    assert dict(layernorm_launches.launches_by_path) == before


# -- the bias kernel (ops/bias.py) against the plain chain -----------------------------------


def _bias_cases():
    """chip_smoke's phase 5o checks with the loop each takes: 16-byte vectors
    for every aligned call of the models (rows, the float32 (T, 3) heads,
    the conv's channel-first views, the positions, a single bias), one
    element at a time for unaligned views and lengths no vector divides."""
    import chip_smoke

    paths = ["vector"] * 14 + ["scalar"] * 2 + ["vector", "scalar", "scalar", None]
    return list(zip(chip_smoke.BIAS_CHECKS, paths))


@pytest.mark.parametrize("case,path", _bias_cases(), ids=lambda c: "-".join(map(str, c))
                         if isinstance(c, tuple) else str(c))
def test_bias_kernel_equals_the_plain_chain(cuda_device, case, path):
    """The output (bits and layout), dy, db and the residual's cotangent
    equal to the chain's (``torch.equal``: no bit differs); two launches
    bit-equal; one call on the kernel's path, none plain
    (``chip_smoke.check_bias`` raises otherwise, and for a float16 tensor
    or a b of another dtype that does not raise)."""
    import chip_smoke

    (line,) = chip_smoke.check_bias(cuda_device, cases=(case,))
    assert not any(line["bits_differ"].values()) and line["same_layout"]
    if path is not None:
        assert line["path"] == path


def _bias_grads(y, b, r, g):
    leaves = [t.detach().requires_grad_() for t in (y, b, r)]
    out = bias_ops.add_bias(*leaves)
    return (out, *torch.autograd.grad(out, leaves, g))


def test_bias_kernel_inside_a_captured_graph(cuda_device):
    """The residual add forward and backward through the dispatcher captured
    as one CUDA graph, replayed on new inputs written into its static
    buffers: each replay bit-equal to the kernel run eagerly on them."""
    import chip_smoke

    def inputs(seed):
        return chip_smoke.bias_inputs(cuda_device, "rows", (4096, 64), torch.bfloat16, 1, True,
                                      seed=seed)

    static = inputs(1)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        _bias_grads(*static)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _bias_grads(*static)
    for seed in (2, 3):
        fresh = inputs(seed)
        for s, f in zip(static, fresh):
            s.copy_(f)
        graph.replay()
        torch.cuda.synchronize()
        want = _bias_grads(*fresh)
        assert all(torch.equal(a, b) for a, b in zip(out, want))


def test_graphed_steps_take_the_bias_kernel_with_the_chains_bits(cuda_device):
    """Three graphed steps of the flag and varlen2 recipes (B=64) with the
    kernel and again with the plain chain patched into the models: every
    loss and state tensor bit-equal; a replayed step counts each add on the
    kernel, none plain: the masked step 239 bias adds and 56 residual adds
    (8 a transformer forward, 7 forwards), the flagship step 170
    (``chip_smoke.bias_paths_bit_equal`` raises otherwise)."""
    import chip_smoke

    lines = chip_smoke.bias_paths_bit_equal(cuda_device, batch=64)
    assert {line["recipe"]: line["calls_per_step"] for line in lines} == {
        "flag": {"bias/cuda": 170}, "varlen2": {"bias/cuda": 239, "bias_residual/cuda": 56}}
    assert all(line["bit_equal"] for line in lines)


@pytest.mark.parametrize("y_dtype,b_dtype,b_shape,residual_shape", [
    (torch.float16, torch.float16, (64,), None), (torch.float64, torch.float64, (64,), None),
    (torch.bfloat16, torch.float32, (64,), None), (torch.bfloat16, torch.bfloat16, (1, 64), None),
    (torch.bfloat16, torch.bfloat16, (4,), None), (torch.float32, torch.float32, (64,), (1, 64))])
def test_bias_operands_off_the_kernel_raise_on_the_card(cuda_device, y_dtype, b_dtype, b_shape,
                                                        residual_shape):
    """Card tensors the kernel does not take raise ValueError naming it and
    count nothing: the plain chain runs on the CPU only."""
    y = torch.zeros(4, 64, dtype=y_dtype, device=cuda_device)
    b = torch.zeros(b_shape, dtype=b_dtype, device=cuda_device)
    r = None if residual_shape is None else torch.zeros(residual_shape, dtype=y_dtype,
                                                        device=cuda_device)
    before = dict(bias_launches.launches_by_path)
    with pytest.raises(ValueError, match=r"bias kernel takes"):
        bias_ops.add_bias(y, b, r)
    assert dict(bias_launches.launches_by_path) == before



# -- the sampling loop: each chunk a replay of a CUDA graph ----------------------------------


TRANSFORMER = dict(generator_type="transformer", time_head="monotone", compute_dtype="bfloat16")


def _sampling_inputs(config, n, seed=0):
    """n prototypes and padding masks (lengths 12-L, as the variable-length
    cell's) and an injected z."""
    rng = np.random.default_rng(seed)
    L = config.seq_length
    protos = rng.uniform(-1, 1, (n, L, 3)).astype(np.float32)
    masks = (np.arange(L)[None] < rng.integers(12, L + 1, n)[:, None]).astype(np.float32)
    z = rng.normal(size=(n, config.latent_dim)).astype(np.float32)
    return protos, masks, z


def _eager_chunks(generator, protos, seed=0, truncation=1.0, batch=512, z=None, masks=None):
    """The chunk loop run eagerly on the card: ``sample_chunk``, the function
    the sampling graph captures, once a chunk with the chunk's own key."""
    from wordgesture_gan_tpu_torch.train.sample_graph import chunk_keys, sample_chunk
    from wordgesture_gan_tpu_torch.utils.chunking import chunk_layout, pad_to_chunks

    n = len(protos)
    chunk, n_chunks = chunk_layout(n, batch)
    device = next(generator.parameters()).device

    def rows(a):
        return torch.from_numpy(pad_to_chunks(a, chunk, n_chunks)).to(device).unflatten(
            0, (n_chunks, chunk))

    inputs = {"proto": rows(protos)}
    if masks is not None:
        inputs["mask"] = rows(masks)
    if z is not None:
        inputs["z"] = rows(z)
    else:
        inputs["key"] = chunk_keys(seed, n_chunks).to(device)
    with torch.inference_mode(), layers.jax_products():
        outs = [sample_chunk(generator, truncation, **{k: v[c] for k, v in inputs.items()})
                for c in range(n_chunks)]
    return torch.cat(outs).cpu().numpy()[:n]


def _sample(generator, protos, seed=0, truncation=1.0, batch=512, z=None, masks=None):
    from wordgesture_gan_tpu_torch.train.gan_loop import generate_gestures

    return generate_gestures(generator, protos, generator.config, truncation=truncation,
                             seed=seed, batch=batch, device="cuda", z=z, masks=masks)


def _graphs(generator):
    from wordgesture_gan_tpu_torch.train.sample_graph import SampleGraph

    return SampleGraph.of(generator)


@pytest.mark.parametrize("n", [40, 256, 300])
def test_graphed_sampling_equals_the_eager_chunks(cuda_device, n):
    """The masked transformer at batch 64: one chunk, four, and five with a
    ragged last. Two calls, bit-equal to the eager chunk loop on the card:
    the first warms up and captures, the second replays every chunk."""
    gen = Generator(ModelConfig(**TRANSFORMER), prng.PRNGKey(5)).to(cuda_device)
    protos, masks, _ = _sampling_inputs(gen.config, n)
    want = _eager_chunks(gen, protos, seed=11, batch=64, masks=masks)
    chunks = -(-n // 64)
    for call in range(2):
        got = _sample(gen, protos, seed=11, batch=64, masks=masks)
        np.testing.assert_array_equal(got, want)
        assert (_graphs(gen).captures, _graphs(gen).replays) == (1, (call + 1) * chunks - 1)
    assert np.abs(want).max() > 0 and (want[masks == 0] == 0).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_graphed_sampling_of_the_bilstm(cuda_device, dtype):
    """The flagship generator (kernel 1 on its bf16 or its float32 path) at
    batch 128, three chunks, no masks: bit-equal to the eager chunks."""
    gen = Generator(ModelConfig(time_head="monotone", compute_dtype=dtype),
                    prng.PRNGKey(6)).to(cuda_device)
    protos, _, _ = _sampling_inputs(gen.config, 300, seed=1)
    want = _eager_chunks(gen, protos, seed=3, batch=128)
    for _ in range(2):
        np.testing.assert_array_equal(_sample(gen, protos, seed=3, batch=128), want)
    assert (_graphs(gen).captures, _graphs(gen).replays) == (1, 5)


@pytest.mark.parametrize("given_z,truncation", [(False, 0.7), (True, 1.0), (True, 0.7)])
def test_graphed_sampling_with_z_and_truncation(cuda_device, given_z, truncation):
    """An injected z, and the truncation, each captured as the eager loop
    runs them; another truncation is another graph."""
    gen = Generator(ModelConfig(**TRANSFORMER), prng.PRNGKey(7)).to(cuda_device)
    protos, masks, z = _sampling_inputs(gen.config, 300, seed=2)
    z = z if given_z else None
    want = _eager_chunks(gen, protos, seed=4, truncation=truncation, batch=64, z=z, masks=masks)
    for _ in range(2):
        got = _sample(gen, protos, seed=4, truncation=truncation, batch=64, z=z, masks=masks)
        np.testing.assert_array_equal(got, want)
    other = _sample(gen, protos, seed=4, truncation=0.5, batch=64, z=z, masks=masks)
    np.testing.assert_array_equal(
        other, _eager_chunks(gen, protos, seed=4, truncation=0.5, batch=64, z=z, masks=masks))
    assert _graphs(gen).captures == 2


def test_graphed_sampling_draws_each_calls_own_keys(cuda_device):
    """A second call at another seed replays the first call's graph with its
    own keys in the static key buffer: that seed's draws, not stale ones."""
    gen = Generator(ModelConfig(**TRANSFORMER), prng.PRNGKey(8)).to(cuda_device)
    protos, masks, _ = _sampling_inputs(gen.config, 300, seed=3)
    first = _sample(gen, protos, seed=21, batch=64, masks=masks)
    second = _sample(gen, protos, seed=22, batch=64, masks=masks)
    np.testing.assert_array_equal(first, _eager_chunks(gen, protos, seed=21, batch=64,
                                                       masks=masks))
    np.testing.assert_array_equal(second, _eager_chunks(gen, protos, seed=22, batch=64,
                                                        masks=masks))
    assert not np.allclose(first, second) and _graphs(gen).captures == 1


def test_replaced_parameters_are_captured_again(cuda_device):
    """A parameter replaced (a new storage) drops the graphs and the next
    call captures anew; a parameter changed in place keeps the graph, which
    reads the new values."""
    gen = Generator(ModelConfig(**TRANSFORMER), prng.PRNGKey(9)).to(cuda_device)
    protos, masks, _ = _sampling_inputs(gen.config, 300, seed=4)
    _sample(gen, protos, seed=5, batch=64, masks=masks)
    gen.out.w = torch.nn.Parameter(gen.out.w * 2)
    got = _sample(gen, protos, seed=5, batch=64, masks=masks)
    np.testing.assert_array_equal(got, _eager_chunks(gen, protos, seed=5, batch=64, masks=masks))
    assert _graphs(gen).captures == 2 and len(_graphs(gen).graphs) == 1
    with torch.no_grad():
        gen.out.b.add_(0.25)
    got = _sample(gen, protos, seed=5, batch=64, masks=masks)
    np.testing.assert_array_equal(got, _eager_chunks(gen, protos, seed=5, batch=64, masks=masks))
    assert _graphs(gen).captures == 2


@pytest.mark.parametrize("family", ["transformer", "bilstm"])
def test_graphed_sampling_counts_the_eager_loops_launches(cuda_device, family):
    """A replay launches from no Python wrapper: each adds what its capture
    counted, so a call counts the draws, kernel 1, the activations, the
    attention, the layer norms and the bias adds the eager loop counts,
    capturing or replaying."""
    from wordgesture_gan_tpu_torch.ops.threefry import threefry_draw
    from wordgesture_gan_tpu_torch.train.step_graph import COUNTED, launch_counts

    def launched(fn):
        before = launch_counts()
        fn()
        return [(n1 - n0, {p: k - b0.get(p, 0) for p, k in b1.items()})
                for (n0, b0), (n1, b1) in zip(before, launch_counts())]

    fields = TRANSFORMER if family == "transformer" else dict(compute_dtype="bfloat16")
    gen = Generator(ModelConfig(**fields), prng.PRNGKey(10)).to(cuda_device)
    protos, masks, _ = _sampling_inputs(gen.config, 300, seed=5)
    masks = masks if family == "transformer" else None
    eager = launched(lambda: _eager_chunks(gen, protos, batch=64, masks=masks))
    assert eager[COUNTED.index(threefry_draw)][0] == 5          # one draw a chunk
    norms = 2 * gen.config.tfm_num_layers + 1 if family == "transformer" else 0
    assert eager[COUNTED.index(layernorm_launches)][1][("layernorm_fwd", "cuda")] == 5 * norms
    assert norms in (0, 9)                                      # 9 forwards a chunk
    adds = ({("bias", "cuda"): 11, ("bias_residual", "cuda"): 8} if family == "transformer"
            else {("bias", "cuda"): 1})                         # a forward's, one a chunk
    assert {k: n for k, n in eager[COUNTED.index(bias_launches)][1].items() if n} == {
        k: 5 * n for k, n in adds.items()}
    for _ in range(2):
        assert launched(lambda: _sample(gen, protos, batch=64, masks=masks)) == eager


# -- the sampling loop's staging: pinned host buffers and card buffers kept across calls --------


def _family(family, seed):
    """The transformer with padding masks, or the BiLSTM at fixed length,
    on the card; returns the generator and whether it takes masks."""
    fields = TRANSFORMER if family == "transformer" else dict(time_head="monotone",
                                                              compute_dtype="bfloat16")
    gen = Generator(ModelConfig(**fields), prng.PRNGKey(seed)).to("cuda")
    return gen, family == "transformer"


def _staged_rows(generator):
    """The card buffers of the row arguments, as the last call left them."""
    return {k: card for k, (_, card) in _graphs(generator)._buffers.items() if k != "out"}


@pytest.mark.parametrize("given_z", [False, True], ids=["keys", "z"])
@pytest.mark.parametrize("n", [1, 63, 64, 197])
@pytest.mark.parametrize("family", ["transformer", "bilstm"])
def test_staged_sampling_equals_the_eager_chunks(cuda_device, family, n, given_z):
    """At batch 64: one row, a chunk less one, a chunk, and three chunks and
    five rows; drawn from the keys or from a given z. Two calls, each
    bit-equal to the eager chunk loop on the card, each a new array of n
    rows that owns its memory."""
    gen, masked = _family(family, 20)
    protos, masks, z = _sampling_inputs(gen.config, n, seed=6)
    masks, z = masks if masked else None, z if given_z else None
    want = _eager_chunks(gen, protos, seed=13, batch=64, z=z, masks=masks)
    got = [_sample(gen, protos, seed=13, batch=64, z=z, masks=masks) for _ in range(2)]
    for out in got:
        np.testing.assert_array_equal(out, want)
        assert out.shape == (n, gen.config.seq_length, 3) and out.flags.owndata
    assert not np.shares_memory(*got)


@pytest.mark.parametrize("family", ["transformer", "bilstm"])
def test_back_to_back_calls_return_their_own_arrays(cuda_device, family):
    """Calls of 16,384, 300 and 16,384 rows at batch 512, each on its own
    prototypes and seed, reuse the buffers the first one grew: each returns
    its own array, bit-equal to the eager chunks, and no later call changes
    an earlier result."""
    gen, masked = _family(family, 21)
    got, kept = [], []
    for i, n in enumerate((16384, 300, 16384)):
        protos, masks, _ = _sampling_inputs(gen.config, n, seed=30 + i)
        masks = masks if masked else None
        out = _sample(gen, protos, seed=40 + i, masks=masks)
        np.testing.assert_array_equal(out, _eager_chunks(gen, protos, seed=40 + i, masks=masks))
        got.append(out)
        kept.append(out.copy())
    for out, copy in zip(got, kept):
        np.testing.assert_array_equal(out, copy)
        assert out.flags.owndata
    assert not any(np.shares_memory(a, b) for i, a in enumerate(got) for b in got[i + 1:])
    assert _graphs(gen).captures == 1     # 300 rows are one chunk of 512 too


@pytest.mark.parametrize("family", ["transformer", "bilstm"])
def test_padding_rows_stay_out_of_the_result(cuda_device, family):
    """A ragged call after a whole one: the last chunk's padding rows are
    zero on the card (not the earlier call's rows), and the result holds the
    n real rows alone, bit-equal to the eager chunks, which pad with zeros."""
    gen, masked = _family(family, 22)
    protos, masks, z = _sampling_inputs(gen.config, 256, seed=7)
    masks = masks if masked else None
    for given_z in (None, z):
        _sample(gen, protos, seed=8, batch=64, z=given_z, masks=masks)
        assert all(card.abs().amax() > 0 for card in _staged_rows(gen).values())
        got = _sample(gen, protos[:197], seed=8, batch=64,
                      z=None if given_z is None else given_z[:197],
                      masks=None if masks is None else masks[:197])
        assert got.shape[0] == 197
        np.testing.assert_array_equal(got, _eager_chunks(
            gen, protos[:197], seed=8, batch=64, z=None if given_z is None else given_z[:197],
            masks=None if masks is None else masks[:197]))
        staged = _staged_rows(gen)
        assert set(staged) == {"proto"} | ({"mask"} if masked else set()) \
            | (set() if given_z is None else {"z"})
        for card in staged.values():
            assert card.shape[0] >= 256 and not card[197:256].any()


@pytest.mark.parametrize("family", ["transformer", "bilstm"])
def test_staged_sampling_after_the_generator_moves(cuda_device, family):
    """After ``generator.to`` away and back, or a parameter replaced, the
    graphs and the staging buffers are dropped, the next call captures and
    stages anew, and its result is still the eager chunks'."""
    gen, masked = _family(family, 23)
    protos, masks, _ = _sampling_inputs(gen.config, 300, seed=9)
    masks = masks if masked else None

    def check(captures):
        np.testing.assert_array_equal(_sample(gen, protos, seed=10, batch=64, masks=masks),
                                      _eager_chunks(gen, protos, seed=10, batch=64, masks=masks))
        assert _graphs(gen).captures == captures

    check(1)
    buffers = dict(_graphs(gen)._buffers)
    gen.to("cpu").to(cuda_device)
    check(2)
    assert all(_graphs(gen)._buffers[k] is not v for k, v in buffers.items())
    buffers = dict(_graphs(gen)._buffers)
    gen.out.w = torch.nn.Parameter(gen.out.w * 2)
    check(3)
    assert all(_graphs(gen)._buffers[k] is not v for k, v in buffers.items())
    check(3)
