"""The port's CUDA kernel against its plain PyTorch version, on the GPU.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernel is compiled by nvcc and runs only on the card). The file imports no
JAX, so on the GPU machine it runs on its own:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: float32 with TF32 off 1e-4 abs (summation order and the device's
transcendentals); bfloat16 2e-2 abs (h rounded to bf16 every step, so a
one-ulp flip propagates).
"""

import numpy as np
import pytest
import torch

from wordgesture_gan_tpu_torch.configs import ModelConfig
from wordgesture_gan_tpu_torch.models.gan import Generator
from wordgesture_gan_tpu_torch.models.layers import BiLSTM
from wordgesture_gan_tpu_torch.ops.bilstm_fused import fused_bilstm_fwd, fused_bilstm_fwd_plain

pytestmark = pytest.mark.cuda

ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel is compiled and run only on the GPU")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _case(device, batch, seq, hidden, layers, latent, seed=0):
    stack = BiLSTM(2 + latent, hidden, layers, torch.Generator().manual_seed(seed)).to(device)
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
    model = Generator(config, torch.Generator().manual_seed(3)).eval()
    rng = np.random.default_rng(4)
    proto = torch.from_numpy(rng.uniform(-1, 1, (6, 128, 3)).astype(np.float32))
    z = torch.from_numpy(rng.normal(size=(6, 32)).astype(np.float32))
    with torch.no_grad():
        want = model(proto, z)
        got = model.to(cuda_device)(proto.to(cuda_device), z.to(cuda_device)).cpu()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=0)
