"""The PyTorch port's BiLSTM pieces against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both stacks; weights move from
the JAX tree with ``generator_from_jax``. Tolerances: float32 paths agree to
1e-5 abs (same math, different summation order); the bf16 plain version is
held to the Pallas kernel run in interpret mode at 2e-2 abs (bf16 rounding of
h at every step). The CUDA kernels' own tests are in test_torch_cuda.py; the
plain version is their oracle there, so it is held to the JAX package here at
every hidden size the tensor-core and float32 kernels are built for.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test worker

from wordgesture_gan_tpu.configs import ModelConfig as JaxModelConfig
from wordgesture_gan_tpu.models.gan import generator_apply, generator_init
from wordgesture_gan_tpu.models.layers import bilstm_apply as jax_bilstm_apply
from wordgesture_gan_tpu.models.layers import bilstm_init
from wordgesture_gan_tpu.ops.bilstm_fused import fused_bilstm_fwd as jax_fused_bilstm_fwd
from wordgesture_gan_tpu_torch.configs import ModelConfig
from wordgesture_gan_tpu_torch.interop.from_jax import generator_from_jax
from wordgesture_gan_tpu_torch.models.gan import Generator
from wordgesture_gan_tpu_torch.models.layers import (BiLSTM, bilstm_apply, dense_init,
                                                     lstm_cell_init)
from wordgesture_gan_tpu_torch.ops.bilstm_fused import (MMA_HIDDEN, fused_bilstm_fwd,
                                                        fused_bilstm_fwd_plain, kernel_path,
                                                        kernel_weights)
from wordgesture_gan_tpu_torch.train.gan_loop import generate_gestures
from wordgesture_gan_tpu_torch.utils import prng


def _stacks(seed, in_dim, hidden, num_layers):
    """(JAX stack, the same weights as the port's list-of-dicts stack)."""
    jl = bilstm_init(jax.random.PRNGKey(seed), in_dim, hidden, num_layers)
    state = generator_from_jax({"lstm": jax.device_get(jl),
                                "out": {"w": np.zeros((2 * hidden, 3)), "b": np.zeros(3)}})
    tl = [{d: {k: state[f"lstm.{i}.{d}.{k}"] for k in ("w_ih", "w_hh", "b_ih", "b_hh")}
           for d in ("fwd", "bwd")} for i in range(num_layers)]
    return jl, tl


def _inputs(seed, B, L, D, Z):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, L, D)).astype(np.float32),
            rng.normal(size=(B, Z)).astype(np.float32))


@pytest.mark.parametrize("num_layers", [1, 2, 4])
def test_plain_bilstm_matches_jax(num_layers):
    H, Z, B, L = 16, 8, 5, 12
    jl, tl = _stacks(0, 2 + Z, H, num_layers)
    x, z = _inputs(1, B, L, 2, Z)
    ref = jax_bilstm_apply(jl, jnp.asarray(x), H, static=jnp.asarray(z))
    out = bilstm_apply(tl, torch.from_numpy(x), H, static=torch.from_numpy(z))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_plain_bilstm_without_static_matches_jax():
    H, B, L = 16, 3, 10
    jl, tl = _stacks(2, 3, H, 2)
    x, _ = _inputs(3, B, L, 3, 1)
    ref = jax_bilstm_apply(jl, jnp.asarray(x), H)
    out = bilstm_apply(tl, torch.from_numpy(x), H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("num_layers", [1, 2, 4])
def test_fused_plain_fp32_matches_jax_scan(num_layers):
    H, Z, B, L = 16, 8, 6, 12
    jl, tl = _stacks(4, 2 + Z, H, num_layers)
    x, z = _inputs(5, B, L, 2, Z)
    ref = jax_bilstm_apply(jl, jnp.asarray(x), H, static=jnp.asarray(z))
    out = fused_bilstm_fwd_plain(tl, torch.from_numpy(x), H, torch.from_numpy(z),
                                 dtype=torch.float32)
    assert out.dtype == torch.float32 and out.shape == (B, L, 2 * H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("batch", [1, 5, 131])
def test_fused_plain_any_batch(batch):
    H, Z, L = 8, 4, 6
    jl, tl = _stacks(6, 2 + Z, H, 2)
    x, z = _inputs(batch, batch, L, 2, Z)
    ref = jax_bilstm_apply(jl, jnp.asarray(x), H, static=jnp.asarray(z))
    out = fused_bilstm_fwd_plain(tl, torch.from_numpy(x), H, torch.from_numpy(z),
                                 dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_fused_plain_bf16_matches_pallas_interpret(num_layers):
    """The bf16 casting contract: fp32 gates and cell, h rounded each step."""
    H, Z, B, L = 16, 8, 8, 16
    jl, tl = _stacks(7, 2 + Z, H, num_layers)
    x, z = _inputs(8, B, L, 2, Z)
    ref = jax_fused_bilstm_fwd(jl, jnp.asarray(x), H, jnp.asarray(z), dtype=jnp.bfloat16,
                               interpret=True)
    out = fused_bilstm_fwd_plain(tl, torch.from_numpy(x), H, torch.from_numpy(z),
                                 dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=2e-2)


@pytest.mark.parametrize("hidden", MMA_HIDDEN)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_plain_matches_jax_at_the_kernel_widths(dtype, hidden):
    """The oracle of the tensor-core ("mma") and float32 ("fp32") kernels at
    each hidden size they are built for, 3 layers, a batch no tile divides:
    float32 against the JAX scan (1e-5), bfloat16 against the Pallas kernel in
    interpret mode (2e-2: h rounded to bf16 every step)."""
    Z, B, L, layers = 8, 9, 12, 3
    assert kernel_path(getattr(torch, dtype), hidden, L, layers) == \
        ("mma" if dtype == "bfloat16" else "fp32")
    jl, tl = _stacks(20 + hidden, 2 + Z, hidden, layers)
    x, z = _inputs(21, B, L, 2, Z)
    out = fused_bilstm_fwd_plain(tl, torch.from_numpy(x), hidden, torch.from_numpy(z),
                                 dtype=getattr(torch, dtype))
    assert out.shape == (B, L, 2 * hidden) and out.dtype == getattr(torch, dtype)
    if dtype == "float32":
        ref = jax_bilstm_apply(jl, jnp.asarray(x), hidden, static=jnp.asarray(z))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    else:
        ref = jax_fused_bilstm_fwd(jl, jnp.asarray(x), hidden, jnp.asarray(z),
                                   dtype=jnp.bfloat16, interpret=True)
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_gestures_matches_jax_in_both_dtypes(dtype):
    """The serving path as a whole at a width on the new kernel paths (H=16,
    2 layers): chunked generation with injected z against the JAX package's
    ``generator_apply(inference=True)`` on the same weights. float32 1e-5;
    bfloat16 2e-2 (the JAX scan on the CPU rounds where the port's fused
    contract keeps float32: bf16 ulps of outputs in [-1, 1]; 1.4e-3 seen)."""
    fields = dict(seq_length=32, gen_hidden_dim=16, gen_num_layers=2, latent_dim=8,
                  time_head="monotone", compute_dtype=dtype)
    params = jax.device_get(generator_init(jax.random.PRNGKey(3), JaxModelConfig(**fields)))
    model = Generator(ModelConfig(**fields))
    model.load_state_dict(generator_from_jax(params))
    rng = np.random.default_rng(4)
    protos = rng.uniform(-1, 1, (7, 32, 3)).astype(np.float32)
    z = rng.normal(size=(7, 8)).astype(np.float32)
    out = generate_gestures(model, protos, model.config, batch=4, device="cpu", z=z)
    ref = generator_apply(params, jnp.asarray(protos), jnp.asarray(z), JaxModelConfig(**fields),
                          inference=True)
    assert out.shape == (7, 32, 3) and out.dtype == np.float32
    np.testing.assert_allclose(out, np.asarray(ref, np.float32),
                               atol=1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_is_the_plain_version(dtype):
    H, Z, B, L = 8, 4, 3, 5
    _, tl = _stacks(9, 2 + Z, H, 2)
    x, z = _inputs(10, B, L, 2, Z)
    before = fused_bilstm_fwd.launches
    got = fused_bilstm_fwd(tl, torch.from_numpy(x), H, torch.from_numpy(z), dtype=dtype)
    want = fused_bilstm_fwd_plain(tl, torch.from_numpy(x), H, torch.from_numpy(z), dtype=dtype)
    assert torch.equal(got, want)
    assert fused_bilstm_fwd.launches == before


@pytest.mark.parametrize("case", ["proto_dim", "static_batch", "static_width", "dtype"])
def test_wrapper_rejects_bad_inputs(case):
    H, Z, B, L = 8, 4, 3, 5
    _, tl = _stacks(11, 2 + Z, H, 1)
    x, z = torch.zeros(B, L, 2), torch.zeros(B, Z)
    dtype = torch.float32
    if case == "proto_dim":
        x = torch.zeros(B, L, 3)
    elif case == "static_batch":
        z = torch.zeros(B + 1, Z)
    elif case == "static_width":
        z = torch.zeros(B, Z + 1)
    else:
        dtype = torch.float16
    with pytest.raises(ValueError):
        fused_bilstm_fwd(tl, x, H, z, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_weight_layout(dtype):
    """Each (row, dir, unit) holds the unit's i, f, g, o weights in order."""
    H, Z, layers = 4, 3, 3
    _, tl = _stacks(12, 2 + Z, H, layers)
    w = kernel_weights(tl, H, dtype)
    assert w["wseq1"].shape == (2, 2, H, 4) and w["wseq1"].dtype == dtype
    assert w["wz"].shape == (Z, 2, H, 4) and w["wz"].dtype == torch.float32
    assert w["whh"].shape == (layers, H, 2, H, 4) and w["whh"].dtype == dtype
    assert w["wih"].shape == (layers - 1, 2 * H, 2, H, 4) and w["wih"].dtype == dtype
    assert w["bias"].shape == (layers, 2, H, 4) and w["bias"].dtype == torch.float32
    for d, name in enumerate(("fwd", "bwd")):
        for g in range(4):
            for j in range(H):
                col = g * H + j
                cell = tl[0][name]
                assert w["wseq1"][1, d, j, g] == cell["w_ih"][1, col].to(dtype)
                assert w["wz"][2, d, j, g] == cell["w_ih"][4, col]
                assert w["whh"][2, 3, d, j, g] == tl[2][name]["w_hh"][3, col].to(dtype)
                assert w["wih"][1, 5, d, j, g] == tl[2][name]["w_ih"][5, col].to(dtype)
                assert w["bias"][1, d, j, g] == tl[1][name]["b_ih"][col] + tl[1][name]["b_hh"][col]


def test_initializers_are_torch_default_and_seeded():
    g1, g2 = prng.PRNGKey(3), prng.PRNGKey(3)
    cell = lstm_cell_init(10, 16, g1)
    assert cell["w_ih"].shape == (10, 64) and cell["w_hh"].shape == (16, 64)
    assert cell["b_ih"].shape == (64,) and cell["b_hh"].shape == (64,)
    assert all(v.abs().max() <= 1 / 4 for v in cell.values())
    again = lstm_cell_init(10, 16, g2)
    assert all(torch.equal(cell[k], again[k]) for k in cell)
    dense = dense_init(25, 3, g1)
    assert dense["w"].shape == (25, 3) and dense["w"].abs().max() <= 0.2
    stack = BiLSTM(34, 8, 3, g1)
    assert [layer["fwd"].w_ih.shape[0] for layer in stack] == [34, 16, 16]
