"""The port's training pair (kernels 2 and 3: ``ops/bilstm_train.py``) and the
generator's differentiated path against the JAX package, on the CPU.

Inputs and cotangents come from numpy seeds; weights move from the JAX tree
with ``generator_from_jax``. Tolerances: the float32 plain pair against
``jax.grad`` of the XLA scan, 1e-5 (same math, other summation order); the
bfloat16 plain pair against the Pallas pair in interpret mode, output 2e-2
abs and gradients 2e-2 relative to the largest magnitude of each leaf (a
one-ulp bf16 flip of a residual or of the gradient passed down propagates).
The CUDA kernels themselves are held to these plain versions on the GPU
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test worker

from wordgesture_gan_tpu.configs import ModelConfig as JaxModelConfig
from wordgesture_gan_tpu.models.gan import generator_apply as jax_generator_apply
from wordgesture_gan_tpu.models.gan import generator_init as jax_generator_init
from wordgesture_gan_tpu.models.layers import bilstm_apply as jax_bilstm_apply
from wordgesture_gan_tpu.models.layers import bilstm_init
from wordgesture_gan_tpu.ops.bilstm_train import bilstm_train_apply as jax_bilstm_train_apply
from wordgesture_gan_tpu_torch.configs import ModelConfig
from wordgesture_gan_tpu_torch.interop.from_jax import generator_from_jax
from wordgesture_gan_tpu_torch.models.gan import Generator
from wordgesture_gan_tpu_torch.ops.bilstm_fused import fused_bilstm_fwd_plain
from wordgesture_gan_tpu_torch.ops.bilstm_train import (backward_weights, bilstm_train_apply,
                                                        bilstm_train_bwd, bilstm_train_bwd_plain,
                                                        bilstm_train_fwd, bilstm_train_fwd_plain)

CELL = ("w_ih", "w_hh", "b_ih", "b_hh")


def _stack(seed, in_dim, hidden, num_layers):
    """(JAX stack, the same weights as leaf tensors that require grad)."""
    jl = jax.device_get(bilstm_init(jax.random.PRNGKey(seed), in_dim, hidden, num_layers))
    tl = [{d: {k: torch.tensor(np.asarray(layer[d][k]), requires_grad=True) for k in CELL}
           for d in ("fwd", "bwd")} for layer in jl]
    return jl, tl


def _inputs(seed, B, L, Z, H):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, L, 2)).astype(np.float32),
            rng.normal(size=(B, Z)).astype(np.float32),
            rng.normal(size=(B, L, 2 * H)).astype(np.float32))


def _port_grads(tl, x, z, dy, H, dtype):
    xs = torch.tensor(x, requires_grad=True)
    zs = torch.tensor(z, requires_grad=True)
    y = bilstm_train_apply(tl, xs, zs, H, dtype=dtype)
    leaves = [tl[k][d][n] for k in range(len(tl)) for d in ("fwd", "bwd") for n in CELL]
    grads = torch.autograd.grad((y.float() * torch.from_numpy(dy)).sum(), leaves + [xs, zs])
    return y, grads


def _jax_grads(fn, jl, x, z, dy):
    g_layers, gx, gz = jax.grad(lambda layers, x, z: jnp.sum(fn(layers, x, z) * dy),
                                argnums=(0, 1, 2))(jl, jnp.asarray(x), jnp.asarray(z))
    leaves = [g_layers[k][d][n] for k in range(len(jl)) for d in ("fwd", "bwd") for n in CELL]
    return [np.asarray(g, np.float32) for g in leaves + [gx, gz]]


@pytest.mark.parametrize("num_layers,B,L", [(1, 6, 16), (2, 6, 16), (4, 6, 16), (2, 5, 9),
                                            (3, 1, 1)])
def test_plain_pair_fp32_matches_jax_grad(num_layers, B, L):
    """Forward output and every gradient — each weight, the biases, dz and
    the prototype gradient dx — against jax.grad of the XLA scan."""
    H, Z = 8, 4
    jl, tl = _stack(num_layers, 2 + Z, H, num_layers)
    x, z, dy = _inputs(num_layers + B, B, L, Z, H)
    y, grads = _port_grads(tl, x, z, dy, H, torch.float32)
    ref_y = jax_bilstm_apply(jl, jnp.asarray(x), H, static=jnp.asarray(z))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_y), atol=1e-5)
    ref = _jax_grads(lambda layers, x, z: jax_bilstm_apply(layers, x, H, static=z), jl, x, z, dy)
    assert len(grads) == len(ref) == 8 * num_layers + 2
    for got, want in zip(grads, ref):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_plain_pair_bf16_matches_pallas_interpret(num_layers):
    """The bf16 casting contract of both passes against the Pallas pair."""
    H, Z, B, L = 8, 4, 6, 16
    jl, tl = _stack(10 + num_layers, 2 + Z, H, num_layers)
    x, z, dy = _inputs(20 + num_layers, B, L, Z, H)
    y, grads = _port_grads(tl, x, z, dy, H, torch.bfloat16)
    assert y.dtype == torch.bfloat16

    def pallas(layers, x, z):
        return jax_bilstm_train_apply(layers, x, z, H, dtype=jnp.bfloat16,
                                      interpret=True).astype(jnp.float32)

    ref_y = pallas(jl, jnp.asarray(x), jnp.asarray(z))
    np.testing.assert_allclose(y.float().detach().numpy(), np.asarray(ref_y), atol=2e-2)
    for got, want in zip(grads, _jax_grads(pallas, jl, x, z, dy)):
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got.numpy() - want).max()) <= 2e-2 * scale


def test_generator_training_path_has_lstm_gradients():
    """The repair: a loss through ``inference=False`` reaches every LSTM
    weight, non-zero and equal to jax.grad of ``generator_apply``."""
    fields = dict(seq_length=16, gen_hidden_dim=8, gen_num_layers=2, latent_dim=4,
                  time_head="monotone")
    params = jax.device_get(jax_generator_init(jax.random.PRNGKey(3), JaxModelConfig(**fields)))
    model = Generator(ModelConfig(**fields))
    model.load_state_dict(generator_from_jax(params))
    rng = np.random.default_rng(4)
    proto = rng.uniform(-1, 1, (5, 16, 3)).astype(np.float32)
    z = rng.normal(size=(5, 4)).astype(np.float32)
    target = rng.normal(size=(5, 16, 3)).astype(np.float32)

    out = model(torch.from_numpy(proto), torch.from_numpy(z), inference=False)
    loss = ((out - torch.from_numpy(target)) ** 2).sum()
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))

    def jax_loss(p):
        g = jax_generator_apply(p, jnp.asarray(proto), jnp.asarray(z), JaxModelConfig(**fields))
        return jnp.sum((g - target) ** 2)

    ref = generator_from_jax(jax.device_get(jax.grad(jax_loss)(params)))
    assert set(ref) == set(grads)
    for name in names:
        if name.startswith("lstm."):
            assert grads[name].abs().max() > 0, name
        np.testing.assert_allclose(grads[name].numpy(), ref[name].numpy(), atol=1e-5, err_msg=name)


def test_inference_path_carries_no_gradient():
    model = Generator(ModelConfig(seq_length=8, gen_hidden_dim=4, gen_num_layers=1,
                                  latent_dim=2))
    lstm = list(model.lstm.parameters())
    for inference in (True, False):
        out = model(torch.zeros(2, 8, 3), torch.zeros(2, 2), inference=inference)
        grads = torch.autograd.grad(out.sum(), lstm, allow_unused=True)
        assert all((g is None) == inference for g in grads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_forward_equals_inference_forward(dtype):
    H, Z, B, L = 8, 4, 3, 10
    _, tl = _stack(30, 2 + Z, H, 3)
    x, z, _ = _inputs(31, B, L, Z, H)
    y, res = bilstm_train_fwd_plain(tl, torch.from_numpy(x), torch.from_numpy(z), H, dtype)
    assert torch.equal(y, fused_bilstm_fwd_plain(tl, torch.from_numpy(x), H,
                                                 torch.from_numpy(z), dtype))
    assert res.shape == (3, 2, L, B, 6 * H) and res.dtype == dtype
    # The top layer's h planes are the output, by position.
    torch.testing.assert_close(res[-1, 0, :, :, :H].transpose(0, 1), y[..., :H], atol=0, rtol=0)
    torch.testing.assert_close(res[-1, 1, :, :, :H].transpose(0, 1), y[..., H:], atol=0, rtol=0)


def test_wrappers_on_cpu_are_the_plain_versions():
    H, Z, B, L = 8, 4, 3, 6
    _, tl = _stack(32, 2 + Z, H, 2)
    x, z, dy = (torch.from_numpy(a) for a in _inputs(33, B, L, Z, H))
    launches = (bilstm_train_fwd.launches, bilstm_train_bwd.launches)
    y, res = bilstm_train_fwd(tl, x, z, H, torch.bfloat16)
    y_p, res_p = bilstm_train_fwd_plain(tl, x, z, H, torch.bfloat16)
    assert torch.equal(y, y_p) and torch.equal(res, res_p)
    grads, dx, dz = bilstm_train_bwd(tl, x, z, res, dy, H, torch.bfloat16)
    grads_p, dx_p, dz_p = bilstm_train_bwd_plain(tl, x, z, res, dy, H, torch.bfloat16)
    assert torch.equal(dx, dx_p) and torch.equal(dz, dz_p)
    assert torch.equal(grads[1]["bwd"]["w_ih"], grads_p[1]["bwd"]["w_ih"])
    assert (bilstm_train_fwd.launches, bilstm_train_bwd.launches) == launches


@pytest.mark.parametrize("case", ["res_shape", "res_dtype", "dy_shape"])
def test_backward_rejects_mismatched_inputs(case):
    H, Z, B, L = 4, 2, 2, 3
    _, tl = _stack(34, 2 + Z, H, 1)
    x, z = torch.zeros(B, L, 2), torch.zeros(B, Z)
    res, dy = torch.zeros(1, 2, L, B, 6 * H), torch.zeros(B, L, 2 * H)
    if case == "res_shape":
        res = torch.zeros(1, 2, L + 1, B, 6 * H)
    elif case == "res_dtype":
        res = res.to(torch.bfloat16)
    else:
        dy = torch.zeros(B, L, H)
    with pytest.raises(ValueError):
        bilstm_train_bwd(tl, x, z, res, dy, H, torch.float32)


def test_backward_weight_layout():
    """Consecutive hidden units are contiguous for every (gate row, dir)."""
    H, Z, layers = 3, 2, 3
    _, tl = _stack(35, 2 + Z, H, layers)
    w = backward_weights(tl, H, torch.bfloat16)
    assert w["whhT"].shape == (layers, 4 * H, 2, H) and w["whhT"].dtype == torch.bfloat16
    assert w["wihT"].shape == (layers - 1, 4 * H, 2, 2 * H)
    assert w["wpT"].shape == (4 * H, 2, 2) and w["wz"].shape == (2, Z, 4 * H)
    for d, name in enumerate(("fwd", "bwd")):
        for g in range(4 * H):
            for j in range(H):
                assert w["whhT"][2, g, d, j] == tl[2][name]["w_hh"][j, g].to(torch.bfloat16)
                assert w["wihT"][1, g, d, H + j] == tl[2][name]["w_ih"][H + j, g].to(torch.bfloat16)
            assert w["wpT"][g, d, 1] == tl[0][name]["w_ih"][1, g].to(torch.bfloat16)
            assert w["wz"][d, 1, g] == tl[0][name]["w_ih"][3, g].to(torch.bfloat16)
