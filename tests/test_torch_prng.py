"""The port's random streams (``utils/prng.py``) against ``jax.random``.

Keys, splits, fold-ins, bits, uniforms, permutations and randints are held
bit-equal to the installed JAX (threefry2x32, partitionable bits, 32-bit
mode) at four seeds, normals within 2 ulp; then a train step's key chain
and the epoch shuffle (the FID autoencoder's and the scale metrics' draws
at a seed are ``test_torch_metrics.py``'s and ``test_torch_large_scale.py``'s).
The CUDA kernel's side of the
draws is ``chip_smoke.py``'s (it holds the kernel bit-equal to these plain
versions); here a CUDA-less wrapper call must refuse CPU keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test worker

from wordgesture_gan_tpu.train.gan_step import make_epoch_batches as jax_make_epoch_batches
from wordgesture_gan_tpu.train.masked_step import (
    make_epoch_batches_masked as jax_make_epoch_batches_masked)
from wordgesture_gan_tpu_torch.ops.threefry import threefry_draw
from wordgesture_gan_tpu_torch.train.gan_step import make_epoch_batches
from wordgesture_gan_tpu_torch.train.masked_step import make_epoch_batches_masked
from wordgesture_gan_tpu_torch.train.step_graph import step_keys, step_noise
from wordgesture_gan_tpu_torch.utils import prng

SEEDS = (0, 42, 0x5EED ^ 42, 2 ** 31 - 1)
SHAPES = ((5, 512, 32), (512, 32), (7,))


def _np(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_splits_and_fold_ins_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    ours = prng.PRNGKey(seed)
    assert np.array_equal(_np(key), ours.numpy())
    for n in (2, 3, 4, 5, 14):
        assert np.array_equal(_np(jax.random.split(key, n)), prng.split(ours, n).numpy())
    for data in (0, 1, 7, 199, 2 ** 31 - 1):
        assert np.array_equal(_np(jax.random.fold_in(key, data)), prng.fold_in(ours, data).numpy())
    assert torch.equal(prng.as_key(np.asarray(key)), ours)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniforms_equal_jax(seed, shape):
    key, ours = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert np.array_equal(_np(jax.random.bits(key, shape)), prng.random_bits(ours, shape).numpy())
    # The initializers' bounds: 1/sqrt(fan) is not a power of two, so the
    # scale-and-shift is one fused multiply-add, as XLA computes it.
    for bound in (1.0, 1 / np.sqrt(48), 1 / np.sqrt(384), 0.25):
        want = np.asarray(jax.random.uniform(key, shape, jnp.float32, -bound, bound))
        got = prng.uniform(ours, shape, -bound, bound).numpy()
        assert np.array_equal(want, got), bound
    assert np.array_equal(np.asarray(jax.random.uniform(key, shape)),
                          prng.uniform(ours, shape).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_normals_within_two_ulp_of_jax(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = prng.normal(prng.PRNGKey(seed), shape).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    assert _ulps(want, got) <= 2


def test_a_stack_of_keys_draws_each_row_with_its_key():
    keys = prng.split(prng.PRNGKey(3), 4)
    rows = prng.normal(keys, (6, 5))
    assert rows.shape == (4, 6, 5)
    for k, row in zip(keys, rows):
        assert torch.equal(row, prng.normal(k, (6, 5)))
    bits = prng.random_bits(keys, (9,))
    assert torch.equal(bits[2], prng.random_bits(keys[2], (9,)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", (1, 2, 1000, 1626, 20331))
def test_permutations_equal_jax(seed, n):
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
    assert np.array_equal(want, prng.permutation(prng.PRNGKey(seed), n).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_randints_and_choices_equal_jax(seed):
    key, ours = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for lo, hi in ((0, 100000), (1, 2170), (0, 7), (1, 2)):
        want = np.asarray(jax.random.randint(key, (4096,), lo, hi))
        assert np.array_equal(want, prng.randint(ours, (4096,), lo, hi).numpy()), (lo, hi)
    want = np.asarray(jax.random.choice(key, 5115, (300,), replace=False))
    assert np.array_equal(want, prng.permutation(ours, 5115)[:300].numpy())


def test_the_kernel_wrapper_refuses_cpu_keys():
    with pytest.raises(ValueError, match="CUDA"):
        threefry_draw(prng.PRNGKey(0), (4,), "normal")


@pytest.mark.parametrize("n_critic, diversity", [(5, True), (5, False), (0, False)])
def test_a_steps_key_chain_is_the_jax_steps(n_critic, diversity):
    """The splits of ``train/gan_step.py:124-180`` of the JAX package, and
    each draw's normal at (B, Z)."""
    rng = jax.random.PRNGKey(11)
    kz, ke = [], []
    for _ in range(n_critic):
        rng, a, b = jax.random.split(rng, 3)
        kz.append(a)
        ke.append(b)
    rng, kz1, ke1, ke2 = jax.random.split(rng, 4)
    want = kz + ke + [kz1, ke1, ke2]
    if diversity:
        rng, kz_ms = jax.random.split(rng)
        want.append(kz_ms)
    got_rng, keys = step_keys(prng.PRNGKey(11), n_critic, diversity)
    assert np.array_equal(_np(rng), got_rng.numpy())
    assert np.array_equal(np.stack([_np(k) for k in want]), keys.numpy())
    noise = step_noise(keys, 6, 4, n_critic)
    assert noise["z_rand"].shape == noise["eps_enc"].shape == (n_critic, 6, 4)
    assert ("z_ms" in noise) == diversity
    for i in range(n_critic):
        assert _ulps(np.asarray(jax.random.normal(kz[i], (6, 4))), noise["z_rand"][i]) <= 2
        assert _ulps(np.asarray(jax.random.normal(ke[i], (6, 4))), noise["eps_enc"][i]) <= 2
    for name, k in zip(("z1", "eps_rec", "eps2", "z_ms"), want[2 * n_critic:]):
        assert _ulps(np.asarray(jax.random.normal(k, (6, 4))), noise[name]) <= 2


@pytest.mark.parametrize("epoch", (0, 1, 199))
def test_epoch_batches_equal_jax(epoch):
    """The training loops' shuffle, ``fold_in(PRNGKey(seed ^ 0x5EED),
    epoch)`` (JAX ``train/gan_loop.py:177``), then the epoch's batches."""
    rng = np.random.default_rng(epoch)
    g = rng.random((53, 8, 3)).astype(np.float32)
    p = rng.random((53, 8, 3)).astype(np.float32)
    m = (rng.random((53, 8)) > 0.3).astype(np.float32)
    jkey = jax.random.fold_in(jax.random.PRNGKey(42 ^ 0x5EED), epoch)
    key = prng.fold_in(prng.PRNGKey(42 ^ 0x5EED), epoch)
    want = jax_make_epoch_batches(jkey, jnp.asarray(g), jnp.asarray(p), 16)
    got = make_epoch_batches(key, torch.from_numpy(g), torch.from_numpy(p), 16)
    for k in ("gesture", "prototype"):
        assert np.array_equal(np.asarray(want[k]), got[k].numpy())
    want = jax_make_epoch_batches_masked(jkey, jnp.asarray(g), jnp.asarray(p), jnp.asarray(m), 16)
    got = make_epoch_batches_masked(key, *(torch.from_numpy(a) for a in (g, p, m)), 16)
    for k in ("gesture", "prototype", "mask"):
        assert np.array_equal(np.asarray(want[k]), got[k].numpy())

