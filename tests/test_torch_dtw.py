"""The PyTorch port's exact batched DTW against the JAX package, on the CPU.

Inputs come from numpy seeds (gesture-like walks) and go through both
packages. On the CPU the port's wrappers run ``dtw_pairs_plain``, the plain
version of the CUDA kernel ``csrc/dtw.cu`` (the kernel's own tests are in
test_torch_cuda.py). Tolerances: against the Pallas kernel run in interpret
mode and against the XLA row sweep, which compute the same closed form, 1e-5
relative (the XLA sweep takes its point costs as x² + y² − 2xy, which costs a
few float32 roundings more: 1e-4 there); against a float64 O(L²) recurrence,
1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test worker

from wordgesture_gan_tpu.ops.dtw import dtw_distance_matrix as jax_dtw_distance_matrix
from wordgesture_gan_tpu.ops.dtw import dtw_pairs as jax_dtw_pairs
from wordgesture_gan_tpu.ops.dtw_pallas import dtw_pairs_pallas
from wordgesture_gan_tpu.ops import fastdtw_approx as jax_fastdtw_approx
from wordgesture_gan_tpu_torch.ops import dtw as port_dtw
from wordgesture_gan_tpu_torch.ops.fastdtw_approx import dtw as fastdtw_exact
from wordgesture_gan_tpu_torch.ops.fastdtw_approx import fastdtw
from wordgesture_gan_tpu_torch.ops.dtw import (dtw_distance_matrix, dtw_matrix, dtw_pairs,
                                               dtw_pairs_plain)


def walks(seed: int, count: int, seq: int, dims: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    walk = np.cumsum(rng.normal(0.0, 0.05, (count, seq, dims)), axis=1)
    return np.clip(walk, -1.0, 1.0).astype(np.float32)


def dtw_float64(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """The classic recurrence in float64, vectorised over pairs."""
    x, y = x.astype(np.float64), y.astype(np.float64)
    P, L, _ = x.shape
    cost = np.sqrt(((x[:, :, None, :] - y[:, None, :, :]) ** 2).sum(-1))
    acc = np.full((P, L + 1, L + 1), np.inf)
    acc[:, 0, 0] = 0.0
    for i in range(1, L + 1):
        for j in range(1, L + 1):
            acc[:, i, j] = cost[:, i - 1, j - 1] + np.minimum(
                np.minimum(acc[:, i - 1, j], acc[:, i - 1, j - 1]), acc[:, i, j - 1])
    return acc[:, L, L]


def plain(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return dtw_pairs_plain(torch.from_numpy(x), torch.from_numpy(y)).numpy()


@pytest.mark.parametrize("dims", [2, 3])
def test_plain_matches_pallas_kernel_in_interpret_mode(dims):
    x, y = walks(0, 16, 128, dims), walks(1, 16, 128, dims)
    want = np.asarray(dtw_pairs_pallas(jnp.asarray(x), jnp.asarray(y), pair_tile=8,
                                       interpret=True))
    np.testing.assert_allclose(plain(x, y), want, rtol=1e-5)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("pairs,seq", [(1, 128), (13, 128), (7, 40)])
def test_plain_matches_jax_row_sweep(pairs, seq, dims):
    x, y = walks(2, pairs, seq, dims), walks(3, pairs, seq, dims)
    want = np.asarray(jax_dtw_pairs(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(plain(x, y), want, rtol=1e-4)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("seq", [1, 2, 33, 128])
def test_plain_matches_float64_recurrence(seq, dims):
    x, y = walks(4, 5, seq, dims), walks(5, 5, seq, dims)
    np.testing.assert_allclose(plain(x, y), dtw_float64(x, y), rtol=1e-5)


def test_exact_dtw_is_no_larger_than_fastdtw():
    x, y = walks(6, 6, 64, 2), walks(7, 6, 64, 2)
    exact = plain(x, y)
    for p in range(len(x)):
        approx, _ = fastdtw(x[p], y[p], radius=1, dist=2)
        assert exact[p] <= approx * (1 + 1e-5)
        assert exact[p] >= 0.5 * approx           # and not far below it on these walks


@pytest.mark.parametrize("radius,dist", [(1, 2), (1, None), (3, 2)])
def test_fastdtw_copy_matches_jax_package(radius, dist):
    """The port's own FastDTW (numpy) returns the JAX package's distances and
    warp paths; its exact ``dtw`` equals the port's plain DTW at dist=2."""
    x, y = walks(11, 4, 40, 2), walks(12, 4, 40, 2)
    for p in range(len(x)):
        got = fastdtw(x[p], y[p], radius=radius, dist=dist)
        want = jax_fastdtw_approx.fastdtw(x[p], y[p], radius=radius, dist=dist)
        assert got[0] == want[0] and got[1] == want[1]
        assert fastdtw_exact(x[p], y[p], dist=dist) == jax_fastdtw_approx.dtw(x[p], y[p],
                                                                               dist=dist)
    if dist == 2:
        exact = np.array([fastdtw_exact(x[p], y[p], dist=2)[0] for p in range(len(x))])
        np.testing.assert_allclose(plain(x, y), exact, rtol=1e-5)


def test_identical_sequences_have_zero_distance():
    x = walks(8, 3, 32, 2)
    np.testing.assert_allclose(plain(x, x), 0.0, atol=1e-6)


@pytest.mark.parametrize("n,m,dims", [(9, 7, 2), (4, 11, 3), (1, 1, 2)])
def test_distance_matrix_matches_jax(n, m, dims):
    real, fake = walks(9, n, 48, dims), walks(10, m, 48, dims)
    want = jax_dtw_distance_matrix(real, fake, use_pallas="never")
    got = dtw_distance_matrix(real, fake, device="cpu")
    assert got.shape == (n, m) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_matrix_entry_equals_aligned_pairs(monkeypatch):
    real, fake = torch.from_numpy(walks(11, 6, 32, 2)), torch.from_numpy(walks(12, 5, 32, 2))
    monkeypatch.setattr(port_dtw, "_PLAIN_PAIR_CHUNK", 7)      # several ragged chunks
    matrix = dtw_matrix(real, fake)
    idx = torch.arange(30)
    torch.testing.assert_close(matrix.reshape(-1), dtw_pairs(real[idx // 5], fake[idx % 5]),
                               rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    x, y = torch.from_numpy(walks(13, 3, 16, 2)), torch.from_numpy(walks(14, 3, 16, 2))
    before = dtw_pairs.launches, dtw_matrix.launches
    torch.testing.assert_close(dtw_pairs(x, y), dtw_pairs_plain(x, y), rtol=0, atol=0)
    dtw_matrix(x, y)
    assert (dtw_pairs.launches, dtw_matrix.launches) == before


@pytest.mark.parametrize("x_shape,y_shape", [((3, 8, 2), (3, 9, 2)), ((3, 8, 2), (3, 8, 3)),
                                             ((3, 8, 2), (4, 8, 2)), ((8, 2), (8, 2)),
                                             ((0, 8, 2), (0, 8, 2))])
def test_aligned_pairs_reject_mismatched_shapes(x_shape, y_shape):
    with pytest.raises(ValueError):
        dtw_pairs(torch.zeros(x_shape), torch.zeros(y_shape))


@pytest.mark.parametrize("shape,match", [((2, 129, 2), "at most 128"), ((2, 16, 4), "D in"),
                                         ((2, 16, 1), "D in")])
def test_kernel_shape_check_names_what_it_does_not_take(shape, match):
    with pytest.raises(ValueError, match=match):
        port_dtw._check_kernel_shapes(torch.zeros(shape))
