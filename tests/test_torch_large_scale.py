"""The PyTorch port's scale metrics (``metrics/large_scale.py``) against the
JAX package's, on the CPU.

Inputs come from numpy seeds. JAX's random draws cannot be reproduced in
PyTorch, so every draw (directions, pair indices, subsample indices and
permutations) is re-derived here with ``jax.random`` from the keys the JAX
function splits, and injected into the port. Tolerances: sliced W2 and
energy distance 1e-5 relative; k-NN precision and recall equal, at n = 300
with row chunk 64 so the padding path runs; the three Sinkhorn estimators
and ``evaluate_large_scale`` (FID included, on the same autoencoder
weights) 1e-4 relative (500 log-domain iterations whose float32 sums run in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test worker

from wordgesture_gan_tpu.configs import ModelConfig as JaxModelConfig
from wordgesture_gan_tpu.metrics import large_scale as jax_ls
from wordgesture_gan_tpu.models import gan as jax_gan
from wordgesture_gan_tpu_torch.interop.from_jax import autoencoder_from_jax
from wordgesture_gan_tpu_torch.metrics import large_scale as ls
from wordgesture_gan_tpu_torch.ops.stats import knn_precision_recall
from wordgesture_gan_tpu_torch.utils import prng

SEQ = 32


def gestures(seed: int, n: int, seq: int = SEQ, drift: float = 0.0) -> np.ndarray:
    """Gesture-like arrays: a clipped walk in (x, y), an increasing clock."""
    rng = np.random.default_rng(seed)
    xy = np.clip(np.cumsum(rng.normal(drift, 0.08, (n, seq, 2)), axis=1), -1.0, 1.0)
    t = np.cumsum(rng.uniform(0.2, 1.0, (n, seq)), axis=1)
    t = (t - t[:, :1]) / (t[:, -1:] - t[:, :1])
    return np.concatenate([xy, t[..., None]], axis=-1).astype(np.float32)


def flat(g: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(g[:, :, :2].reshape(len(g), -1))


def rel(got, want) -> float:
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


# -- the draws, re-derived from JAX's keys ----------------------------------------------------


def energy_draws(key, n: int, m: int, n_pairs: int):
    """``energy_distance``'s pairs: k1 for i over a, k2 for j over b, k3 and
    k4 for the within-set offsets."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    i = np.array(jax.random.randint(k1, (n_pairs,), 0, n))
    j = np.array(jax.random.randint(k2, (n_pairs,), 0, m))
    i2 = (i + np.array(jax.random.randint(k3, (n_pairs,), 1, n))) % n
    j2 = (j + np.array(jax.random.randint(k4, (n_pairs,), 1, m))) % m
    return (i, j), (i, i2), (j, j2)


def choice_draws(key, n_real: int, n_fake: int, n: int):
    """``sinkhorn_matched_cost_subsampled``'s indices."""
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.choice(k1, n_real, (n,), replace=False)),
            np.array(jax.random.choice(k2, n_fake, (n,), replace=False)))


def repeated_draws(key, n_real: int, n_fake: int, n: int, n_repeats: int):
    return [choice_draws(k, n_real, n_fake, n) for k in jax.random.split(key, n_repeats)]


def extrapolated_draws(key, n_real: int, n_fake: int, n_sub: int, n_repeats: int):
    """Nested draws: one permutation per set and repeat, cut to n_sub."""
    out = []
    for k in jax.random.split(key, n_repeats):
        k1, k2 = jax.random.split(k)
        out.append((np.array(jax.random.permutation(k1, n_real))[:n_sub],
                    np.array(jax.random.permutation(k2, n_fake))[:n_sub]))
    return out


@pytest.fixture(scope="module")
def sets():
    real = flat(gestures(0, 300))
    fake = flat(gestures(1, 280, drift=0.01))
    return real, fake


# -- sliced W2, energy distance ---------------------------------------------------------------


def test_sliced_w2_matches_jax(sets):
    real, fake = sets[0][:280], sets[1]
    key = jax.random.PRNGKey(3)
    want = jax_ls.sliced_wasserstein2(jnp.asarray(real), jnp.asarray(fake), 64, key)
    dirs = np.array(jax.random.normal(key, (real.shape[1], 64)))
    got = ls.sliced_wasserstein2(torch.from_numpy(real), torch.from_numpy(fake), 64, dirs=dirs)
    assert rel(got, want) <= 1e-5


def test_energy_distance_matches_jax(sets):
    real, fake = sets
    key = jax.random.PRNGKey(4)
    want = jax_ls.energy_distance(jnp.asarray(real), jnp.asarray(fake), 1 << 16, key)
    pairs = energy_draws(key, len(real), len(fake), 1 << 16)
    got = ls.energy_distance(torch.from_numpy(real), torch.from_numpy(fake), 1 << 16,
                             pairs=pairs)
    assert rel(got, want) <= 1e-5


def test_energy_pairs_share_rows_and_never_repeat_one():
    """The port's own draws have JAX's structure: the within-set terms reuse
    the cross term's first draws and never pair a row with itself."""
    (i, j), (i_a, i2), (j_b, j2) = ls.energy_pairs(7, 5, 4096, prng.PRNGKey(0), "cpu")
    assert torch.equal(i, i_a) and torch.equal(j, j_b)
    assert not (i == i2).any() and not (j == j2).any()
    assert int(i.max()) == 6 and int(j.max()) == 4 and int(i2.min()) == 0


def test_default_draws_are_seeded_and_distinct(sets):
    real, fake = (torch.from_numpy(x) for x in sets)
    runs = [ls.sliced_wasserstein2(real[:280], fake, 16, prng.PRNGKey(s))
            for s in (0, 0, 1)]
    assert runs[0] == runs[1] and runs[0] != runs[2]
    assert (ls.energy_distance(real, fake, 1 << 10) == ls.energy_distance(real, fake, 1 << 10))


# -- chunked k-NN -------------------------------------------------------------------------------


def test_chunked_knn_precision_recall_equals_jax(sets):
    """n = 300 and 280 with row chunk 64: both sets padded (to 320)."""
    real, fake = sets
    want = jax_ls.chunked_knn_precision_recall(real, fake, k=3, row_chunk=64)
    got = ls.chunked_knn_precision_recall(real, fake, k=3, row_chunk=64, device="cpu")
    assert got == want
    # The streamed estimator is the exact n x m one.
    p, r, _, _ = knn_precision_recall(torch.from_numpy(real), torch.from_numpy(fake), 3)
    assert got == pytest.approx((float(p), float(r)), abs=1e-7)


def test_duplicated_reals_collapse_their_radii_like_jax():
    """``eval_cli --large-scale`` draws N real rows with replacement from a
    smaller test split, so real rows have copies: a row with 3 or more (the
    4th smallest distance, self included, is to a copy) has a radius of ~0
    and covers no fake. Both packages give the same precision and recall on
    such a set (here 300 rows of 40 distinct gestures, ~7 copies each)."""
    rng = np.random.default_rng(8)
    real = flat(gestures(2, 40))[rng.integers(0, 40, 300)]
    fake = flat(gestures(3, 300, drift=0.01))
    want = jax_ls.chunked_knn_precision_recall(real, fake, k=3, row_chunk=64)
    got = ls.chunked_knn_precision_recall(real, fake, k=3, row_chunk=64, device="cpu")
    assert got == want and got[0] < 0.05


def test_knn_radii_padding_semantics(sets):
    """Padded rows get radius -1e30; padded columns never count; a radius is
    the (k+1)-th smallest distance, self included."""
    real = sets[0][:100]
    padded = np.concatenate([real, np.zeros((28, real.shape[1]), np.float32)])
    want = np.asarray(jax_ls._knn_radii_scanned(jnp.asarray(padded), jnp.int32(100), 3, 32))
    got = ls._knn_radii_scanned(torch.from_numpy(padded), 100, 3, 32).numpy()
    np.testing.assert_allclose(got[:100], want[:100], rtol=1e-5)
    assert (got[100:] == -1e30).all() and (want[100:] == -1e30).all()
    d = np.sqrt(((real[:, None] - real[None]) ** 2).sum(-1))
    np.testing.assert_allclose(got[:100], np.sort(d, axis=1)[:, 3], rtol=1e-4, atol=1e-5)


# -- Sinkhorn -------------------------------------------------------------------------------------


def test_sinkhorn_subsampled_matches_jax(sets):
    real, fake = sets
    key = jax.random.PRNGKey(5)
    want = jax_ls.sinkhorn_matched_cost_subsampled(jnp.asarray(real), jnp.asarray(fake), 96,
                                                   key=key)
    got = ls.sinkhorn_matched_cost_subsampled(torch.from_numpy(real), torch.from_numpy(fake), 96,
                                              indices=choice_draws(key, 300, 280, 96))
    assert rel(got, want) <= 1e-4


def test_sinkhorn_repeated_matches_jax(sets):
    real, fake = sets
    key = jax.random.PRNGKey(6)
    want = jax_ls.sinkhorn_matched_cost_repeated(jnp.asarray(real), jnp.asarray(fake), 64,
                                                 key=key, n_repeats=2)
    got = ls.sinkhorn_matched_cost_repeated(torch.from_numpy(real), torch.from_numpy(fake), 64,
                                            n_repeats=2,
                                            draws=repeated_draws(key, 300, 280, 64, 2))
    assert rel(got[0], want[0]) <= 1e-4 and rel(got[1], want[1]) <= 1e-2
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4)
    with pytest.raises(ValueError, match="draws"):
        ls.sinkhorn_matched_cost_repeated(torch.from_numpy(real), torch.from_numpy(fake), 64,
                                          n_repeats=3, draws=repeated_draws(key, 300, 280, 64, 2))


@pytest.mark.parametrize("n_sub", [64, 512])
def test_sinkhorn_extrapolated_matches_jax(sets, n_sub):
    """n_sub 64 of 280: nested draws and the log2 extrapolation; n_sub 512
    covers the population (a 100-row subset): the repeated estimator, no
    correction."""
    real, fake = sets
    if n_sub >= 280:
        real, fake = real[:110], fake[:100]
    key = jax.random.PRNGKey(7)
    want = jax_ls.sinkhorn_matched_cost_extrapolated(jnp.asarray(real), jnp.asarray(fake), n_sub,
                                                     key=key, n_repeats=3)
    if n_sub < 280:
        draws = extrapolated_draws(key, len(real), len(fake), n_sub, 3)
    else:
        draws = repeated_draws(key, len(real), len(fake), len(fake), 3)
    got = ls.sinkhorn_matched_cost_extrapolated(torch.from_numpy(real), torch.from_numpy(fake),
                                                n_sub, n_repeats=3, draws=draws)
    assert set(got) == set(want)
    for k in ("estimate", "raw_mean"):
        assert rel(got[k], want[k]) <= 1e-4
    for k in ("stderr", "raw_std", "slope"):       # differences of near-equal costs
        assert abs(got[k] - want[k]) <= 1e-4 * max(abs(want["raw_mean"]), 1.0)
    assert (got["slope"] == 0.0) == (n_sub >= len(fake))


# -- evaluate_large_scale -------------------------------------------------------------------------


def test_evaluate_large_scale_matches_jax():
    """n = 128 (< 4096: the Sinkhorn repeats cover the population), default
    projections and 2^20 energy pairs, FID on one autoencoder's weights."""
    n, seed = 128, 3
    real, fake = gestures(10, n), gestures(11, n + 20, drift=0.01)
    jae = jax.device_get(jax_gan.autoencoder_init(jax.random.PRNGKey(2), JaxModelConfig(), 32,
                                                  positional=True))
    want = jax_ls.evaluate_large_scale(real, fake, ae_params=jae, seed=seed)

    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    draws = {"dirs": np.array(jax.random.normal(k1, (2 * SEQ, 256))),
             "pairs": energy_draws(k2, n, n, 1 << 20),
             "sinkhorn": repeated_draws(k3, n, n, n, 6)}
    stages = {}
    got = ls.evaluate_large_scale(real, fake, ae_params=autoencoder_from_jax(jae), seed=seed,
                                  device="cpu", draws=draws, stage_seconds=stages)
    assert list(got) == list(want)
    assert got["n_samples"] == want["n_samples"] == n
    assert (got["precision"], got["recall"]) == (want["precision"], want["recall"])
    for k in ("sliced_w2", "energy_distance"):
        assert rel(got[k], want[k]) <= 1e-5, k
    for k in ("sinkhorn_matched_cost", "sinkhorn_matched_cost_extrapolated", "fid"):
        assert rel(got[k], want[k]) <= 1e-4, k
    assert got["sinkhorn_matched_cost"] == got["sinkhorn_matched_cost_extrapolated"]
    for k in ("sinkhorn_matched_cost_std", "sinkhorn_matched_cost_extrapolated_stderr"):
        assert abs(got[k] - want[k]) <= 1e-4 * want["sinkhorn_matched_cost"], k
    assert set(stages) == {"sinkhorn", "sliced_w2_energy", "knn", "fid"}


def test_evaluate_large_scale_at_a_seed_draws_jaxs_numbers():
    """With no injected draws, ``seed=3`` draws the JAX package's
    directions, energy pairs and Sinkhorn subsamples: the metrics match
    JAX's within the injected-draw test's tolerances above."""
    n, seed = 128, 3
    real, fake = gestures(10, n), gestures(11, n + 20, drift=0.01)
    want = jax_ls.evaluate_large_scale(real, fake, seed=seed)
    got = ls.evaluate_large_scale(real, fake, seed=seed, device="cpu")
    assert (got["precision"], got["recall"]) == (want["precision"], want["recall"])
    for k in ("sliced_w2", "energy_distance"):
        assert rel(got[k], want[k]) <= 1e-5, k
    for k in ("sinkhorn_matched_cost", "sinkhorn_matched_cost_extrapolated"):
        assert rel(got[k], want[k]) <= 1e-4, k


def test_evaluate_large_scale_own_draws_extrapolate():
    """Without injected draws, past the subsample size: the extrapolated
    estimate sits below the raw subsample mean."""
    real, fake = gestures(12, 300), gestures(13, 300, drift=0.01)
    r = ls.evaluate_large_scale(real, fake, seed=1, device="cpu", sinkhorn_n_sub=64,
                                sinkhorn_repeats=2)
    assert "fid" not in r
    assert all(np.isfinite(v) for v in r.values())
    assert r["sinkhorn_matched_cost_extrapolated"] < r["sinkhorn_matched_cost"]
    assert 0.0 <= r["precision"] <= 1.0 and 0.0 <= r["recall"] <= 1.0
