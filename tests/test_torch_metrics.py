"""The PyTorch port's metric suite against the JAX package, on the CPU.

Inputs come from numpy seeds and go through both packages; autoencoder
weights move with ``autoencoder_from_jax`` and the FID autoencoder's
permutations are computed with ``jax.random`` and injected. Tolerances:
elementwise dynamics 1e-5 relative to each array's largest value (same
arithmetic, float32); correlations, jerk means and distances 1e-4 (sums in
another order); percentile clipping 1e-5 (both interpolate between the same
two order statistics, with float32 weights rounded differently); the trained
autoencoder after 2 epochs 2e-4 per parameter (Adam divides by
sqrt(v) + 1e-8, which amplifies float32 rounding of small gradients); FID
from the same features 1e-9 (float64 numpy in both).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch
from scipy.optimize import linear_sum_assignment
import torch_threads  # noqa: F401  one torch thread per test worker

from wordgesture_gan_tpu.configs import EvaluationConfig as JaxEvaluationConfig
from wordgesture_gan_tpu.configs import ModelConfig as JaxModelConfig
from wordgesture_gan_tpu.metrics import fid as jax_fid
from wordgesture_gan_tpu.metrics.suite import evaluate_all_metrics as jax_evaluate_all_metrics
from wordgesture_gan_tpu.models import gan as jax_gan
from wordgesture_gan_tpu.ops import assignment as jax_assignment
from wordgesture_gan_tpu.ops import savgol as jax_savgol
from wordgesture_gan_tpu.ops import sqrtm as jax_sqrtm
from wordgesture_gan_tpu.ops import stats as jax_stats
from wordgesture_gan_tpu_torch.configs import EvaluationConfig, ModelConfig
from wordgesture_gan_tpu_torch.interop.from_jax import autoencoder_from_jax, flatten_tree
from wordgesture_gan_tpu_torch.metrics import fid
from wordgesture_gan_tpu_torch.metrics.suite import evaluate_all_metrics
from wordgesture_gan_tpu_torch.models import gan
from wordgesture_gan_tpu_torch.ops import assignment, savgol, sqrtm, stats
from wordgesture_gan_tpu_torch.utils.tree import tree_leaves
from wordgesture_gan_tpu_torch.utils import prng

SCALARS = ("l2_wasserstein", "dtw_wasserstein", "jerk_real", "jerk_fake", "velocity_corr",
           "acceleration_corr", "speed_profile_corr", "time_delta_corr", "ae_reconstruction_loss",
           "ae_test_loss", "fid", "fid_paper", "fid_positional", "precision", "recall")


def gestures(seed: int, n: int, seq: int = 32) -> np.ndarray:
    """Gesture-like arrays: a clipped walk in (x, y), an increasing clock."""
    rng = np.random.default_rng(seed)
    xy = np.clip(np.cumsum(rng.normal(0.0, 0.08, (n, seq, 2)), axis=1), -1.0, 1.0)
    t = np.cumsum(rng.uniform(0.2, 1.0, (n, seq)), axis=1)
    t = (t - t[:, :1]) / (t[:, -1:] - t[:, :1])
    return np.concatenate([xy, t[..., None]], axis=-1).astype(np.float32)


def degenerate(seed: int, n: int, seq: int = 32) -> np.ndarray:
    """As ``gestures``, with a constant gesture, a gesture whose clock stands
    still for a stretch, and one whose clock never moves."""
    g = gestures(seed, n, seq)
    g[0] = g[0, 0]                      # one point, repeated: zero variance everywhere
    g[1, 5:12, 2] = g[1, 5, 2]          # zero dt over a stretch
    g[2, :, 2] = 0.5                    # zero dt throughout
    return g


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def close(got, want, tol, scale_to_max=False):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30) if scale_to_max else 1.0
    with np.errstate(invalid="ignore"):      # an overflowed jerk is inf in both
        np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


# -- ops/stats.py ---------------------------------------------------------------------------


@pytest.mark.parametrize("make", [gestures, degenerate])
def test_velocity_acceleration_jerk(make):
    g = make(0, 12)
    v, tm = stats.time_aware_velocity(t_(g))
    jv, jtm = jax_stats.time_aware_velocity(jnp.asarray(g))
    close(v, jv, 1e-5, scale_to_max=True)
    close(tm, jtm, 1e-6)
    close(stats.time_aware_acceleration(t_(g)), jax_stats.time_aware_acceleration(jnp.asarray(g)),
          1e-5, scale_to_max=True)
    close(stats.time_aware_jerk(t_(g)), jax_stats.time_aware_jerk(jnp.asarray(g)), 1e-5,
          scale_to_max=True)


@pytest.mark.parametrize("name", ["velocity_correlation", "acceleration_correlation",
                                  "speed_profile_correlation", "time_delta_correlation"])
@pytest.mark.parametrize("make", [gestures, degenerate])
def test_correlations(name, make):
    real, fake = make(1, 16), gestures(2, 16)
    got = getattr(stats, name)(t_(real), t_(fake))
    want = getattr(jax_stats, name)(jnp.asarray(real), jnp.asarray(fake))
    assert np.isfinite(float(got))
    close(got, want, 1e-4)


def test_correlation_of_all_invalid_pairs_is_zero():
    const = np.zeros((4, 16, 3), np.float32)
    assert float(stats.velocity_correlation(t_(const), t_(const))) == 0.0
    assert float(jax_stats.velocity_correlation(jnp.asarray(const), jnp.asarray(const))) == 0.0


@pytest.mark.parametrize("lo,hi", [(1, 99), (None, 99)])
def test_percentile_clipping(lo, hi):
    x = np.random.default_rng(3).normal(size=(6, 61)).astype(np.float32)
    close(stats._clip_rows_percentile(t_(x), lo, hi),
          jax_stats._clip_rows_percentile(jnp.asarray(x), lo, hi), 1e-5)


def test_std_is_the_population_one():
    x = np.random.default_rng(4).normal(size=(3, 9)).astype(np.float32)
    close(stats._std(t_(x)), x.std(axis=1), 1e-6)


def test_pairwise_l2_and_knn_precision_recall():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(20, 12)).astype(np.float32)
    b = (rng.normal(size=(20, 12)) * 1.3 + 0.4).astype(np.float32)
    close(stats.pairwise_l2(t_(a), t_(b)), jax_stats.pairwise_l2(jnp.asarray(a), jnp.asarray(b)),
          1e-5)
    got = stats.knn_precision_recall(t_(a), t_(b), 3)
    want = jax_stats.knn_precision_recall(jnp.asarray(a), jnp.asarray(b), 3)
    assert float(got[0]) == pytest.approx(float(want[0]), abs=1e-6)
    assert float(got[1]) == pytest.approx(float(want[1]), abs=1e-6)
    # A self-distance is the square root of what a² + a² − 2a·a leaves of
    # float32 rounding (up to ~2e-3 at these norms) in both packages.
    off_diagonal = ~np.eye(20, dtype=bool)
    close(got[2].numpy()[off_diagonal], np.asarray(want[2])[off_diagonal], 1e-5)
    assert got[2].diagonal().abs().max() < 5e-3 and np.abs(np.diag(want[2])).max() < 5e-3
    close(got[3], want[3], 1e-5)
    # The cached real side and a precomputed cross matrix give the same answer.
    again = stats.knn_precision_recall(t_(a), t_(b), 3, real_dists=got[2], real_radii=got[3],
                                       cross=stats.pairwise_l2(t_(a), t_(b)))
    assert float(again[0]) == float(got[0]) and float(again[1]) == float(got[1])


# -- ops/savgol.py, ops/sqrtm.py, ops/assignment.py ------------------------------------------


def test_savgol_matrix_is_the_jax_package_s():
    np.testing.assert_array_equal(savgol.savgol_matrix(32, 21, 3, 3),
                                  jax_savgol.savgol_matrix(32, 21, 3, 3))
    with pytest.raises(ValueError):
        savgol.savgol_matrix(16, 21, 3, 3)


def test_batched_savgol_jerk_matches_scipy_and_jax():
    g = gestures(6, 5, seq=64)
    got = savgol.batched_savgol_jerk(t_(g), 21, 3).numpy()
    d3 = scipy.signal.savgol_filter(g[:, :, :2].astype(np.float64), 21, 3, deriv=3, axis=1)
    want = np.sqrt((d3 ** 2).sum(-1)).mean(axis=1)
    close(got, want, 1e-4, scale_to_max=True)
    close(got, jax_savgol.batched_savgol_jerk(jnp.asarray(g), 21, 3), 1e-4, scale_to_max=True)


def test_frechet_distance_tensor_variant():
    rng = np.random.default_rng(7)
    a, b = rng.normal(size=(50, 6)), rng.normal(size=(50, 6)) * 1.2 + 0.1
    mu_a, mu_b = a.mean(0).astype(np.float32), b.mean(0).astype(np.float32)
    cov_a, cov_b = np.cov(a, rowvar=False).astype(np.float32), np.cov(b, rowvar=False).astype(np.float32)
    got = sqrtm.frechet_distance(t_(mu_a), t_(cov_a), t_(mu_b), t_(cov_b))
    want = jax_sqrtm.frechet_distance(jnp.asarray(mu_a), jnp.asarray(cov_a), jnp.asarray(mu_b),
                                      jnp.asarray(cov_b))
    close(got, want, 1e-4)
    close(sqrtm.psd_sqrt(t_(cov_a)) @ sqrtm.psd_sqrt(t_(cov_a)), cov_a, 1e-5)


def test_assignment():
    rng = np.random.default_rng(8)
    cost = rng.uniform(0.0, 1.0, (24, 24)).astype(np.float32)
    rows, cols = linear_sum_assignment(cost)
    r, c = assignment.hungarian_matching(cost)
    np.testing.assert_array_equal(c, cols)
    assert assignment.matched_mean_distance(cost) == jax_assignment.matched_mean_distance(cost)
    got = float(assignment.sinkhorn_matching_cost(t_(cost), epsilon=0.02, n_iters=200))
    want = float(jax_assignment.sinkhorn_matching_cost(jnp.asarray(cost), epsilon=0.02,
                                                       n_iters=200))
    assert got == pytest.approx(want, rel=1e-4)
    assert got >= cost[rows, cols].mean() - 1e-6        # approaches the exact cost from above


# -- FID autoencoder -------------------------------------------------------------------------


@pytest.mark.parametrize("positional", [False, True])
def test_autoencoder_encode_decode_apply(positional):
    jp = jax_gan.autoencoder_init(jax.random.PRNGKey(0), JaxModelConfig(), 32,
                                  positional=positional)
    tp = autoencoder_from_jax(jax.device_get(jp))
    own = gan.autoencoder_init(ModelConfig(), 32, positional, prng.PRNGKey(0))
    assert ({k: v.shape for k, v in flatten_tree(own).items()}
            == {k: v.shape for k, v in flatten_tree(tp).items()})
    g = gestures(9, 6)
    z = gan.autoencoder_encode(tp, t_(g))
    jz = jax_gan.autoencoder_encode(jp, jnp.asarray(g))
    close(z, jz, 1e-5)
    close(gan.autoencoder_decode(tp, z, 32), jax_gan.autoencoder_decode(jp, jz, 32), 1e-5)
    close(gan.autoencoder_apply(tp, t_(g)), jax_gan.autoencoder_apply(jp, jnp.asarray(g)), 1e-5)


def _jax_fid_run(data: np.ndarray, ecfg, seed: int = 0):
    """The JAX trainer's result, with the initial parameters and the
    permutations it draws from its own keys."""
    key, init_key = jax.random.split(jax.random.PRNGKey(seed))
    init = jax_gan.autoencoder_init(init_key, JaxModelConfig(), ecfg.fid_hidden_dim,
                                    positional=ecfg.fid_feature_mode == "positional")
    perms = np.stack([np.asarray(jax.random.permutation(k, len(data)))
                      for k in jax.random.split(key, ecfg.fid_autoencoder_epochs)])
    params, loss = jax_fid.train_fid_autoencoder(data, JaxModelConfig(), ecfg, seed=seed,
                                                 batch_size=16, verbose=False)
    return jax.device_get(init), perms, jax.device_get(params), loss


@pytest.mark.parametrize("mode", ["positional", "paper"])
def test_fid_autoencoder_training_matches_jax_with_injected_permutations(mode, capsys):
    data = gestures(10, 40)                              # 40 = 2 full batches + a tail of 8
    init, perms, want, want_loss = _jax_fid_run(
        data, JaxEvaluationConfig(fid_autoencoder_epochs=2, fid_feature_mode=mode))
    got, loss = fid.train_fid_autoencoder(
        data, ModelConfig(), EvaluationConfig(fid_autoencoder_epochs=2, fid_feature_mode=mode),
        batch_size=16, verbose=False, device="cpu", perms=perms,
        params=autoencoder_from_jax(init))
    assert loss == pytest.approx(want_loss, rel=1e-5)
    for a, b in zip(tree_leaves(got), tree_leaves(autoencoder_from_jax(want))):
        assert not a.requires_grad
        close(a, b, 2e-4)
    with pytest.raises(ValueError, match="perms"):
        fid.train_fid_autoencoder(data, eval_config=EvaluationConfig(fid_autoencoder_epochs=2),
                                  device="cpu", perms=perms[:1])


def test_fid_autoencoder_at_a_seed_draws_jaxs_init_and_permutations():
    """With no injected draws, ``seed=0`` gives the JAX package's initial
    weights and epoch permutations: the trained weights and the loss match
    JAX's within the injected-draw test's tolerances."""
    data = gestures(10, 40)
    ecfg = dict(fid_autoencoder_epochs=2, fid_feature_mode="positional")
    _, _, want, want_loss = _jax_fid_run(data, JaxEvaluationConfig(**ecfg))
    got, loss = fid.train_fid_autoencoder(data, ModelConfig(), EvaluationConfig(**ecfg), seed=0,
                                          batch_size=16, verbose=False, device="cpu")
    assert loss == pytest.approx(want_loss, rel=1e-5)
    got = jax.tree.map(lambda t: t.numpy(), got)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):     # both in key order
        close(a, b, 2e-4)


def test_fid_autoencoder_own_seed_is_reproducible_and_cached(tmp_path):
    data = gestures(11, 24)
    ecfg = EvaluationConfig(fid_autoencoder_epochs=1)
    a, loss_a = fid.train_fid_autoencoder(data, eval_config=ecfg, verbose=False, device="cpu")
    b, loss_b = fid.load_or_train_fid_autoencoder(data, eval_config=ecfg, verbose=False,
                                                  cache_dir=str(tmp_path), device="cpu")
    cached = list(tmp_path.glob(".cache_fid_ae_*.pt"))
    assert len(cached) == 1 and loss_a == loss_b
    # Same key as the JAX package's cache, another suffix (another file format).
    jax_path = jax_fid._ae_cache_path(data, JaxEvaluationConfig(fid_autoencoder_epochs=1),
                                      str(tmp_path))
    assert cached[0].stem == jax_path.stem and jax_path.suffix == ".pkl"
    c, loss_c = fid.load_or_train_fid_autoencoder(data, eval_config=ecfg, verbose=False,
                                                  cache_dir=str(tmp_path), device="cpu")
    assert loss_c == loss_a
    for x, y, z in zip(tree_leaves(a), tree_leaves(b), tree_leaves(c)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
        torch.testing.assert_close(x, z, rtol=0, atol=0)


def test_fid_from_features_and_encode_features():
    rng = np.random.default_rng(12)
    a, b = rng.normal(size=(60, 8)).astype(np.float32), rng.normal(size=(60, 8)).astype(np.float32) + 0.3
    assert fid.fid_from_features(a, b) == pytest.approx(jax_fid.fid_from_features(a, b), rel=1e-9)
    assert fid.fid_from_features(a, a) == pytest.approx(0.0, abs=1e-9)
    jp = jax_gan.autoencoder_init(jax.random.PRNGKey(1), JaxModelConfig(), 32, positional=True)
    tp = autoencoder_from_jax(jax.device_get(jp))
    g = gestures(13, 37)
    got = fid.encode_features(tp, g, batch=16)          # 3 chunks, the last one padded
    assert got.shape == (37, 32) and got.dtype == np.float32
    close(got, jax_fid.encode_features(jp, g, batch=16), 1e-5)
    assert fid.encode_features(tp, g[:0]).shape == (0, 32)


# -- the suite as a whole --------------------------------------------------------------------


@pytest.fixture(scope="module")
def suite_run():
    """The JAX suite once (2 FID epochs), and the port's on the same arrays
    with the JAX-trained autoencoders carried across through ``cached_real``."""
    real, fake, train = gestures(20, 24), gestures(21, 24), gestures(22, 48)
    jcfg = JaxEvaluationConfig(fid_autoencoder_epochs=2)
    want = jax_evaluate_all_metrics(real, fake, train, JaxModelConfig(), jcfg, verbose=False)
    jcache = want.pop("_cached_real")
    ae, ae_alt = (autoencoder_from_jax(jax.device_get(jcache[k]))
                  for k in ("ae_params", "ae_params_alt"))
    cache = {"real_flat_xy": t_(real[:, :, :2].reshape(24, -1)),
             "ae_params": ae, "real_features": fid.encode_features(ae, real),
             "ae_loss": jcache["ae_loss"],
             "ae_params_alt": ae_alt, "real_features_alt": fid.encode_features(ae_alt, real)}
    got = evaluate_all_metrics(real, fake, train, ModelConfig(),
                               EvaluationConfig(fid_autoencoder_epochs=2), cached_real=cache,
                               verbose=False, device="cpu")
    return real, fake, train, got, want


@pytest.mark.parametrize("key", SCALARS)
def test_evaluate_all_metrics_scalar_by_scalar(suite_run, key):
    *_, got, want = suite_run
    if key.startswith("fid"):
        # Features agree to 1e-5; FID is a small difference of traces of
        # their covariances.
        assert got[key] == pytest.approx(want[key], rel=2e-3, abs=1e-7)
    else:
        assert got[key] == pytest.approx(want[key], rel=1e-4, abs=1e-6)


def test_evaluate_all_metrics_own_autoencoders_and_cached_real(suite_run, tmp_path):
    real, fake, train, _, want = suite_run
    ecfg = EvaluationConfig(fid_autoencoder_epochs=1)
    first = evaluate_all_metrics(real, fake, train, ModelConfig(), ecfg, cache_dir=str(tmp_path),
                                 verbose=False, device="cpu")
    assert len(list(tmp_path.glob(".cache_fid_ae_*.pt"))) == 2      # both feature spaces
    cache, stages = first.pop("_cached_real"), first.pop("_stage_seconds")
    assert {"hungarian", "dtw", "fid_autoencoder_training"} <= set(stages)
    for key in SCALARS[:8] + ("precision", "recall"):               # what no autoencoder enters
        assert first[key] == pytest.approx(want[key], rel=1e-4, abs=1e-6)
    assert first["fid"] >= 0 and first["fid_feature_mode"] == "positional"
    assert first["fid"] == first["fid_positional"]
    second = evaluate_all_metrics(real, fake, train, ModelConfig(), ecfg, cached_real=cache,
                                  verbose=False, device="cpu")
    assert "fid_autoencoder_training" not in second.pop("_stage_seconds")
    second.pop("_cached_real")
    assert second == first
    paper = evaluate_all_metrics(real, fake, train, ModelConfig(),
                                 dataclasses.replace(ecfg, fid_feature_mode="paper"),
                                 cache_dir=str(tmp_path), verbose=False, device="cpu")
    assert paper["fid"] == paper["fid_paper"] == first["fid_paper"]


def test_evaluate_all_metrics_skip_dtw_short_sequences_and_unequal_counts():
    real, fake = gestures(23, 10, seq=16), gestures(24, 7, seq=16)
    out = evaluate_all_metrics(real, fake, None, ModelConfig(),
                               EvaluationConfig(fid_autoencoder_epochs=1), skip_dtw=True,
                               verbose=False, device="cpu")
    assert out["dtw_wasserstein"] == -1.0
    assert out["jerk_real"] == out["jerk_fake"] == 0.0              # shorter than the window
    assert out["_cached_real"]["real_flat_xy"].shape == (7, 32)     # cut to the smaller set
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if torch.cuda.is_available():
            raise RuntimeError("no CUDA device")                    # nothing to refuse here
        evaluate_all_metrics(real, fake, device="cuda")
