"""The full evaluation metric suite (the port of the JAX package's
``metrics/suite.py``), every heavy computation batched on one device:

  * L2 Wasserstein: pairwise distances as one matrix product + Hungarian
    assignment on the host;
  * DTW Wasserstein: exact batched DTW (``ops/dtw.py``, the CUDA kernel on a
    card), same √L normalization as the reference implementation;
  * savgol jerk: one precomputed (L, L) linear map per batch;
  * time-aware velocity/acceleration/speed/time-delta correlations;
  * FID: autoencoder features trained on the device + Fréchet distance in
    float64 on the host, in both feature spaces;
  * k-NN precision/recall.

Real-side computations are returned under ``_cached_real`` for reuse by a
second model evaluation (GAN, then minimum jerk). Everything runs in float32
with TF32 off.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..configs import (DEFAULT_EVALUATION_CONFIG, DEFAULT_MODEL_CONFIG, EvaluationConfig,
                       ModelConfig)
from ..models.gan import autoencoder_apply
from ..models.layers import jax_products
from ..ops.assignment import matched_mean_distance
from ..ops.dtw import dtw_distance_matrix
from ..ops.savgol import batched_savgol_jerk
from ..ops.stats import (acceleration_correlation, knn_precision_recall, pairwise_l2,
                         speed_profile_correlation, time_delta_correlation,
                         velocity_correlation)
from .fid import encode_features, fid_from_features, load_or_train_fid_autoencoder


class _Stages:
    """Host seconds by stage. Every stage ends with a value on the host, so
    the clock needs no extra synchronisation."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0


def evaluate_all_metrics(
    real_gestures: np.ndarray,
    fake_gestures: np.ndarray,
    train_gestures: Optional[np.ndarray] = None,
    model_config: ModelConfig = DEFAULT_MODEL_CONFIG,
    eval_config: EvaluationConfig = DEFAULT_EVALUATION_CONFIG,
    skip_dtw: bool = False,
    cached_real: Optional[Dict] = None,
    cache_dir: Optional[str] = None,
    verbose: bool = True,
    device="cuda",
) -> Dict[str, float]:
    """Run the paper's metric suite on (n, L, 3) real/fake gesture arrays on
    ``device``.

    Returns a dict of scalars plus ``_cached_real``, the reusable real-side
    intermediates (flattened xy, self-distances, radii, the trained FID
    autoencoders and their real features), and ``_stage_seconds``, the host
    seconds each stage took.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available; pass device='cpu' "
                           "to evaluate on the CPU")
    with jax_products():
        return _evaluate(real_gestures, fake_gestures, train_gestures, model_config,
                         eval_config, skip_dtw, cached_real, cache_dir, verbose, device)


@torch.no_grad()
def _evaluate(real_gestures, fake_gestures, train_gestures, model_config, eval_config, skip_dtw,
              cached_real, cache_dir, verbose, device) -> Dict[str, float]:
    # Matched sample counts: the reference always evaluates equal-size sets.
    # L comes from the arrays, not the model config — callers may evaluate
    # at a different resampling length.
    n = min(len(real_gestures), len(fake_gestures))
    if len(real_gestures) != len(fake_gestures):
        real_gestures = real_gestures[:n]
        fake_gestures = fake_gestures[:n]
    L = real_gestures.shape[1]
    results: Dict[str, float] = {}
    stage = _Stages()

    real_d = torch.as_tensor(np.asarray(real_gestures, np.float32), device=device)
    fake_d = torch.as_tensor(np.asarray(fake_gestures, np.float32), device=device)

    if cached_real:
        real_flat_xy = cached_real["real_flat_xy"]
    else:
        real_flat_xy = real_d[:, :, :2].reshape(n, -1)
    fake_flat_xy = fake_d[:, :, :2].reshape(n, -1)

    # --- L2 Wasserstein: pairwise distances on the device, Hungarian on the host
    with stage("l2_distances"):
        cross_xy = pairwise_l2(real_flat_xy, fake_flat_xy)
        cross_host = cross_xy.cpu().numpy()
    with stage("hungarian"):
        results["l2_wasserstein"] = matched_mean_distance(cross_host)

    # --- DTW Wasserstein
    if skip_dtw:
        results["dtw_wasserstein"] = -1.0
    else:
        with stage("dtw"):
            dtw_mat = dtw_distance_matrix(real_gestures[:, :, :2], fake_gestures[:, :, :2],
                                          device=device)
        with stage("hungarian"):
            results["dtw_wasserstein"] = matched_mean_distance(dtw_mat) / np.sqrt(L)

    with stage("dynamics"):
        # --- savgol jerk
        if L >= eval_config.savgol_window:
            window, order = eval_config.savgol_window, eval_config.savgol_poly_order
            results["jerk_real"] = float(batched_savgol_jerk(real_d, window, order).mean())
            results["jerk_fake"] = float(batched_savgol_jerk(fake_d, window, order).mean())
        else:
            results["jerk_real"] = results["jerk_fake"] = 0.0

        # --- time-aware dynamics correlations
        results["velocity_corr"] = float(velocity_correlation(real_d, fake_d))
        results["acceleration_corr"] = float(acceleration_correlation(real_d, fake_d))
        results["speed_profile_corr"] = float(speed_profile_correlation(real_d, fake_d))
        results["time_delta_corr"] = float(time_delta_correlation(real_d, fake_d))

    # --- FID
    train_data = np.asarray(train_gestures if train_gestures is not None else real_gestures,
                            np.float32)
    if cached_real and "ae_params" in cached_real:
        ae_params = cached_real["ae_params"]
        real_features = cached_real["real_features"]
        final_loss = cached_real["ae_loss"]
    else:
        with stage("fid_autoencoder_training"):
            with torch.enable_grad():
                ae_params, final_loss = load_or_train_fid_autoencoder(
                    train_data, model_config, eval_config, cache_dir=cache_dir,
                    verbose=verbose, device=device)
        with stage("fid_features"):
            real_features = encode_features(ae_params, real_gestures)
    results["ae_reconstruction_loss"] = final_loss

    with stage("fid_features"):
        fake_features = encode_features(ae_params, fake_gestures)
        results["ae_test_loss"] = float((autoencoder_apply(ae_params, real_d) - real_d)
                                        .abs().mean())
        results["fid"] = fid_from_features(real_features, fake_features)
    # Feature-space provenance travels with the number: 'positional' FIDs are
    # not comparable to the paper's ('paper'-mode) values.
    mode = eval_config.fid_feature_mode
    results["fid_feature_mode"] = mode

    # FID in both feature spaces: the configured mode above plus the other
    # one, so one evaluation shows the paper-space number next to the paper
    # column and the shape-aware positional number next to it.
    other_mode = "paper" if mode == "positional" else "positional"
    if cached_real and "ae_params_alt" in cached_real:
        ae_params_alt = cached_real["ae_params_alt"]
        real_features_alt = cached_real["real_features_alt"]
    else:
        with stage("fid_autoencoder_training"):
            with torch.enable_grad():
                ae_params_alt, _ = load_or_train_fid_autoencoder(
                    train_data, model_config,
                    dataclasses.replace(eval_config, fid_feature_mode=other_mode),
                    cache_dir=cache_dir, verbose=verbose, device=device)
        with stage("fid_features"):
            real_features_alt = encode_features(ae_params_alt, real_gestures)
    with stage("fid_features"):
        fake_features_alt = encode_features(ae_params_alt, fake_gestures)
        results[f"fid_{mode}"] = results["fid"]
        results[f"fid_{other_mode}"] = fid_from_features(real_features_alt, fake_features_alt)

    # --- k-NN precision / recall
    with stage("precision_recall"):
        precision, recall, real_dists, real_radii = knn_precision_recall(
            real_flat_xy, fake_flat_xy, eval_config.precision_recall_k,
            real_dists=cached_real.get("real_dists") if cached_real else None,
            real_radii=cached_real.get("real_radii") if cached_real else None,
            cross=cross_xy,
        )
        results["precision"] = float(precision)
        results["recall"] = float(recall)

    results["_cached_real"] = {
        "real_flat_xy": real_flat_xy,
        "real_dists": real_dists,
        "real_radii": real_radii,
        "ae_params": ae_params,
        "real_features": real_features,
        "ae_loss": final_loss,
        "ae_params_alt": ae_params_alt,
        "real_features_alt": real_features_alt,
    }
    results["_stage_seconds"] = stage.seconds
    return results
