"""GAN + minimum-jerk evaluation with paper-comparison tables (the
port of the JAX package's ``eval/gan_eval.py``): evaluate the trained
generator and/or the fitted minimum-jerk baseline on the same test samples
with shared real-side caching, then print tables against the CHI'23 Table-6
values.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..configs import (DEFAULT_EVALUATION_CONFIG, DEFAULT_MODEL_CONFIG, EvaluationConfig,
                       ModelConfig)
from ..data.pipeline import GestureArrays
from ..keyboard import MinimumJerkModel, QWERTYKeyboard
from ..metrics.suite import evaluate_all_metrics
from ..utils.logging import log

# CHI'23 Table-6 values
PAPER_GAN = {
    "l2": "4.409", "dtw": "2.146", "jerk_fake": "0.0058", "jerk_real": "0.0066",
    "vel": "0.40", "acc": "0.26", "fid": "0.270", "precision": "0.973", "recall": "0.258",
}
PAPER_MINJERK = {
    "l2": "5.004", "dtw": "2.752", "jerk_fake": "0.0034", "jerk_real": "0.0066",
    "vel": "0.40", "acc": "0.21", "fid": "0.354", "precision": "0.785", "recall": "0.575",
}


def fit_minjerk_from_dataset(train_ds: GestureArrays, keyboard: QWERTYKeyboard,
                             verbose: bool = True) -> MinimumJerkModel:
    """Group the flat train split back by word and fit the baseline."""
    by_word: Dict[str, List[np.ndarray]] = defaultdict(list)
    for gesture, word in zip(train_ds.gestures, train_ds.words):
        by_word[word].append(gesture)
    return MinimumJerkModel(keyboard).fit(dict(by_word), verbose=verbose)


def generate_minjerk_samples(
    model: MinimumJerkModel,
    words: List[str],
    seq_length: int = 128,
    seed: int = 0,
) -> np.ndarray:
    """One fitted min-jerk trajectory per test word (the reference fans this
    out over joblib processes, eval_gan.py:201-207; the vectorized numpy
    generator here is fast enough single-process)."""
    rng = np.random.default_rng(seed)
    return np.stack([
        model.generate_trajectory(w, num_points=seq_length, rng=rng) for w in words
    ])


def evaluate_gan_and_minjerk(
    real_gestures: np.ndarray,
    words: List[str],
    train_ds: GestureArrays,
    keyboard: QWERTYKeyboard,
    gan_fake: Optional[np.ndarray] = None,
    run_minjerk: bool = True,
    model_config: ModelConfig = DEFAULT_MODEL_CONFIG,
    eval_config: EvaluationConfig = DEFAULT_EVALUATION_CONFIG,
    skip_dtw: bool = False,
    cache_dir: Optional[str] = None,
    verbose: bool = True,
    device="cuda",
    stage_seconds: Optional[Dict[str, float]] = None,
) -> Tuple[Optional[Dict], Optional[Dict]]:
    """Evaluate generated samples and/or the min-jerk baseline against the
    same real test gestures on ``device``, reusing real-side computation
    across the two. ``stage_seconds``, if given, receives the host seconds of
    each stage of the metric suite under ``"gan"`` and ``"minjerk"`` (the
    latter with the baseline's fit and sampling)."""
    train_g = train_ds.gestures
    gan_results = minjerk_results = None
    cached_real = None
    if stage_seconds is None:
        stage_seconds = {}

    if gan_fake is not None:
        if verbose:
            log("  Computing GAN metrics...")
        gan_results = evaluate_all_metrics(
            real_gestures, gan_fake, train_g, model_config, eval_config,
            skip_dtw=skip_dtw, cache_dir=cache_dir, verbose=verbose, device=device,
        )
        cached_real = gan_results.pop("_cached_real", None)
        stage_seconds["gan"] = gan_results.pop("_stage_seconds")

    if run_minjerk:
        if verbose:
            log("  Fitting minimum-jerk model...")
        t0 = time.perf_counter()
        mj_model = fit_minjerk_from_dataset(train_ds, keyboard, verbose=verbose)
        mj_fake = generate_minjerk_samples(mj_model, words, model_config.seq_length)
        fit_seconds = time.perf_counter() - t0
        if verbose:
            log("  Computing Min Jerk metrics...")
        minjerk_results = evaluate_all_metrics(
            real_gestures, mj_fake, train_g, model_config, eval_config,
            skip_dtw=skip_dtw, cached_real=cached_real, cache_dir=cache_dir,
            verbose=verbose, device=device,
        )
        minjerk_results.pop("_cached_real", None)
        stage_seconds["minjerk"] = {"fit_and_sample": fit_seconds,
                                    **minjerk_results.pop("_stage_seconds")}

    return gan_results, minjerk_results


def print_results_table(results: Dict, model_name: str, paper_values: Dict,
                        precision_k: int = 3) -> None:
    """Single-model table vs paper values."""
    log("=" * 75)
    log(f"{model_name} Results")
    log("=" * 75)
    log(f'{"Metric":<30} {"Ours":>15} {"Paper":>15} {"Notes":>12}')
    log("-" * 75)
    log(f'{"L2 Wasserstein (x,y)":<30} {results["l2_wasserstein"]:>15.3f} {paper_values["l2"]:>15} {"lower=better":>12}')
    dtw = "SKIPPED" if results["dtw_wasserstein"] < 0 else f'{results["dtw_wasserstein"]:.3f}'
    log(f'{"DTW Wasserstein (x,y)":<30} {dtw:>15} {paper_values["dtw"]:>15} {"lower=better":>12}')
    log(f'{"Jerk (generated)":<30} {results["jerk_fake"]:>15.5f} {paper_values["jerk_fake"]:>15} {"~real":>12}')
    log(f'{"Jerk (real)":<30} {results["jerk_real"]:>15.5f} {paper_values["jerk_real"]:>15} {"reference":>12}')
    log(f'{"Velocity Corr":<30} {results["velocity_corr"]:>15.3f} {paper_values["vel"]:>15} {"higher=better":>12}')
    log(f'{"Acceleration Corr":<30} {results["acceleration_corr"]:>15.3f} {paper_values["acc"]:>15} {"higher=better":>12}')
    log(f'{"Speed Profile Corr":<30} {results["speed_profile_corr"]:>15.3f} {"--":>15} {"higher=better":>12}')
    log(f'{"Time Delta Corr":<30} {results["time_delta_corr"]:>15.3f} {"--":>15} {"higher=better":>12}')
    log("-" * 75)
    log(f'{"AE Reconstruction (L1)":<30} {results["ae_reconstruction_loss"]:>15.4f} {"0.041":>15} {"lower=better":>12}')
    log(f'{"AE Test Loss (L1)":<30} {results["ae_test_loss"]:>15.4f} {"0.046":>15} {"lower=better":>12}')
    # Both FID feature spaces: 'paper' is the reference/paper-comparable
    # number; 'positional' is the framework's shape-aware space (see
    # EvaluationConfig.fid_feature_mode).
    if "fid_paper" in results:
        log(f'{"FID [paper]":<30} {results["fid_paper"]:>15.4f} {paper_values["fid"]:>15} {"lower=better":>12}')
        log(f'{"FID [positional]":<30} {results["fid_positional"]:>15.4f} {"--":>15} {"shape-aware":>12}')
    else:
        fid_mode = results.get("fid_feature_mode", "paper")
        fid_note = "lower=better" if fid_mode == "paper" else "≠paper-space"
        log(f'{f"FID [{fid_mode}]":<30} {results["fid"]:>15.4f} {paper_values["fid"]:>15} {fid_note:>12}')
    log("-" * 75)
    log(f'{f"Precision (k={precision_k})":<30} {results["precision"]:>15.3f} {paper_values["precision"]:>15} {"higher=better":>12}')
    log(f'{f"Recall (k={precision_k})":<30} {results["recall"]:>15.3f} {paper_values["recall"]:>15} {"higher=better":>12}')
    log("=" * 75)


def print_comparison_table(gan_results: Dict, minjerk_results: Dict,
                           precision_k: int = 3) -> None:
    """Side-by-side GAN vs min-jerk table."""
    log("=" * 90)
    log("Side-by-Side Comparison: GAN vs Minimum Jerk")
    log("=" * 90)
    log(f'{"Metric":<30} {"GAN":>15} {"Min Jerk":>15} {"Paper GAN":>12} {"Paper MJ":>12}')
    log("-" * 90)
    pg, pm = PAPER_GAN, PAPER_MINJERK  # single source of the Table-6 constants
    log(f'{"L2 Wasserstein (x,y)":<30} {gan_results["l2_wasserstein"]:>15.3f} {minjerk_results["l2_wasserstein"]:>15.3f} {pg["l2"]:>12} {pm["l2"]:>12}')
    g_dtw = "SKIP" if gan_results["dtw_wasserstein"] < 0 else f'{gan_results["dtw_wasserstein"]:.3f}'
    m_dtw = "SKIP" if minjerk_results["dtw_wasserstein"] < 0 else f'{minjerk_results["dtw_wasserstein"]:.3f}'
    log(f'{"DTW Wasserstein (x,y)":<30} {g_dtw:>15} {m_dtw:>15} {pg["dtw"]:>12} {pm["dtw"]:>12}')
    log(f'{"Jerk (generated)":<30} {gan_results["jerk_fake"]:>15.5f} {minjerk_results["jerk_fake"]:>15.5f} {pg["jerk_fake"]:>12} {pm["jerk_fake"]:>12}')
    log(f'{"Velocity Corr":<30} {gan_results["velocity_corr"]:>15.3f} {minjerk_results["velocity_corr"]:>15.3f} {pg["vel"]:>12} {pm["vel"]:>12}')
    log(f'{"Acceleration Corr":<30} {gan_results["acceleration_corr"]:>15.3f} {minjerk_results["acceleration_corr"]:>15.3f} {pg["acc"]:>12} {pm["acc"]:>12}')
    log(f'{"Speed Profile Corr":<30} {gan_results["speed_profile_corr"]:>15.3f} {minjerk_results["speed_profile_corr"]:>15.3f} {"--":>12} {"--":>12}')
    log(f'{"Time Delta Corr":<30} {gan_results["time_delta_corr"]:>15.3f} {minjerk_results["time_delta_corr"]:>15.3f} {"--":>12} {"--":>12}')
    log("-" * 90)
    if "fid_paper" in gan_results and "fid_paper" in minjerk_results:
        log(f'{"FID [paper]":<30} {gan_results["fid_paper"]:>15.4f} {minjerk_results["fid_paper"]:>15.4f} {pg["fid"]:>12} {pm["fid"]:>12}')
        log(f'{"FID [positional]":<30} {gan_results["fid_positional"]:>15.4f} {minjerk_results["fid_positional"]:>15.4f} {"--":>12} {"--":>12}')
    else:
        fid_mode = gan_results.get("fid_feature_mode", "paper")
        log(f'{f"FID [{fid_mode}]":<30} {gan_results["fid"]:>15.4f} {minjerk_results["fid"]:>15.4f} {pg["fid"]:>12} {pm["fid"]:>12}')
    log(f'{f"Precision (k={precision_k})":<30} {gan_results["precision"]:>15.3f} {minjerk_results["precision"]:>15.3f} {pg["precision"]:>12} {pm["precision"]:>12}')
    log(f'{f"Recall (k={precision_k})":<30} {gan_results["recall"]:>15.3f} {minjerk_results["recall"]:>15.3f} {pg["recall"]:>12} {pm["recall"]:>12}')
    log("=" * 90)


def attach_eval_to_wandb(wb, gan_results=None, minjerk_results=None,
                         real_g=None, gan_fake=None, words=()) -> None:
    """Attach eval scalars and figures to a (resumed) W&B run.

    Mirrors the reference's eval-time logging (GAN scalars +
    comparison/overlay figures) and additionally logs the min-jerk
    metric table under ``eval_minjerk/`` (the reference computes but never
    logs it). ``wb`` is the wandb module as returned by
    ``cli_common.maybe_wandb``."""
    if gan_results:
        for key, val in gan_results.items():
            if isinstance(val, float):
                wb.summary[f"eval/{key}"] = val
    if minjerk_results:
        for key, val in minjerk_results.items():
            if isinstance(val, float):
                wb.summary[f"eval_minjerk/{key}"] = val
    if gan_fake is not None and real_g is not None:
        import matplotlib.pyplot as plt

        from ..viz import create_comparison_figure, create_overlay_figure

        words = list(words)
        fig = create_comparison_figure(real_g[:6], gan_fake[:6], words[:6])
        wb.log({"gestures/comparison": wb.Image(fig)})
        plt.close(fig)
        fig = create_overlay_figure(real_g[:5], gan_fake[:5],
                                    words[0] if words else "sample")
        wb.log({"gestures/overlay": wb.Image(fig)})
        plt.close(fig)
