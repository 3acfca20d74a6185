"""PyTorch/CUDA port of wordgesture_gan_tpu: gesture serving, fixed-length
two-cycle GAN training, and evaluation (data pipeline, metric suite, CLIs).

A second package beside the JAX one: it imports torch and numpy only, keeps
its own copies of the configuration, keyboard, data and chunking code it
needs, and mirrors the JAX package's module names so each counterpart is easy
to find. The stacked BiLSTM generator's recurrence runs as hand-written CUDA
kernels for Hopper: the inference forward (``ops/bilstm_fused.py``,
``csrc/bilstm_fused.cu``) and the training forward and backward through time
(``ops/bilstm_train.py``, ``csrc/bilstm_train.cu``); the evaluation's exact
DTW distances come from a fourth (``ops/dtw.py``, ``csrc/dtw.cu``). Tensors on
the CPU take the kernels' plain PyTorch versions, which the tests hold
against the JAX package.

Entry points take ``device="cuda"`` by default; pass ``device="cpu"`` to run
the plain versions. Training runs data-parallel over ``torch.distributed``,
one process per card (``parallel/``).

The package re-exports the JAX package's API surface: the configurations
and keyboard here, the major entry points lazily (``train_gan``,
``create_data_loaders``, ``evaluate_all_metrics``, ...), and each
sub-package the counterparts of its JAX twin's names. Left out, as
TPU-only: ``ops/tpu_platform.py``, ``utils/compile_cache.py`` (XLA's
compilation cache) and ``parallel.packed_replicate`` / ``batch_sharding`` /
``replicated`` (transfers and sharding annotations of XLA). The JAX
package's epoch as one ``lax.scan`` (``train.gan_train_epoch``,
``RuntimeConfig.scan_epoch``) is a captured CUDA graph of the step here.
"""

from . import configs, keyboard, losses
from .configs import (
    ContrastiveConfig,
    EvaluationConfig,
    KeyboardConfig,
    ModelConfig,
    PathsConfig,
    RuntimeConfig,
    TrainingConfig,
)
from .keyboard import (
    MinimumJerkDistributions,
    MinimumJerkModel,
    QWERTYKeyboard,
    generate_minimum_jerk_trajectory,
    generate_minimum_jerk_trajectory_fitted,
)

__version__ = "0.1.0"

# Lazy top-level re-exports, {name: sub-module}: importing the package for
# configuration or keyboard work does not pull in the models and kernels.
_LAZY = {
    # data pipeline
    "load_dataset_from_zip": "data",
    "create_train_test_split": "data",
    "create_data_loaders": "data",
    "GestureDataset": "data",
    "infer_key_positions": "data",
    "create_contrastive_datasets": "data",
    # training
    "train_gan": "train.gan_loop",
    "generate_gestures": "train.gan_loop",
    "train_contrastive": "train.contrastive_loop",
    "init_gan_state": "train.state",
    # evaluation
    "evaluate_all_metrics": "metrics",
    "evaluate_gan_and_minjerk": "eval",
    # visualization
    "plot_gestures_on_keyboard": "viz",
    "create_comparison_figure": "viz",
    "create_overlay_figure": "viz",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
