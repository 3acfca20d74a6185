"""The variable-length GAN training loop and masked sampling (the port of the
JAX package's ``train/variable_loop.py``).

The masked twin of ``gan_loop.train_gan``: padded traces with validity
masks, the transformer generator, ``masked_step.gan_train_step_masked`` once
per batch (with ``RuntimeConfig.scan_epoch``, ``gan_train_epoch_masked``),
and the same learning-rate schedule, shuffle, checkpoint, history,
preemption and non-finite-loss contract (``gan_loop.run_epochs``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from ..configs import (DEFAULT_RUNTIME_CONFIG, DEFAULT_TRAINING_CONFIG, ModelConfig,
                       RuntimeConfig, TrainingConfig)
from ..data.variable_length import VariableGestureArrays
from ..models.gan import Generator
from .gan_loop import TrainResult, generate_gestures, run_epochs
from .masked_step import METRIC_KEYS, gan_train_epoch_masked, gan_train_step_masked

# The losses each epoch's log line shows, as (label, metric).
_LOG_FIELDS = (("D1", "d1_loss"), ("D2", "d2_loss"), ("C1", "cycle1_total"),
               ("C2", "cycle2_total"), ("Rec", "cycle2_rec"))


def _require_transformer(config: ModelConfig) -> None:
    if config.generator_type != "transformer":
        raise ValueError("variable-length training and sampling use the transformer "
                         "generator (ModelConfig.generator_type='transformer')")


def train_variable_gan(
    train_ds: VariableGestureArrays,
    model_config: ModelConfig,
    training_config: TrainingConfig = DEFAULT_TRAINING_CONFIG,
    runtime_config: RuntimeConfig = DEFAULT_RUNTIME_CONFIG,
    num_epochs: Optional[int] = None,
    seed: int = 42,
    checkpoint_dir: Optional[str] = None,
    resume: bool = True,
    epoch_callback: Optional[Callable[[int, Dict, Dict[str, float]], None]] = None,
    verbose: bool = True,
    device="cuda",
) -> TrainResult:
    """Train the two-cycle GAN on variable-length traces on ``device``
    (transformer generator only), over the ranks of the process group if
    there is one; per epoch what ``train_gan`` does, with the masked step
    and its five losses."""
    _require_transformer(model_config)
    arrays = {"gesture": train_ds.gestures, "prototype": train_ds.prototypes,
              "mask": train_ds.masks()}
    return run_epochs(
        arrays, lambda s, b, lr, mesh: gan_train_step_masked(s, b, lr, model_config,
                                                             training_config, mesh=mesh),
        lambda s, eb, lr, mesh, graph: gan_train_epoch_masked(s, eb, lr, model_config,
                                                              training_config, mesh=mesh,
                                                              graph=graph),
        METRIC_KEYS, _LOG_FIELDS, model_config, training_config, runtime_config, num_epochs, seed,
        checkpoint_dir, resume, epoch_callback, print if verbose else (lambda *_: None), device)


def generate_variable_gestures(generator: Generator, prototypes: np.ndarray, masks: np.ndarray,
                               config: ModelConfig, truncation: float = 1.0, seed: int = 0,
                               batch: int = 512, device="cuda",
                               z: Optional[np.ndarray] = None) -> np.ndarray:
    """Masked sampling from a variable-length (transformer) generator:
    (n, L, 3) padded prototypes and (n, L) masks → (n, L, 3) float32, zero
    on the padding; ``gan_loop.generate_gestures`` with the masks."""
    _require_transformer(config)
    return generate_gestures(generator, prototypes, config, truncation=truncation, seed=seed,
                             batch=batch, device=device, z=z, masks=masks)
