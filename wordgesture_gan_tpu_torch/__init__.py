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
the plain versions.
"""

from .configs import EvaluationConfig, KeyboardConfig, ModelConfig, TrainingConfig
from .keyboard import QWERTYKeyboard

__all__ = ["EvaluationConfig", "KeyboardConfig", "ModelConfig", "QWERTYKeyboard",
           "TrainingConfig"]
