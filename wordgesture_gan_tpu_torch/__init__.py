"""PyTorch/CUDA port of the wordgesture_gan_tpu serving path.

A second package beside the JAX one: it imports torch and numpy only, keeps
its own copies of the configuration, keyboard and chunking code it needs, and
mirrors the JAX package's module names so each counterpart is easy to find.
The stacked BiLSTM generator's recurrence runs as a hand-written CUDA kernel
for Hopper (``ops/bilstm_fused.py``, ``csrc/bilstm_fused.cu``); tensors on the
CPU take the kernel's plain PyTorch version, which the tests hold against the
JAX package.

Entry points take ``device="cuda"`` by default; pass ``device="cpu"`` to run
the plain versions.
"""

from .configs import KeyboardConfig, ModelConfig
from .keyboard import QWERTYKeyboard

__all__ = ["KeyboardConfig", "ModelConfig", "QWERTYKeyboard"]
