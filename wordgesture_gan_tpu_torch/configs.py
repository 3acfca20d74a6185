"""Configuration dataclasses: the port's copy of ``ModelConfig`` and
``KeyboardConfig`` from the JAX package's ``configs.py``.

Field names and defaults are identical, so a ``run_meta.json`` written by
either package configures the other.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """GAN model architecture configuration."""

    # Sequence parameters
    seq_length: int = 128          # points per gesture trace
    input_dim: int = 3             # (x, y, t)

    # Latent space
    latent_dim: int = 32

    # Generator family: "bilstm", "mlp" or "transformer". The port serves
    # "bilstm"; the other two are not ported yet.
    generator_type: str = "bilstm"

    # Generator (bidirectional LSTM)
    gen_hidden_dim: int = 48
    gen_num_layers: int = 4

    # Generator (MLP variant)
    mlp_gen_hidden_dims: Tuple[int, ...] = (384, 384, 384)

    # Generator (Transformer variant)
    tfm_d_model: int = 64
    tfm_num_heads: int = 4
    tfm_num_layers: int = 4
    tfm_mlp_ratio: int = 4

    # Discriminator (MLP variant)
    disc_hidden_dims: Tuple[int, ...] = (192, 96, 48, 24)
    use_temporal_disc: bool = True   # Conv1D temporal critic instead of MLP

    # Prototype input: when False the generator only sees (x, y) and must
    # learn timing from spatial curvature.
    prototype_has_time: bool = False

    # Output head for the time channel:
    #   "tanh"     — all three channels through tanh (the reference head);
    #   "monotone" — xy through tanh; t is the cumsum of a softmax over L-1
    #                increment logits (t0 = 0, tL-1 = 1), monotone and
    #                normalized by construction.
    time_head: str = "tanh"

    # Variational encoder (MLP)
    enc_hidden_dims: Tuple[int, ...] = (192, 96, 48, 32)

    # Compute dtype of the model applies ("float32" or "bfloat16"). Weights
    # stay float32; the recurrence runs in this dtype, the output head in
    # float32.
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class KeyboardConfig:
    """Virtual QWERTY layout."""

    width: float = 1.0
    height: float = 1.0
    rows: Tuple[str, ...] = ("qwertyuiop", "asdfghjkl", "zxcvbnm")
    row_offsets: Tuple[float, ...] = (0.0, 0.05, 0.15)
    key_width: float = 0.1
    key_height: float = 0.333


DEFAULT_MODEL_CONFIG = ModelConfig()
DEFAULT_KEYBOARD_CONFIG = KeyboardConfig()
