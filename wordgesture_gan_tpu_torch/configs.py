"""Configuration dataclasses: the port's copy of ``ModelConfig``,
``TrainingConfig``, ``EvaluationConfig``, ``KeyboardConfig``,
``ContrastiveConfig``, ``PathsConfig`` and ``RuntimeConfig`` from the JAX
package's ``configs.py``.

Field names and defaults are identical, so a ``run_meta.json`` written by
either package configures the other.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """GAN model architecture configuration."""

    # Sequence parameters
    seq_length: int = 128          # points per gesture trace
    input_dim: int = 3             # (x, y, t)

    # Latent space
    latent_dim: int = 32

    # Generator family: "bilstm", "mlp" or "transformer" (models/generators.py).
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
class TrainingConfig:
    """GAN training configuration."""

    batch_size: int = 512
    learning_rate: float = 2e-4
    num_epochs: int = 200

    # WGAN: critic updates per generator update
    n_critic: int = 5

    # Cosine-annealing floor
    lr_scheduler_eta_min: float = 1e-5

    # Per-model global-norm gradient clipping (0 disables)
    grad_clip_norm: float = 1.0

    # Loss weights (paper Section 4.2)
    lambda_feat: float = 1.0
    lambda_rec: float = 4.0
    lambda_lat: float = 0.5
    lambda_kld: float = 0.02

    # Timing-dynamics auxiliaries on the cycle-2 reconstruction (0 = off):
    # an L1 on the per-segment time increments, a (1 - Pearson) loss on the
    # |v| profiles, and a (1 - Pearson) loss on the Δt pattern
    # (losses.time_delta_loss / speed_profile_loss / time_delta_corr_loss).
    lambda_dt: float = 0.0
    lambda_speed: float = 0.0
    lambda_dtc: float = 0.0

    # MSGAN mode-seeking regularizer on a second prior draw in cycle 1
    # (losses.mode_seeking_loss); costs one more differentiated generator
    # forward per step when on. 0 = off.
    lambda_ms: float = 0.0

    # Hinged conditional-diversity loss on the same second prior draw
    # (losses.diversity_hinge_loss): penalize a pair of generations only while
    # their mean-L1 distance is below div_margin. div_margin=None means
    # "measure it from the data": the training loop substitutes the corpus's
    # mean within-word L1 distance (data.pipeline.within_word_diversity).
    # 0 = off.
    lambda_div: float = 0.0
    div_margin: Optional[float] = None

    # Dataset balancing / split
    max_samples_per_word: int = 5
    train_ratio: float = 0.8

    # Checkpointing / logging cadence
    save_every: int = 10
    log_every: int = 100

    # Score (real ++ fake) in ONE spectral-norm critic forward per update (one
    # power-iteration advance) instead of the reference's two sequential
    # forwards, each of which advances u. Default False: the reference's
    # two-forward u schedule.
    fused_critic_forward: bool = False


@dataclass(frozen=True)
class EvaluationConfig:
    """Evaluation configuration."""

    n_samples: int = 2000
    truncation: float = 1.0

    # FID feature autoencoder
    fid_autoencoder_epochs: int = 100
    fid_autoencoder_lr: float = 1e-3
    fid_hidden_dim: int = 32
    # "positional" adds a time ramp to the FID autoencoder's decoder, so the
    # encoder must embed gesture shape; the paper's decoder ("paper")
    # broadcasts the latent with no positional signal, can only emit a
    # constant trace, and yields features near-blind to shape and timing.
    # Same encoder topology and feature dimensionality in both modes.
    fid_feature_mode: str = "positional"   # "positional" | "paper"

    # k-NN manifold precision/recall
    precision_recall_k: int = 3

    # Savitzky-Golay jerk filter
    savgol_window: int = 21
    savgol_poly_order: int = 3


@dataclass(frozen=True)
class KeyboardConfig:
    """Virtual QWERTY layout."""

    width: float = 1.0
    height: float = 1.0
    rows: Tuple[str, ...] = ("qwertyuiop", "asdfghjkl", "zxcvbnm")
    row_offsets: Tuple[float, ...] = (0.0, 0.05, 0.15)
    key_width: float = 0.1
    key_height: float = 0.333


@dataclass(frozen=True)
class ContrastiveConfig:
    """Contrastive gesture encoder configuration."""

    embedding_dim: int = 64
    temperature: float = 0.07

    learning_rate: float = 1e-3
    batch_words: int = 32
    gestures_per_word: int = 2
    num_epochs: int = 100

    use_cosine_annealing: bool = True
    eta_min: float = 1e-5

    seq_length: int = 128
    input_dim: int = 3


@dataclass(frozen=True)
class PathsConfig:
    """Local run paths."""

    checkpoint_dir: str = "checkpoints"
    data_path: str = "dataset/swipelogs.zip"
    cache_dir: str = ""            # "" → alongside the zip
    wandb_project: str = "wordgesture-gan-tpu"
    random_seed: int = 42


@dataclass(frozen=True)
class RuntimeConfig:
    """Data parallelism and precision: one process per card, joined by
    ``torch.distributed`` (``parallel/``), each process training on its rows
    of every global batch.

    ``donate_state`` of the JAX package's ``RuntimeConfig`` is absent: it asks
    XLA to reuse the state's buffers, and the port's steps update the state in
    place anyway.
    """

    # Ranks on the data-parallel axis: -1 → every visible card (one process
    # each), or every rank of an existing process group.
    data_axis_size: int = -1
    mesh_axis_names: Tuple[str, ...] = ("data",)

    # "float32" or "bfloat16" (bf16 compute, fp32 weights, optimizer and
    # losses). CLIs copy this into ModelConfig.compute_dtype.
    precision: str = "float32"

    # Epoch strategy: False (default, as in the JAX package) runs the step
    # eagerly once per batch, one Python dispatch per kernel; True runs the
    # epoch through ``gan_train_epoch`` / ``gan_train_epoch_masked``, the
    # counterparts of the JAX package's ``lax.scan`` epoch: on a CUDA device
    # the step is captured once as a CUDA graph and replayed once per batch
    # (``train/step_graph.py``); on the CPU the same steps run in a loop.
    scan_epoch: bool = False


DEFAULT_MODEL_CONFIG = ModelConfig()
DEFAULT_TRAINING_CONFIG = TrainingConfig()
DEFAULT_EVALUATION_CONFIG = EvaluationConfig()
DEFAULT_KEYBOARD_CONFIG = KeyboardConfig()
DEFAULT_CONTRASTIVE_CONFIG = ContrastiveConfig()
DEFAULT_PATHS_CONFIG = PathsConfig()
DEFAULT_RUNTIME_CONFIG = RuntimeConfig()


def asdict(cfg) -> dict:
    """Dataclass → plain dict (for logging and checkpoint metadata)."""
    return dataclasses.asdict(cfg)
