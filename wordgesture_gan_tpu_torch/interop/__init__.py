"""Weight interchange: the CHI'23 reference implementation's PyTorch
``state_dict``s (``torch_weights``) and the JAX package's trees as numpy
(``from_jax``)."""

from .from_jax import (
    contrastive_state_from_jax,
    generator_from_jax,
    generator_from_npz,
    train_state_from_jax,
    write_generator_npz,
)
from .torch_weights import (
    autoencoder_from_torch,
    contrastive_encoder_from_torch,
    disc_from_torch,
    encoder_from_torch,
    generator_from_torch,
    mlp_disc_from_torch,
    temporal_disc_from_torch,
    trainer_state_from_torch,
)
