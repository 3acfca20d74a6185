"""The generator, encoder, critics, FID autoencoder and contrastive encoder."""

from .contrastive import contrastive_encoder_apply, contrastive_encoder_init
from .gan import (
    Generator,
    autoencoder_apply,
    autoencoder_decode,
    autoencoder_encode,
    autoencoder_init,
    disc_apply,
    disc_init,
    encoder_apply,
    encoder_init,
    generator_apply,
    generator_init,
    mlp_disc_apply,
    mlp_disc_init,
    temporal_disc_apply,
    temporal_disc_init,
)
