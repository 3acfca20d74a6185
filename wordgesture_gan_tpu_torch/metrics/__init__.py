"""The evaluation metric suite."""

from .fid import (
    encode_features,
    fid_from_features,
    load_or_train_fid_autoencoder,
    train_fid_autoencoder,
)
from .suite import evaluate_all_metrics
