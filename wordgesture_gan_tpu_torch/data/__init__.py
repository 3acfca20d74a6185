"""The data pipeline: swipelog parsing and preprocessing, gesture arrays and
their loaders, the contrastive datasets, the synthetic corpus and its
realism report (the port of the JAX package's ``data/``)."""

from .contrastive import (
    ContrastiveArrays,
    ContrastiveBatchSampler,
    augment_with_minimum_jerk,
    create_contrastive_datasets,
    sample_epoch_batches,
    word_labels_to_array,
)
from .parse import RawGesture, parse_log_file
from .pipeline import (
    ArrayLoader,
    GestureArrays,
    GestureDataset,
    create_data_loaders,
    create_train_test_split,
    load_dataset_from_zip,
)
from .preprocess import (
    apply_canonical_transform,
    compute_canonical_transform,
    infer_key_positions,
    normalize_gesture,
)
from .realism import compare_to_real, load_real_sentence_stats, synthetic_sentence_stats
from .synthetic import write_synthetic_swipelogs_zip
