"""Hand-written CUDA kernels, their wrappers and their plain PyTorch versions,
and the evaluation's array operations. ``tpu_platform`` (a TPU platform
probe) has no counterpart."""

from .assignment import hungarian_matching, matched_mean_distance, sinkhorn_matching_cost
from .dtw import dtw_distance_matrix, dtw_pairs
from .resample import batched_arclength_resample, batched_word_prototypes
from .savgol import batched_savgol_jerk, savgol_matrix
from .sqrtm import frechet_distance, psd_sqrt, trace_sqrt_product
from .stats import (
    acceleration_correlation,
    knn_precision_recall,
    pairwise_l2,
    speed_profile_correlation,
    time_aware_acceleration,
    time_aware_jerk,
    time_aware_velocity,
    time_delta_correlation,
    velocity_correlation,
)
