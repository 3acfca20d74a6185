"""Learning-rate schedules (the port of the JAX package's ``train/schedules.py``)."""

from __future__ import annotations

import numpy as np


def cosine_annealing_lr(base_lr: float, step: float, t_max: int, eta_min: float = 1e-5) -> float:
    """eta_min + (base - eta_min) · (1 + cos(pi · step / T_max)) / 2."""
    return eta_min + (base_lr - eta_min) * (1 + np.cos(np.pi * step / t_max)) / 2.0
