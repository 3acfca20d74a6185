"""Logging and seeding utilities (the port of the JAX package's
``utils/logging.py``)."""

from __future__ import annotations

import random

import numpy as np
import torch


def log(msg: str) -> None:
    """Flush-print."""
    print(msg, flush=True)


def seed_everything(seed: int) -> None:
    """Seed the host generators (stdlib, numpy) and torch's global one. The
    port's own draws go through explicit JAX-style keys (``utils/prng.py``)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
