"""The read side of checkpoints that serving needs: run metadata and
generator weights.

Generator weights come either from a port checkpoint — ``torch.save`` of a
``Generator`` state dict (``.pt``) — or from a path-keyed JAX generator
``.npz`` (``interop/from_jax.py``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import torch

from ..configs import ModelConfig
from ..interop.from_jax import generator_from_npz
from ..models.gan import Generator


def load_run_metadata(checkpoint_dir: str) -> dict:
    """``run_meta.json`` of a checkpoint directory, or {} if it is missing or
    unreadable (a corrupt sidecar must not block a run)."""
    meta_path = Path(checkpoint_dir).absolute() / "run_meta.json"
    if not meta_path.exists():
        return {}
    try:
        return json.loads(meta_path.read_text())
    except (json.JSONDecodeError, OSError):
        return {}


def load_generator_weights(path: str) -> Dict[str, torch.Tensor]:
    """Generator state dict from a ``.npz`` (JAX tree) or a port checkpoint."""
    if str(path).endswith(".npz"):
        return generator_from_npz(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_generator(path: str, config: ModelConfig, device="cuda") -> Generator:
    """A ``Generator`` of ``config`` on ``device`` holding the weights at
    ``path``; weights of another shape raise."""
    model = Generator(config)
    model.load_state_dict(load_generator_weights(path))
    return model.to(device).eval()
