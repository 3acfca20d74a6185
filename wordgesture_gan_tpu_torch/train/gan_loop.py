"""Batched sampling from the generator (the serving half of the JAX
package's ``train/gan_loop.py``; training is not ported yet)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..configs import DEFAULT_MODEL_CONFIG, ModelConfig
from ..models.gan import Generator
from ..utils.chunking import chunk_layout, pad_to_chunks


def generate_gestures(generator: Generator, prototypes: np.ndarray,
                      config: ModelConfig = DEFAULT_MODEL_CONFIG, truncation: float = 1.0,
                      seed: int = 0, batch: int = 512, device="cuda",
                      z: Optional[np.ndarray] = None) -> np.ndarray:
    """Sample one gesture per prototype: (n, L, 3) prototypes → (n, L, 3)
    float32, with z ~ N(0, 1)·truncation.

    The prototypes are zero-padded to whole power-of-two chunks of at most
    ``batch`` rows (``utils/chunking.py``, the JAX package's layout) and the
    generator runs once per chunk on ``device``. Each chunk draws its noise
    from one ``torch.Generator`` on ``device`` seeded with ``seed``. ``z``
    (n, Z), if given, replaces those draws (it is still scaled by
    ``truncation``): JAX's random stream cannot be reproduced, so a test
    hands both packages the same noise this way.

    ``config`` must be the generator's own configuration; the generator is
    moved to ``device``."""
    n = len(prototypes)
    if n == 0:
        return np.zeros((0, *np.shape(prototypes)[1:]), np.float32)
    if config != generator.config:
        raise ValueError("config differs from the generator's own configuration")
    device = torch.device(device)
    chunk, n_chunks = chunk_layout(n, batch)
    protos = torch.from_numpy(pad_to_chunks(prototypes, chunk, n_chunks)).to(device)
    noise = None
    if z is not None:
        if np.shape(z) != (n, config.latent_dim):
            raise ValueError(f"z must be ({n}, {config.latent_dim}), got {np.shape(z)}")
        noise = torch.from_numpy(pad_to_chunks(z, chunk, n_chunks)).to(device)
    rng = torch.Generator(device=device)
    rng.manual_seed(seed)
    generator = generator.to(device)
    outs = []
    with torch.inference_mode():
        for c in range(n_chunks):
            rows = slice(c * chunk, (c + 1) * chunk)
            if noise is None:
                eps = torch.randn((chunk, config.latent_dim), generator=rng, device=device)
            else:
                eps = noise[rows]
            outs.append(generator(protos[rows], eps * truncation))
    return torch.cat(outs).float().cpu().numpy()[:n]
