"""Chunk sizing and padding for batched generation.

Chunks are a power of two no larger than the requested batch, and inputs are
zero-padded to whole chunks (callers crop the output back to n rows). The
same layout as the JAX package's ``utils/chunking.py``, so both packages cut
a request into the same chunks.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def chunk_layout(n: int, batch: int) -> Tuple[int, int]:
    """(chunk_size, n_chunks) for n rows at a requested max batch. n >= 1."""
    batch = min(batch, 1 << (n - 1).bit_length())
    return batch, -(-n // batch)


def pad_to_chunks(array, chunk: int, n_chunks: int, dtype=np.float32) -> np.ndarray:
    """Zero-pad a host array's leading axis to exactly chunk * n_chunks rows."""
    array = np.asarray(array, dtype)
    padded = np.zeros((chunk * n_chunks, *array.shape[1:]), dtype)
    padded[: len(array)] = array
    return padded
