"""Least times of the transformer generator's attention core (the program's
``csrc/attention.cu``) on one H100: the larger of its bytes at the HBM peak
and its products at the compute dtype's peak (``flops.py``'s peaks).

Bytes: each operand read once and each result written once. A forward reads
q, k, v (B, L, H, h) and the float32 mask (B, L) and writes the output
(B, L, H * h); a backward reads q, k, v, the output's gradient and the mask
and writes dq, dk, dv. Products: a forward's q k^T and P V, a backward's
dO V^T, P^T dO, dS k and dS^T q, 2 B H L^2 h operations each.
"""

from __future__ import annotations

from typing import Dict, Tuple

from portbench.flops import PEAK_BYTES_PER_S, PEAK_FLOPS


def _least_ms(nbytes: float, flops: float, peak_flops: float) -> Tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_bounds_ms(batch: int, seq: int, heads: int, head_dim: int, dtype: str,
                        masked: bool = True) -> Dict[str, Tuple[float, str]]:
    """{"fwd": (ms, by), "bwd": (ms, by)} of one call at (batch, seq) with
    ``heads`` heads of ``head_dim``, by "bytes" or "operations"."""
    item = 2 if dtype == "bfloat16" else 4
    tensor = batch * seq * heads * head_dim * item
    mask = batch * seq * 4 if masked else 0
    product = 2 * batch * heads * seq * seq * head_dim
    peak = PEAK_FLOPS[dtype]
    return {"fwd": _least_ms(4 * tensor + mask, 2 * product, peak),
            "bwd": _least_ms(7 * tensor + mask, 4 * product, peak)}
