"""Matrix-square-root trace for FID by symmetric eigendecompositions (the
port of the JAX package's ``ops/sqrtm.py``).

FID only needs tr((Σr·Σf)^{1/2}); for PSD Σr that equals the sum of square
roots of the eigenvalues of the symmetric product Σr^{1/2}·Σf·Σr^{1/2}, so
everything reduces to two symmetric eigendecompositions. The metric suite's
FID runs in float64 numpy on the host (``metrics/fid.py``); this is the
tensor variant.
"""

from __future__ import annotations

import torch


def psd_sqrt(mat: torch.Tensor) -> torch.Tensor:
    """Symmetric PSD square root via eigh (eigenvalues clipped at 0)."""
    w, v = torch.linalg.eigh(mat)
    return (v * torch.sqrt(w.clamp_min(0.0))[None, :]) @ v.T


def trace_sqrt_product(cov_a: torch.Tensor, cov_b: torch.Tensor) -> torch.Tensor:
    """tr((cov_a @ cov_b)^{1/2}) for PSD inputs."""
    sa = psd_sqrt(cov_a)
    w = torch.linalg.eigvalsh(sa @ cov_b @ sa)
    return torch.sqrt(w.clamp_min(0.0)).sum()


def frechet_distance(mu_a: torch.Tensor, cov_a: torch.Tensor,
                     mu_b: torch.Tensor, cov_b: torch.Tensor) -> torch.Tensor:
    """||mu_a - mu_b||^2 + tr(cov_a + cov_b - 2 (cov_a cov_b)^{1/2}); the
    caller applies the diagonal jitter."""
    diff = mu_a - mu_b
    return (diff @ diff + torch.trace(cov_a) + torch.trace(cov_b)
            - 2.0 * trace_sqrt_product(cov_a, cov_b))
