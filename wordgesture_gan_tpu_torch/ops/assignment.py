"""Optimal assignment for Wasserstein-style matched distances (the port of
the JAX package's ``ops/assignment.py``).

* ``hungarian_matching`` — exact, on the host (scipy), used at the
  evaluation's scale (n ≈ 2000).
* ``sinkhorn_matching_cost`` — entropy-regularized optimal transport in
  tensors on the cost's device, for scales where O(n^3) Hungarian is
  infeasible. With small epsilon it approaches the exact assignment cost
  from above.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def hungarian_matching(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Exact minimum-cost perfect matching (row_ind, col_ind)."""
    from scipy.optimize import linear_sum_assignment

    return linear_sum_assignment(cost)


def matched_mean_distance(cost: np.ndarray) -> float:
    """Mean cost along the optimal assignment — the 'Wasserstein' scalar the
    evaluation reports."""
    r, c = hungarian_matching(cost)
    return float(cost[r, c].mean())


def sinkhorn_matching_cost(cost: torch.Tensor, epsilon: float = 0.01,
                           n_iters: int = 500) -> torch.Tensor:
    """Entropy-regularized OT cost between uniform marginals.

    Log-domain Sinkhorn: f, g updates via logsumexp; returns <P, C> for the
    resulting transport plan. With uniform 1/n row marginals the plan puts
    total mass 1 on matched pairs, so <P, C> is the mean matched distance."""
    n, m = cost.shape
    log_mu = cost.new_full((n,), -math.log(n))
    log_nu = cost.new_full((m,), -math.log(m))
    neg_c = -cost / epsilon
    f = cost.new_zeros((n,))
    g = cost.new_zeros((m,))
    for _ in range(n_iters):
        f = epsilon * (log_mu - torch.logsumexp(neg_c + g[None, :] / epsilon, dim=1))
        g = epsilon * (log_nu - torch.logsumexp(neg_c + f[:, None] / epsilon, dim=0))
    plan = torch.exp((f[:, None] + g[None, :]) / epsilon + neg_c)
    return torch.sum(plan * cost)
