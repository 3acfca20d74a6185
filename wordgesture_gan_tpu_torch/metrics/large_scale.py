"""Distribution metrics at 10⁵ gestures (the port of the JAX package's
``metrics/large_scale.py``).

At n = 100k the evaluation suite's recipe is infeasible: Hungarian
assignment is O(n³), and even the n x n distance matrix is 40 GB. These
estimators replace it, each in tensors on the device:

* sliced Wasserstein-2: project flattened gestures onto random unit
  directions, sort, average the 1-D W2;
* energy distance from 2²⁰ sampled pairs per term, the three terms one
  after another (each gathers 2²⁰ rows);
* k-NN precision and recall with the cross-distance matrix streamed in row
  chunks of 2048 (a 2048 x 10⁵ chunk is 0.8 GB), keeping only per-sample
  radii and "covered" flags;
* the Sinkhorn matched cost on subsamples, raw and extrapolated in log2 of
  the subsample size to the full population;
* FID, whose feature moments are O(n · d).

Every random draw is the JAX package's, from the same key tree
(``utils/prng.py``: the keys on the host, the draws on the data's device),
and each function also takes the draws themselves as an injection argument
(``dirs=``, ``pairs=``, ``indices=``, ``draws=``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.assignment import sinkhorn_matching_cost
from ..ops.stats import pairwise_l2
from ..utils import prng
from ..utils.chunking import pad_to_chunks

_BIG = 1e30

# (real row indices, fake row indices) of one Sinkhorn subsample.
IndexPair = Tuple[torch.Tensor, torch.Tensor]


def _key(key: Optional[torch.Tensor], seed: int) -> torch.Tensor:
    """``key``, else ``PRNGKey(seed)`` (the JAX package's default per
    estimator)."""
    return prng.PRNGKey(seed) if key is None else key


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.long, device=device)


def sliced_wasserstein2(a: torch.Tensor, b: torch.Tensor, n_projections: int = 128,
                        key: Optional[torch.Tensor] = None, dirs=None) -> torch.Tensor:
    """Sliced W2 between row sets a (n, D) and b (n, D): the exact 1-D
    squared W2 averaged over ``n_projections`` random unit directions, square
    rooted (units of L2). The directions are ``normal(key, (D, K))``
    normalized; ``dirs`` (D, K) replaces the normal draws."""
    if dirs is None:
        dirs = prng.normal(_key(key, 0).to(a.device), (a.shape[1], n_projections))
    else:
        dirs = torch.as_tensor(dirs, dtype=torch.float32, device=a.device)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=0, keepdim=True)
    pa = torch.sort(a @ dirs, dim=0).values                 # (n, K)
    pb = torch.sort(b @ dirs, dim=0).values
    return torch.sqrt(torch.mean((pa - pb) ** 2))


def energy_pairs(n: int, m: int, n_pairs: int, key: torch.Tensor,
                 device) -> Tuple[IndexPair, IndexPair, IndexPair]:
    """The index pairs of the three terms, drawn as the JAX package draws
    them (``k1, k2, k3, k4 = split(key, 4)``): i over a (k1) and j over b
    (k2) for E|X-Y|; the within-set terms reuse i and j as their first index
    and offset the second by 1..size-1 (k3, k4), so a pair never repeats a
    row."""
    k1, k2, k3, k4 = prng.split(key, 4)
    i = prng.randint(k1, (n_pairs,), 0, n, device)
    j = prng.randint(k2, (n_pairs,), 0, m, device)
    i2 = (i + prng.randint(k3, (n_pairs,), 1, n, device)) % n
    j2 = (j + prng.randint(k4, (n_pairs,), 1, m, device)) % m
    return (i, j), (i, i2), (j, j2)


def energy_distance(a: torch.Tensor, b: torch.Tensor, n_pairs: int = 1 << 20,
                    key: Optional[torch.Tensor] = None,
                    pairs: Optional[Sequence[IndexPair]] = None) -> torch.Tensor:
    """Monte-Carlo energy distance 2 E|X-Y| - E|X-X'| - E|Y-Y'| over
    ``n_pairs`` sampled pairs per term. ``pairs`` = ((i, j) of a-b, of a-a,
    of b-b) replaces the draws of ``energy_pairs``."""
    if pairs is None:
        pairs = energy_pairs(a.shape[0], b.shape[0], n_pairs, _key(key, 1), a.device)

    def mean_dist(x, y, ij):
        d = x[_index(ij[0], x.device)] - y[_index(ij[1], x.device)]
        return torch.sqrt(torch.sum(d * d, dim=-1)).mean()

    cross = mean_dist(a, b, pairs[0])
    within_a = mean_dist(a, a, pairs[1])
    within_b = mean_dist(b, b, pairs[2])
    return 2.0 * cross - within_a - within_b


def _pad_rows(x: np.ndarray, chunk: int) -> np.ndarray:
    return pad_to_chunks(x, chunk, -(-len(x) // chunk), x.dtype)


def _knn_radii_scanned(x: torch.Tensor, n_valid: int, k: int, row_chunk: int) -> torch.Tensor:
    """Per-row distance to the k-th same-set neighbor (the (k+1)-th smallest
    distance, self included), one row chunk at a time. Rows beyond
    ``n_valid`` (padding) get radius -BIG and cover nothing; padded columns
    are +BIG and never count as neighbors."""
    X = x.shape[0]
    col_ok = torch.arange(X, device=x.device) < n_valid
    radii = []
    for rows in x.split(row_chunk):
        d = torch.where(col_ok[None, :], pairwise_l2(rows, x), _BIG)
        radii.append(torch.topk(d, k + 1, dim=1, largest=False).values[:, k])
    return torch.where(~col_ok, -_BIG, torch.cat(radii))


def _knn_coverage_scanned(real: torch.Tensor, fake: torch.Tensor, real_radii: torch.Tensor,
                          fake_radii: torch.Tensor,
                          row_chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """covered_fake[j] = any_i d(real_i, fake_j) <= real_radii[i];
    covered_real[i] = any_j d(real_i, fake_j) <= fake_radii[j]; one pass
    over real row chunks."""
    covered_fake = torch.zeros(fake.shape[0], dtype=torch.bool, device=fake.device)
    covered_real = []
    for rows, rr in zip(real.split(row_chunk), real_radii.split(row_chunk)):
        d = pairwise_l2(rows, fake)                          # (chunk, M)
        covered_fake |= torch.any(d <= rr[:, None], dim=0)
        covered_real.append(torch.any(d <= fake_radii[None, :], dim=1))
    return covered_fake, torch.cat(covered_real)


def chunked_knn_precision_recall(real_flat: np.ndarray, fake_flat: np.ndarray, k: int = 3,
                                 row_chunk: int = 2048, device="cuda") -> Tuple[float, float]:
    """k-NN manifold precision and recall without an n x m matrix: both sets
    zero-padded to whole row chunks, radii per set, then coverage as a
    running OR over real row chunks, on ``device``."""
    n_real, n_fake = len(real_flat), len(fake_flat)
    row_chunk = min(row_chunk, max(n_real, 1), max(n_fake, 1))
    real_d = torch.from_numpy(_pad_rows(np.asarray(real_flat, np.float32), row_chunk)).to(device)
    fake_d = torch.from_numpy(_pad_rows(np.asarray(fake_flat, np.float32), row_chunk)).to(device)

    real_radii = _knn_radii_scanned(real_d, n_real, k, row_chunk)
    fake_radii = _knn_radii_scanned(fake_d, n_fake, k, row_chunk)
    covered_fake, covered_real = _knn_coverage_scanned(real_d, fake_d, real_radii, fake_radii,
                                                       row_chunk)
    precision = float(covered_fake[:n_fake].cpu().numpy().mean())
    recall = float(covered_real[:n_real].cpu().numpy().mean())
    return precision, recall


def _subsample(n_rows: int, n: int, key: torch.Tensor, device) -> torch.Tensor:
    """n distinct row indices of n_rows, in random order: the JAX package's
    ``choice(key, n_rows, (n,), replace=False)``."""
    return prng.permutation(key, n_rows, device)[:n]


def _subsamples(real_rows: int, fake_rows: int, n: int, key: torch.Tensor,
                device) -> IndexPair:
    k1, k2 = prng.split(key)
    return _subsample(real_rows, n, k1, device), _subsample(fake_rows, n, k2, device)


def sinkhorn_matched_cost_subsampled(real_flat: torch.Tensor, fake_flat: torch.Tensor,
                                     n_sub: int = 4096, epsilon: float = 0.01,
                                     key: Optional[torch.Tensor] = None,
                                     indices: Optional[IndexPair] = None) -> float:
    """Estimator of the suite's Hungarian matched mean distance: entropy-
    regularized OT between uniform marginals on an ``n_sub`` subsample of
    each set, drawn without replacement (``k1, k2 = split(key)``, one per
    set). ``indices`` = (real rows, fake rows) replaces the draw."""
    n = min(n_sub, real_flat.shape[0], fake_flat.shape[0])
    dev = real_flat.device
    if indices is None:
        indices = _subsamples(real_flat.shape[0], fake_flat.shape[0], n, _key(key, 2), dev)
    cost = pairwise_l2(real_flat[_index(indices[0], dev)], fake_flat[_index(indices[1], dev)])
    return float(sinkhorn_matching_cost(cost, epsilon=epsilon))


def sinkhorn_matched_cost_repeated(real_flat: torch.Tensor, fake_flat: torch.Tensor,
                                   n_sub: int = 4096, epsilon: float = 0.01,
                                   key: Optional[torch.Tensor] = None,
                                   n_repeats: int = 5,
                                   draws: Optional[List[IndexPair]] = None,
                                   ) -> Tuple[float, float, np.ndarray]:
    """The subsampled estimator over ``n_repeats`` independent subsamples
    (repeat r's key is ``split(key, n_repeats)[r]``), one cost matrix on the
    device at a time → (mean, std, values). ``draws`` gives each repeat's
    (real rows, fake rows)."""
    if draws is not None and len(draws) != n_repeats:
        raise ValueError(f"{len(draws)} draws for {n_repeats} repeats")
    keys = prng.split(_key(key, 2), n_repeats)
    values = np.array([sinkhorn_matched_cost_subsampled(real_flat, fake_flat, n_sub, epsilon,
                                                        k, None if draws is None else draws[r])
                       for r, k in enumerate(keys)])
    return (float(values.mean()), float(values.std(ddof=1) if n_repeats > 1 else 0.0), values)


def sinkhorn_matched_cost_extrapolated(real_flat: torch.Tensor, fake_flat: torch.Tensor,
                                       n_sub: int = 4096, epsilon: float = 0.01,
                                       key: Optional[torch.Tensor] = None,
                                       n_repeats: int = 6,
                                       draws: Optional[List[IndexPair]] = None,
                                       ) -> Dict[str, float]:
    """Subsample-bias-corrected matched cost.

    The matched mean distance at subsample size n overestimates the full
    population's, and over moderate ranges it falls about linearly in
    log2(n). Each repeat solves at n_sub and at n_sub/2 on nested subsamples
    (the first half of one permutation per set, so the per-repeat slope
    cancels part of the draw noise), and the mean trend is extrapolated to
    the population. When n_sub covers the population there is nothing to
    correct and this is ``sinkhorn_matched_cost_repeated``. Repeat r draws
    with ``split(key, n_repeats)[r]``; ``draws`` gives each repeat's (real
    rows, fake rows), n_sub of each.

    Returns {"estimate", "stderr", "raw_mean", "raw_std", "slope"}."""
    pop = min(real_flat.shape[0], fake_flat.shape[0])
    n_sub = min(n_sub, pop)
    if n_sub >= pop:
        mean_n, std_n, _ = sinkhorn_matched_cost_repeated(real_flat, fake_flat, n_sub, epsilon,
                                                          key, n_repeats, draws)
        return {"estimate": mean_n, "stderr": std_n / np.sqrt(max(n_repeats, 1)),
                "raw_mean": mean_n, "raw_std": std_n, "slope": 0.0}

    dev = real_flat.device
    if draws is None:
        draws = [_subsamples(real_flat.shape[0], fake_flat.shape[0], n_sub, k, dev)
                 for k in prng.split(_key(key, 2), n_repeats)]
    elif len(draws) != n_repeats:
        raise ValueError(f"{len(draws)} draws for {n_repeats} repeats")
    fulls, slopes = [], []
    for ri, fi in draws:
        sub_r = real_flat[_index(ri, dev)]
        sub_f = fake_flat[_index(fi, dev)]
        c_full = float(sinkhorn_matching_cost(pairwise_l2(sub_r, sub_f), epsilon=epsilon))
        c_half = float(sinkhorn_matching_cost(
            pairwise_l2(sub_r[: n_sub // 2], sub_f[: n_sub // 2]), epsilon=epsilon))
        fulls.append(c_full)
        slopes.append(c_half - c_full)

    fulls, slopes = np.array(fulls), np.array(slopes)
    doublings = float(np.log2(pop / n_sub))
    estimate = fulls.mean() - slopes.mean() * doublings
    per_repeat = fulls - slopes * doublings
    stderr = per_repeat.std(ddof=1) / np.sqrt(n_repeats) if n_repeats > 1 else 0.0
    return {
        "estimate": float(estimate),
        "stderr": float(stderr),
        "raw_mean": float(fulls.mean()),
        "raw_std": float(fulls.std(ddof=1)) if n_repeats > 1 else 0.0,
        "slope": float(slopes.mean()),
    }


def evaluate_large_scale(real_gestures: np.ndarray, fake_gestures: np.ndarray, ae_params=None,
                         n_projections: int = 256, knn_k: int = 3, seed: int = 0,
                         device="cuda", draws: Optional[Dict] = None,
                         stage_seconds: Optional[Dict[str, float]] = None,
                         sinkhorn_n_sub: int = 4096,
                         sinkhorn_repeats: int = 6) -> Dict[str, float]:
    """Distribution metrics at 10⁵ scale on ``device``: sliced W2 and energy
    distance on flattened (x, y), the Sinkhorn matched cost (raw and
    extrapolated), chunked k-NN precision and recall, and FID when the
    feature autoencoder's parameters are given (features on their device).

    Draws are the JAX package's: ``k1, k2, k3 = split(PRNGKey(seed), 3)``
    for the directions, the pairs and the Sinkhorn subsamples; ``draws``
    may replace any of them: {"sinkhorn": [(real rows, fake rows)] per
    repeat, "dirs": (D, n_projections), "pairs": energy_distance's
    ``pairs``}. ``sinkhorn_n_sub`` and ``sinkhorn_repeats`` are the
    extrapolated Sinkhorn estimator's subsample size and repeats (the JAX
    package's fixed values by default). ``stage_seconds``, if given,
    receives the host seconds of "sinkhorn", "sliced_w2_energy", "knn" and
    "fid"."""
    draws = draws or {}
    stages = stage_seconds if stage_seconds is not None else {}
    n = min(len(real_gestures), len(fake_gestures))
    real_np = np.ascontiguousarray(np.asarray(real_gestures[:n, :, :2], np.float32).reshape(n, -1))
    fake_np = np.ascontiguousarray(np.asarray(fake_gestures[:n, :, :2], np.float32).reshape(n, -1))
    real_xy = torch.from_numpy(real_np).to(device)
    fake_xy = torch.from_numpy(fake_np).to(device)
    k1, k2, k3 = prng.split(prng.PRNGKey(seed), 3)

    t0 = time.perf_counter()
    sk = sinkhorn_matched_cost_extrapolated(real_xy, fake_xy, sinkhorn_n_sub, key=k3,
                                            n_repeats=sinkhorn_repeats,
                                            draws=draws.get("sinkhorn"))
    stages["sinkhorn"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = {
        "sliced_w2": float(sliced_wasserstein2(real_xy, fake_xy, n_projections, k1,
                                               draws.get("dirs"))),
        "energy_distance": float(energy_distance(real_xy, fake_xy, key=k2,
                                                 pairs=draws.get("pairs"))),
        # "sinkhorn_matched_cost" is the RAW subsample mean; the
        # bias-extrapolated estimate has its own key.
        "sinkhorn_matched_cost": sk["raw_mean"],
        "sinkhorn_matched_cost_std": sk["raw_std"],
        "sinkhorn_matched_cost_extrapolated": sk["estimate"],
        "sinkhorn_matched_cost_extrapolated_stderr": sk["stderr"],
        "n_samples": float(n),
    }
    stages["sliced_w2_energy"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    precision, recall = chunked_knn_precision_recall(real_np, fake_np, k=knn_k, device=device)
    results["precision"] = precision
    results["recall"] = recall
    stages["knn"] = time.perf_counter() - t0

    if ae_params is not None:
        from .fid import encode_features, fid_from_features

        t0 = time.perf_counter()
        real_feat = encode_features(ae_params, real_gestures[:n])
        fake_feat = encode_features(ae_params, fake_gestures[:n])
        results["fid"] = fid_from_features(real_feat, fake_feat)
        stages["fid"] = time.perf_counter() - t0
    return results
