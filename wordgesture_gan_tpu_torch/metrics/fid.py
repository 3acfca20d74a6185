"""FID with a learned autoencoder feature space (the port of the JAX
package's ``metrics/fid.py``): the autoencoder is trained with L1
reconstruction on the device, the Fréchet distance is taken in float64 numpy
on the host (``fid_from_features`` is the JAX package's code, copied).
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..configs import (DEFAULT_EVALUATION_CONFIG, DEFAULT_MODEL_CONFIG, EvaluationConfig,
                       ModelConfig)
from ..models.gan import autoencoder_apply, autoencoder_encode, autoencoder_init
from ..train.state import adam_init, apply_update
from ..utils import prng
from ..utils.chunking import chunk_layout, pad_to_chunks
from ..utils.tree import tree_leaves, tree_map

_AE_ADAM_BETAS = (0.9, 0.999)


def _ae_cache_path(train_data: np.ndarray, eval_config: EvaluationConfig,
                   cache_dir: str) -> Path:
    """The cache key of the JAX package — every training hyperparameter plus
    a strided digest of the full dataset — with the port's own suffix: the
    file is a ``torch.save`` of the port's tree, where the JAX package
    pickles JAX-shaped arrays."""
    stride = max(1, len(train_data) // 64)
    h = hashlib.md5()
    h.update(repr((
        train_data.shape,
        eval_config.fid_hidden_dim,
        eval_config.fid_autoencoder_lr,
        eval_config.fid_autoencoder_epochs,
        eval_config.fid_feature_mode,
    )).encode())
    h.update(np.ascontiguousarray(train_data[::stride]).tobytes())
    return Path(cache_dir) / f".cache_fid_ae_{h.hexdigest()[:12]}.pt"


def train_fid_autoencoder(
    train_data: np.ndarray,
    model_config: ModelConfig = DEFAULT_MODEL_CONFIG,
    eval_config: EvaluationConfig = DEFAULT_EVALUATION_CONFIG,
    seed: int = 0,
    batch_size: int = 512,
    verbose: bool = True,
    device="cuda",
    perms: Optional[np.ndarray] = None,
    params: Optional[Dict] = None,
) -> Tuple[Dict, float]:
    """Train the FID feature autoencoder with L1 reconstruction and Adam for
    ``fid_autoencoder_epochs`` epochs on ``device``. Every epoch shuffles the
    data and takes one step per batch; the partial tail batch is padded and
    masked out of the loss. Returns (params, final epoch loss).

    The initial weights and each epoch's permutation are the JAX package's:
    ``key, init_key = split(PRNGKey(seed))``, the weights from ``init_key``
    (drawn on the CPU), epoch e's permutation ``permutation(split(key,
    epochs)[e], n)``. ``perms`` (epochs, n) and ``params`` (an initial tree)
    replace them."""
    device = torch.device(device)
    key, init_key = prng.split(prng.PRNGKey(seed))
    positional = eval_config.fid_feature_mode == "positional"
    if params is None:
        params = autoencoder_init(model_config, eval_config.fid_hidden_dim, positional, init_key)
    params = tree_map(lambda t: t.detach().to(device=device, dtype=torch.float32).clone()
                      .requires_grad_(True), params)
    leaves = tree_leaves(params)
    opt = adam_init(tree_map(lambda t: t.detach(), params))

    data = torch.as_tensor(np.asarray(train_data, np.float32), device=device)
    n = data.shape[0]
    epochs = eval_config.fid_autoencoder_epochs
    if perms is not None and np.shape(perms) != (epochs, n):
        raise ValueError(f"perms must be ({epochs}, {n}), got {np.shape(perms)}")
    n_batches = -(-n // batch_size)
    padded_n = n_batches * batch_size
    mask = (torch.arange(padded_n, device=device) < n).to(torch.float32)
    masks = mask.reshape(n_batches, batch_size)

    final_loss = float("nan")
    epoch_keys = prng.split(key, epochs)
    for epoch in range(epochs):
        if perms is None:
            perm = prng.permutation(epoch_keys[epoch], n, device=device)
        else:
            perm = torch.as_tensor(np.asarray(perms[epoch]), dtype=torch.long)
        index = torch.cat([perm, perm.new_zeros(padded_n - n)]).to(device)
        batches = data[index].reshape(n_batches, batch_size, *data.shape[1:])
        losses = []
        for batch, m in zip(batches, masks):
            per_elem = (autoencoder_apply(params, batch) - batch).abs().mean(dim=(1, 2))
            loss = (per_elem * m).sum() / m.sum().clamp_min(1.0)
            grads = torch.autograd.grad(loss, leaves)
            apply_update(params, grads, opt, eval_config.fid_autoencoder_lr, 0.0,
                         *_AE_ADAM_BETAS)
            losses.append(loss.detach())
        final_loss = float(torch.stack(losses).mean())
    params = tree_map(lambda t: t.detach(), params)
    if verbose:
        print(f"  FID autoencoder trained: final L1 {final_loss:.4f}")
    if final_loss > 0.1:
        mode = eval_config.fid_feature_mode
        floor = float(np.abs(train_data - np.median(train_data, axis=1, keepdims=True)).mean())
        print(
            f"  WARNING: FID feature AE reconstruction L1 {final_loss:.3f} is weak "
            f"(constant-trace floor on this data: {floor:.3f}, mode={mode!r}). "
            + ("The paper decoder has no positional signal and cannot beat that "
               "floor — its features only encode each gesture's central point, so "
               "FID comparisons are near-blind to shape/timing. Use "
               "fid_feature_mode='positional' for an informative feature space."
               if mode == "paper" else
               "FID comparisons on this feature space may be unreliable.")
        )
    return params, final_loss


def load_or_train_fid_autoencoder(
    train_data: np.ndarray,
    model_config: ModelConfig = DEFAULT_MODEL_CONFIG,
    eval_config: EvaluationConfig = DEFAULT_EVALUATION_CONFIG,
    cache_dir: Optional[str] = None,
    verbose: bool = True,
    device="cuda",
) -> Tuple[Dict, float]:
    """``train_fid_autoencoder`` behind a disk cache in ``cache_dir``."""
    cpath = _ae_cache_path(train_data, eval_config, cache_dir) if cache_dir else None
    if cpath is not None and cpath.exists():
        if verbose:
            print(f"  Loading cached FID autoencoder from {cpath}")
        cached = torch.load(cpath, map_location="cpu", weights_only=True)
        return tree_map(lambda t: t.to(device), cached["params"]), cached["final_loss"]

    params, final_loss = train_fid_autoencoder(train_data, model_config, eval_config,
                                               verbose=verbose, device=device)
    if cpath is not None:
        cpath.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"params": tree_map(lambda t: t.cpu(), params), "final_loss": final_loss},
                   cpath)
        if verbose:
            print(f"  Cached FID autoencoder to {cpath}")
    return params, final_loss


def fid_from_features(real_features, fake_features) -> float:
    """Fréchet distance between Gaussian feature fits, with the reference's
    1e-6 diagonal jitter.

    Runs in float64 numpy on the host: the covariances are tiny
    (hidden_dim², 32×32 by default) but near-singular when n is small, and
    the reference's scipy path is float64. ``ops/sqrtm.frechet_distance`` is
    the tensor variant.
    Covariances are explicitly symmetrized and the result clamped at 0: FID
    is nonnegative by definition, but for near-identical distributions the
    eigen-trace can overshoot tr(Σr)+tr(Σf) by float error (the reference's
    scipy path has the same exposure via the real-part take)."""
    real_features = np.asarray(real_features, np.float64)
    fake_features = np.asarray(fake_features, np.float64)
    dim = real_features.shape[1]
    mu_r = real_features.mean(axis=0)
    mu_f = fake_features.mean(axis=0)
    cov_r = np.cov(real_features, rowvar=False) + np.eye(dim) * 1e-6
    cov_f = np.cov(fake_features, rowvar=False) + np.eye(dim) * 1e-6
    cov_r = 0.5 * (cov_r + cov_r.T)
    cov_f = 0.5 * (cov_f + cov_f.T)

    # tr((Σr Σf)^1/2) = tr((Σr^1/2 Σf Σr^1/2)^1/2) — two symmetric eigs.
    w_r, v_r = np.linalg.eigh(cov_r)
    sqrt_r = (v_r * np.sqrt(np.maximum(w_r, 0.0))) @ v_r.T
    w = np.linalg.eigvalsh(sqrt_r @ cov_f @ sqrt_r)
    trace_sqrt = np.sum(np.sqrt(np.maximum(w, 0.0)))
    diff = mu_r - mu_f
    fid = diff @ diff + np.trace(cov_r) + np.trace(cov_f) - 2.0 * trace_sqrt
    return float(max(fid, 0.0))


@torch.no_grad()
def encode_features(params: Dict, gestures: np.ndarray, batch: int = 4096) -> np.ndarray:
    """Autoencoder features of (n, L, 3) gestures → (n, hidden) float32 on
    the host, computed in chunks on the parameters' device."""
    n = len(gestures)
    if n == 0:
        return np.zeros((0, params["post_pool"]["w"].shape[1]), np.float32)
    device = params["post_pool"]["w"].device
    batch, n_chunks = chunk_layout(n, batch)
    padded = torch.from_numpy(pad_to_chunks(gestures, batch, n_chunks)).to(device)
    out = torch.cat([autoencoder_encode(params, chunk) for chunk in padded.split(batch)])
    return out[:n].cpu().numpy()
