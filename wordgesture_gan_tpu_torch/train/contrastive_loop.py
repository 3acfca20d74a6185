"""Contrastive encoder training: the SupCon step, the epoch over host-sampled
index rows, centroid-based recall, checkpoint and resume (the port of the
JAX package's ``train/contrastive_loop.py``).

The state is a plain dict::

    {"params": tree, "bn": {"bns": [{"mean", "var"}, ...]},
     "opt": {"mu": tree, "nu": tree, "count": int},
     "epoch": int, "step": int, "best_recall": float}

with the parameters as leaf tensors that require grad; each step takes
gradients with ``torch.autograd.grad`` and updates parameters and Adam
moments in place (``train/state.py:apply_update``). An epoch is one
(n_batches, N*K) index array drawn on the host (``data/contrastive.py``);
each row is gathered from the gesture store, which moves to the device once.

Data parallelism (``RuntimeConfig``, ``parallel/``): every rank draws the
same index rows and trains on its contiguous block of each global batch.
BatchNorm's moments and running statistics are the global batch's (a
differentiable all-reduce), and SupCon runs over the all-gathered embeddings
and labels, so a word's two gestures count as positives wherever they sit.
Every rank then computes the same global loss; the gather's backward sums
over ranks, so each rank differentiates 1/world_size of the loss, and one
all-reduce of one flat buffer sums the parameter gradients. Rank 0 alone
writes checkpoints and history, and every rank waits after each save.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import (DEFAULT_CONTRASTIVE_CONFIG, DEFAULT_RUNTIME_CONFIG, ContrastiveConfig,
                       RuntimeConfig)
from ..data.contrastive import ContrastiveArrays, sample_epoch_batches
from ..losses import supervised_contrastive_loss
from ..models.contrastive import contrastive_encoder_apply, contrastive_encoder_init
from ..parallel.mesh import (Mesh, all_gather_rows, all_reduce_gradients, barrier, create_mesh,
                             replicate)
from ..utils.chunking import chunk_layout, pad_to_chunks
from ..utils import prng
from ..utils.logging import log
from ..utils.preemption import PreemptionGuard
from ..utils.tree import tree_leaves, tree_map
from .checkpoint import restore_checkpoint, save_checkpoint, save_named
from .history import append_history, truncate_history
from .schedules import cosine_annealing_lr
from .state import _leaf, _state, adam_init, apply_update

# clip(1.0), then Adam with β = (0.9, 0.999), ε = 1e-8.
GRAD_CLIP, ADAM_B1, ADAM_B2 = 1.0, 0.9, 0.999


def make_contrastive_state(params: Dict, bn: Dict, device="cuda", opt: Optional[Dict] = None,
                           epoch: int = 0, step: int = 0, best_recall: float = 0.0) -> Dict:
    """A contrastive train state on ``device`` from a parameter tree and a
    BatchNorm state tree (tensors or arrays), with fresh Adam moments unless
    ``opt`` gives ``{"mu", "nu", "count"}``."""
    device = torch.device(device)
    p = tree_map(lambda t: _leaf(t, device), params)
    if opt is None:
        o = adam_init(tree_map(lambda t: t.detach(), p))
    else:
        o = {"mu": tree_map(lambda t: _state(t, device), opt["mu"]),
             "nu": tree_map(lambda t: _state(t, device), opt["nu"]), "count": int(opt["count"])}
    return {"params": p, "bn": tree_map(lambda t: _state(t, device), bn), "opt": o,
            "epoch": int(epoch), "step": int(step), "best_recall": float(best_recall)}


def init_contrastive_state(seed: int = 0, config: ContrastiveConfig = DEFAULT_CONTRASTIVE_CONFIG,
                           device="cuda") -> Dict:
    """Fresh state: weights drawn on the CPU from ``PRNGKey(seed)`` as the
    JAX package draws them, then moved to ``device``."""
    params, bn = contrastive_encoder_init(config, prng.PRNGKey(seed))
    return make_contrastive_state(params, bn, device)


def contrastive_train_step(state: Dict, batch: torch.Tensor, labels: torch.Tensor, lr: float,
                           config: ContrastiveConfig = DEFAULT_CONTRASTIVE_CONFIG,
                           mesh: Optional[Mesh] = None) -> torch.Tensor:
    """One SupCon step on a (B, L, 3) batch, in place: BatchNorm's running
    statistics advance, the gradients are clipped to global norm 1 and Adam
    updates the parameters. Returns the loss (a device scalar). With a
    process group in ``mesh``, ``batch`` and ``labels`` are the global ones
    and the step equals the single-process step on them (module docstring)."""
    if mesh is None or not mesh.active:
        emb, new_bn = contrastive_encoder_apply(state["params"], state["bn"], batch, train=True)
        loss = objective = supervised_contrastive_loss(emb, labels, config.temperature)
    else:
        n = batch.shape[0]
        local, new_bn = contrastive_encoder_apply(state["params"], state["bn"],
                                                  batch[mesh.rows(n)], train=True, mesh=mesh)
        loss = supervised_contrastive_loss(all_gather_rows(mesh, local, n), labels,
                                           config.temperature)
        objective = loss / mesh.world_size
    grads, _ = all_reduce_gradients(mesh, torch.autograd.grad(objective,
                                                              tree_leaves(state["params"])))
    apply_update(state["params"], grads, state["opt"], lr, GRAD_CLIP, b1=ADAM_B1, b2=ADAM_B2)
    state["bn"] = new_bn
    state["step"] += 1
    return loss.detach()


def contrastive_train_epoch(
    state: Dict,
    gestures: torch.Tensor,
    labels: torch.Tensor,
    batch_indices,
    lr_schedule: Tuple[float, float, int],
    config: ContrastiveConfig = DEFAULT_CONTRASTIVE_CONFIG,
    mesh: Optional[Mesh] = None,
) -> Tuple[Dict, torch.Tensor]:
    """One epoch: a step per (N*K,) index row of ``batch_indices`` into the
    device-resident ``gestures`` (N, L, 3) and ``labels`` (N,), with the
    cosine learning rate of ``lr_schedule`` = (base_lr, eta_min,
    total_steps) on the global step. Returns (state, per-step losses)."""
    base_lr, eta_min, total_steps = lr_schedule
    rows = torch.as_tensor(np.asarray(batch_indices), dtype=torch.long, device=gestures.device)
    losses = []
    for row in rows:
        lr = float(cosine_annealing_lr(base_lr, min(state["step"], total_steps), total_steps,
                                       eta_min))
        losses.append(contrastive_train_step(state, gestures[row], labels[row], lr, config, mesh))
    state["epoch"] += 1
    out = torch.stack(losses) if losses else gestures.new_zeros((0,))
    return state, out


@torch.no_grad()
def embed_gestures(state: Dict, gestures: np.ndarray,
                   config: ContrastiveConfig = DEFAULT_CONTRASTIVE_CONFIG,
                   batch: int = 4096) -> np.ndarray:
    """Eval-mode embeddings of (n, L, 3) gestures → (n, embedding_dim)
    float32 on the host, in zero-padded chunks on the parameters' device."""
    n = len(gestures)
    if n == 0:
        return np.zeros((0, config.embedding_dim), np.float32)
    device = state["params"]["proj"][1]["w"].device
    batch, n_chunks = chunk_layout(n, batch)
    padded = torch.from_numpy(pad_to_chunks(gestures, batch, n_chunks)).to(device)
    out = torch.cat([contrastive_encoder_apply(state["params"], state["bn"], chunk,
                                               train=False)[0]
                     for chunk in padded.split(batch)])
    return out[:n].cpu().numpy()


def centroid_recall(embeddings: np.ndarray, words: List[str],
                    k_values: Sequence[int] = (1, 5, 10)) -> Dict[str, float]:
    """Centroid-based recall@k: per-word mean embeddings, renormalized, then
    whether each gesture's own word is among its top-k centroids."""
    unique = list(dict.fromkeys(words))
    word_idx = {w: i for i, w in enumerate(unique)}
    ids = np.array([word_idx[w] for w in words])
    n_words = len(unique)

    emb = torch.as_tensor(np.asarray(embeddings, np.float32))
    ids_t = torch.from_numpy(ids)
    seg = emb.new_zeros((n_words, emb.shape[1])).index_add_(0, ids_t, emb)
    counts = emb.new_zeros((n_words,)).index_add_(0, ids_t, emb.new_ones((len(words),)))
    centroids = seg / counts[:, None]
    centroids = centroids / (torch.linalg.vector_norm(centroids, dim=1, keepdim=True) + 1e-12)

    sim = (emb @ centroids.T).numpy()                       # (n, n_words)
    max_k = min(max(k_values), n_words)
    topk = np.argsort(-sim, axis=1)[:, :max_k]

    results = {}
    for k in k_values:
        hit = (topk[:, :min(k, max_k)] == ids[:, None]).any(axis=1)
        results[f"recall@{k}"] = float(hit.mean())
    results["accuracy"] = results["recall@1"]
    return results


def train_contrastive(
    train_data: ContrastiveArrays,
    test_data: ContrastiveArrays,
    config: ContrastiveConfig = DEFAULT_CONTRASTIVE_CONFIG,
    runtime_config: RuntimeConfig = DEFAULT_RUNTIME_CONFIG,
    num_epochs: Optional[int] = None,
    seed: int = 42,
    checkpoint_dir: Optional[str] = None,
    checkpoint_name: str = "contrastive_latest",
    resume: bool = True,
    eval_every: int = 5,
    verbose: bool = True,
    device="cuda",
) -> Tuple[Dict, Dict[str, list]]:
    """A full contrastive training run on ``device``, over the ranks of the
    process group if there is one, with best-recall checkpoints → (state,
    history).

    Per epoch: index rows from ``random.Random(seed * 1_000_003 + epoch)``
    (a resumed run draws what an unbroken one would), one step per row, a
    history line; every ``eval_every`` epochs and after the last, recall@k
    of the test words' centroids, and on a new best recall@1 the snapshot
    ``epoch_{N}.pt`` (``latest.pt`` untouched) and ``<checkpoint_name>.pt``.
    A first SIGTERM/SIGINT stops cleanly after the epoch in flight with both
    snapshots written; ``<checkpoint_name>.pt`` is written at the end. With
    ``resume`` the run continues from ``<checkpoint_name>.pt``, else from
    the newest ``epoch_N.pt``. ``history`` holds "train_loss", "test_<metric>"
    per evaluation, and "epoch_seconds" (host clock, ending when the epoch's
    losses reached the host)."""
    num_epochs = num_epochs or config.num_epochs
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available; pass device='cpu' "
                           "to train on the CPU")
    mesh = create_mesh(runtime_config.data_axis_size, runtime_config.mesh_axis_names, device)
    say = log if verbose and mesh.is_main else (lambda *_: None)
    writes = checkpoint_dir if mesh.is_main else None
    if mesh.active:
        say(f"Data parallel: {mesh.world_size} rank(s) on axis {mesh.axis_names}")

    state = init_contrastive_state(seed, config, device)
    start_epoch = 0
    name = f"{checkpoint_name}.pt"
    if resume and checkpoint_dir and restore_checkpoint(state, checkpoint_dir, name) is not None:
        start_epoch = state["epoch"]
        if writes:
            truncate_history(checkpoint_dir, start_epoch)
        say(f"Resumed contrastive training from epoch {start_epoch}")
    replicate(mesh, state)

    g_dev = torch.as_tensor(np.asarray(train_data.gestures, np.float32), device=device)
    l_dev = torch.as_tensor(np.asarray(train_data.labels, np.int64), device=device)
    n_batches = len([w for w in train_data.unique_words
                     if len(train_data.word_to_indices[w]) >= config.gestures_per_word]
                    ) // config.batch_words
    schedule = (config.learning_rate, config.eta_min, num_epochs * max(n_batches, 1))

    history: Dict[str, list] = {"train_loss": [], "epoch_seconds": []}
    best_recall = state["best_recall"]
    with PreemptionGuard() as preempt:
        for epoch in range(start_epoch, num_epochs):
            sampler_rng = random.Random(seed * 1_000_003 + epoch)
            batch_idx = sample_epoch_batches(train_data, config.batch_words,
                                             config.gestures_per_word, sampler_rng)
            t0 = time.perf_counter()
            state, losses = contrastive_train_epoch(state, g_dev, l_dev, batch_idx, schedule,
                                                    config, mesh)
            avg_loss = float(losses.mean().item()) if len(losses) else float("nan")
            dt = time.perf_counter() - t0
            history["train_loss"].append(avg_loss)
            history["epoch_seconds"].append(dt)
            append_history(writes, epoch, {"train_loss": avg_loss})
            say(f"Epoch {epoch + 1}/{num_epochs} [{dt:.1f}s] loss: {avg_loss:.4f}")

            if (epoch + 1) % eval_every == 0 or epoch == num_epochs - 1:
                emb = embed_gestures(state, test_data.gestures, config)
                metrics = centroid_recall(emb, test_data.words)
                for key, val in metrics.items():
                    history.setdefault(f"test_{key}", []).append(val)
                say("Evaluation: " + " | ".join(f"{k}: {v:.4f}" for k, v in metrics.items()))
                if metrics["recall@1"] > best_recall:
                    best_recall = metrics["recall@1"]
                    state["best_recall"] = best_recall
                    if checkpoint_dir:
                        _save(state, writes, epoch, checkpoint_name, mesh)
                    say(f"New best recall@1: {best_recall:.4f}")

            if preempt.agreed(mesh):
                if checkpoint_dir:
                    _save(state, writes, epoch, checkpoint_name, mesh)
                say(f"Preemption signal received — stopped cleanly after epoch {epoch + 1}; "
                    f"rerun to resume.")
                break

    if checkpoint_dir:
        _save(state, writes, None, checkpoint_name, mesh)
    return state, history


def _save(state: Dict, writes: Optional[str], epoch: Optional[int], name: str,
          mesh: Mesh) -> None:
    """Rank 0 writes ``epoch_{epoch+1}.pt`` (unless ``epoch`` is None) and
    ``<name>.pt``; every rank waits until both are whole."""
    if writes:
        if epoch is not None:
            save_checkpoint(state, writes, epoch, keep_latest=False)
        save_named(state, writes, name)
    barrier(mesh)
