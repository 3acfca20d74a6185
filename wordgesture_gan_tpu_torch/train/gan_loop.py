"""The GAN training loop and batched sampling from the generator (the port
of the JAX package's ``train/gan_loop.py``: ``train_gan`` and
``generate_gestures``), with the epoch loop the variable-length trainer
shares (``run_epochs``).

Data parallelism (``RuntimeConfig``, ``parallel/``): in a process group each
rank holds the whole training set on its card, draws the same epoch
permutation and the same noise, and trains on its rows of each global batch
(``gan_step.py``); rank 0 alone writes the run metadata, the history, the log
and the checkpoints, and every rank waits at a barrier after each save, so a
resume on any rank reads a whole checkpoint.

``RuntimeConfig.scan_epoch`` runs each epoch through the scanned epoch
(``gan_step.gan_train_epoch``, ``masked_step.gan_train_epoch_masked``): on a
CUDA device one captured CUDA graph of the step, replayed once per batch and
kept for the whole run; everything around the epoch is the same.

Under a profiler the stages of an epoch and of a sampling call are spans
(``utils/profiling.span``): ``epoch.shuffle``, ``epoch.keys`` and
``epoch.steps`` (``step_graph.py``), ``step.capture``, ``epoch.losses``,
``epoch.record``, ``epoch.callback``, ``epoch.checkpoint``; and
``sample.call`` around a sampling call's. The host's staging is in three,
disjoint from the chunk loop's ``sample.chunk`` (one a chunk, with
``sample.noise`` inside on the CPU):

  * ``sample.copy_in``: the generator moved (where it is not on the device
    already) and the chunks' keys; on a CUDA device also the buffers and the
    keys' copy once a call, and a chunk's copies to the card enqueued, once
    a chunk;
  * ``sample.pad``: off the card, the rows zero-padded to whole chunks once
    a call; on a CUDA device a chunk's rows written into pinned buffers,
    once a chunk;
  * ``sample.copy_out``: off the card, the result cropped once a call; on a
    CUDA device a chunk's copy back enqueued, and its rows copied into the
    result once they are back, each once a chunk.

On a CUDA device ``sample.chunk`` is a replay, ``sample.capture`` a new chunk
shape's warm-up chunk and capture (with ``sample.noise`` inside), and
``sample.drain`` the wait for a chunk's copy back, once a chunk."""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import (DEFAULT_MODEL_CONFIG, DEFAULT_RUNTIME_CONFIG, DEFAULT_TRAINING_CONFIG,
                       ModelConfig, RuntimeConfig, TrainingConfig)
from ..data.pipeline import GestureArrays, within_word_diversity
from ..models.gan import Generator
from ..models.layers import jax_products
from ..utils import prng
from ..utils.chunking import chunk_layout, pad_to_chunks
from ..parallel.mesh import barrier, create_mesh, is_main_process, replicate
from ..utils.preemption import PreemptionGuard
from ..utils.profiling import Throughput, span
from .checkpoint import restore_checkpoint, save_checkpoint, save_run_metadata
from .gan_step import METRIC_KEYS, gan_train_epoch, gan_train_step, shuffle_batches
from .history import append_history, truncate_history
from .sample_graph import SampleGraph, chunk_keys, sample_chunk
from .schedules import cosine_annealing_lr
from .state import MODELS, init_gan_state
from .step_graph import StepGraph


@dataclass
class TrainResult:
    state: Dict
    history: List[Dict[str, float]] = field(default_factory=list)
    # Wall seconds of each epoch this run trained (host clock, from before
    # the epoch's shuffle until its losses reached the host), and the
    # gestures it trained on.
    epoch_seconds: List[float] = field(default_factory=list)
    gestures_per_epoch: int = 0
    # Gestures per second over the run's epochs, and per chip (n_chips: the
    # ranks of the data axis).
    throughput: Throughput = field(default_factory=lambda: Throughput(1))


# The losses each epoch's log line shows, as (label, metric).
_LOG_FIELDS = (("D1", "d1_loss"), ("D2", "d2_loss"), ("C1", "cycle1_total"),
               ("C2", "cycle2_total"))


def train_gan(
    train_ds: GestureArrays,
    model_config: ModelConfig = DEFAULT_MODEL_CONFIG,
    training_config: TrainingConfig = DEFAULT_TRAINING_CONFIG,
    runtime_config: RuntimeConfig = DEFAULT_RUNTIME_CONFIG,
    num_epochs: Optional[int] = None,
    seed: int = 42,
    checkpoint_dir: Optional[str] = None,
    resume: bool = True,
    epoch_callback: Optional[Callable[[int, Dict, Dict[str, float]], None]] = None,
    verbose: bool = True,
    device="cuda",
) -> TrainResult:
    """Train the two-cycle GAN on ``train_ds`` on ``device``, over the ranks
    of the process group if there is one (``runtime_config.data_axis_size``).

    Per epoch: the cosine learning rate, a seeded shuffle with drop-last,
    one ``gan_train_step`` per batch (with ``runtime_config.scan_epoch``,
    ``gan_train_epoch``: on a CUDA device one captured CUDA graph of the
    step, replayed per batch), the epoch's mean losses (a non-finite
    one aborts the run before anything is written; an epoch with no batch
    records every loss at 0.0), a history line, a log line with gestures/s,
    ``epoch_callback(epoch, state, losses)``, and a checkpoint every
    ``save_every`` epochs and after the last. With ``resume`` and a
    checkpoint in ``checkpoint_dir`` the run continues after the saved
    epoch. A first SIGTERM/SIGINT stops cleanly after the epoch in flight,
    with a checkpoint; in a process group every rank stops on the same epoch.
    ``epoch_callback`` runs on rank 0 only."""
    say = print if verbose and is_main_process() else (lambda *_: None)
    if training_config.lambda_div and training_config.div_margin is None:
        margin = within_word_diversity(train_ds)
        training_config = dataclasses.replace(training_config, div_margin=margin)
        say(f"Diversity hinge margin measured from data: {margin:.4f} (mean within-word L1)")
    arrays = {"gesture": train_ds.gestures, "prototype": train_ds.prototypes}
    return run_epochs(
        arrays, lambda s, b, lr, mesh: gan_train_step(s, b, lr, model_config, training_config,
                                                      mesh=mesh),
        lambda s, eb, lr, mesh, graph: gan_train_epoch(s, eb, lr, model_config, training_config,
                                                       mesh=mesh, graph=graph),
        METRIC_KEYS, _LOG_FIELDS, model_config, training_config, runtime_config, num_epochs,
        seed, checkpoint_dir, resume, epoch_callback, say, device)


def run_epochs(arrays: Dict[str, np.ndarray], step: Callable, scanned_epoch: Callable,
               metric_keys: Sequence[str], log_fields: Sequence[Tuple[str, str]],
               model_config: ModelConfig, training_config: TrainingConfig,
               runtime_config: RuntimeConfig, num_epochs: Optional[int], seed: int,
               checkpoint_dir: Optional[str], resume: bool, epoch_callback: Optional[Callable],
               say: Callable, device) -> TrainResult:
    """The epoch loop ``train_gan`` and ``train_variable_gan`` share:
    ``arrays`` (the training set, one (n, ...) array per batch key) move to
    ``device`` once, and ``step(state, batch, lr, mesh)`` runs once per
    global batch, returning the metrics ``metric_keys`` names; with
    ``runtime_config.scan_epoch``, ``scanned_epoch(state, epoch_batches, lr,
    mesh, graph)`` runs the epoch instead, with one ``StepGraph`` for the
    whole run."""
    num_epochs = num_epochs or training_config.num_epochs
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available; pass device='cpu' "
                           "to train on the CPU")
    mesh = create_mesh(runtime_config.data_axis_size, runtime_config.mesh_axis_names, device)
    if not mesh.is_main:
        say = lambda *_: None   # noqa: E731
    writes = checkpoint_dir if mesh.is_main else None
    if mesh.active:
        say(f"Data parallel: {mesh.world_size} rank(s) on axis {mesh.axis_names}")
    data = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in arrays.items()}

    state = init_gan_state(seed, model_config, device)
    start_epoch = 0
    if checkpoint_dir:
        if writes:
            save_run_metadata(checkpoint_dir, generator_type=model_config.generator_type,
                              time_head=model_config.time_head,
                              gen_hidden_dim=model_config.gen_hidden_dim)
        if resume and restore_checkpoint(state, checkpoint_dir) is not None:
            start_epoch = state["epoch"]
            if writes:
                truncate_history(checkpoint_dir, start_epoch)
            say(f"Resumed from checkpoint at epoch {start_epoch}")
    replicate(mesh, {m: state[m] for m in MODELS})   # the key is the same on every rank
    if start_epoch >= num_epochs:
        say(f"Already trained to epoch {start_epoch}, nothing to do.")
        return TrainResult(state=state, throughput=Throughput(mesh.world_size))

    B = training_config.batch_size
    n_batches = next(iter(data.values())).shape[0] // B
    result = TrainResult(state=state, gestures_per_epoch=n_batches * B,
                         throughput=Throughput(mesh.world_size))
    graph = StepGraph() if runtime_config.scan_epoch else None
    with PreemptionGuard() as preempt:
        for epoch in range(start_epoch, num_epochs):
            t0 = time.perf_counter()
            with span("epoch.shuffle"):
                lr = float(cosine_annealing_lr(training_config.learning_rate, epoch, num_epochs,
                                               training_config.lr_scheduler_eta_min))
                batches = shuffle_batches(prng.fold_in(prng.PRNGKey(seed ^ 0x5EED), epoch), data,
                                          B)
            if graph is not None:
                _, traces = scanned_epoch(state, batches, lr, mesh, graph)
            else:
                steps: Dict[str, List[torch.Tensor]] = {k: [] for k in metric_keys}
                with span("epoch.steps"):
                    for i in range(n_batches):
                        _, metrics = step(state, {k: v[i] for k, v in batches.items()}, lr, mesh)
                        for k in metric_keys:
                            steps[k].append(metrics[k])
                traces = {k: torch.stack(v) for k, v in steps.items() if v}
            with span("epoch.losses"):
                if n_batches:
                    # One host transfer per epoch; it waits for the device.
                    means = torch.stack([traces[k].mean() for k in metric_keys])
                    losses = dict(zip(metric_keys, means.cpu().tolist()))
                else:
                    # No batch (fewer samples than batch_size, drop-last):
                    # every loss at 0.0, as in the JAX package, not a
                    # non-finite trip.
                    losses = dict.fromkeys(metric_keys, 0.0)
            dt = time.perf_counter() - t0
            with span("epoch.record"):
                state["epoch"] = epoch + 1
                losses["lr"] = lr
                bad = [k for k, v in losses.items() if not np.isfinite(v)]
                if bad:
                    raise FloatingPointError(f"Non-finite losses at epoch {epoch + 1}: {bad}. "
                                             f"Last good checkpoint is in {checkpoint_dir!r}.")
                result.history.append(losses)
                result.epoch_seconds.append(dt)
                result.throughput.update(result.gestures_per_epoch, dt)
                append_history(writes, epoch, losses)
                say(f"Epoch {epoch + 1}/{num_epochs} [{dt:.1f}s, "
                    f"{result.gestures_per_epoch / max(dt, 1e-9):.0f} gestures/s] - "
                    + " ".join(f"{label}:{losses[k]:.3f}" for label, k in log_fields)
                    + f" LR:{lr:.6f}")
            if epoch_callback is not None and mesh.is_main:
                with span("epoch.callback"):
                    epoch_callback(epoch, state, losses)

            with span("epoch.checkpoint"):
                saved = False
                if checkpoint_dir and ((epoch + 1) % training_config.save_every == 0
                                       or epoch == num_epochs - 1):
                    _save(state, writes, epoch, mesh)
                    say(f"  Checkpoint saved at epoch {epoch + 1}")
                    saved = True
                if preempt.agreed(mesh):
                    if checkpoint_dir and not saved:
                        _save(state, writes, epoch, mesh)
                    say(f"Preemption signal received — stopped cleanly after epoch "
                        f"{epoch + 1}; rerun to resume.")
                    break
    say(f"Training done: {result.throughput.per_sec:.0f} gestures/s "
        f"({result.throughput.per_sec_per_chip:.0f}/chip over {mesh.world_size} chip(s))")
    return result


def _save(state: Dict, writes: Optional[str], epoch: int, mesh) -> None:
    """Rank 0 writes the checkpoint; every rank waits until it is whole."""
    if writes:
        save_checkpoint(state, writes, epoch)
    barrier(mesh)


@jax_products()
def generate_gestures(generator: Generator, prototypes: np.ndarray,
                      config: ModelConfig = DEFAULT_MODEL_CONFIG, truncation: float = 1.0,
                      seed: int = 0, batch: int = 512, device="cuda",
                      z: Optional[np.ndarray] = None,
                      masks: Optional[np.ndarray] = None) -> np.ndarray:
    """Sample one gesture per prototype: (n, L, 3) prototypes → (n, L, 3)
    float32, with z ~ N(0, 1)·truncation; a new array each call.

    The prototypes are cut into power-of-two chunks of at most ``batch`` rows
    (``utils/chunking.py``, the JAX package's layout), the last one
    zero-padded, and the generator runs once per chunk on ``device``, through
    the inference kernel (``sample_graph.sample_chunk``; on a CUDA device a
    replay of the chunk's CUDA graph, with the rows staged through buffers
    kept across calls: ``sample_graph.SampleGraph``). Chunk c draws its
    noise as the JAX package does, ``normal(fold_in(PRNGKey(seed), c),
    (chunk, Z))``, on ``device``. ``z`` (n, Z), if given, replaces those
    draws (it is still scaled by ``truncation``).

    ``masks`` (n, L), 1 = valid, if given, reach the generator as its
    padding mask (the transformer's), and the output is zeroed where a mask
    is 0; padding rows of a chunk get an all-zero mask.

    ``config`` must be the generator's own configuration; the generator is
    moved to ``device``."""
    n = len(prototypes)
    if n == 0:
        return np.zeros((0, *np.shape(prototypes)[1:]), np.float32)
    if config != generator.config:
        raise ValueError("config differs from the generator's own configuration")
    if z is not None and np.shape(z) != (n, config.latent_dim):
        raise ValueError(f"z must be ({n}, {config.latent_dim}), got {np.shape(z)}")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    chunk, n_chunks = chunk_layout(n, batch)
    # sample_chunk's row arguments, (n, ...) on the host.
    rows = {k: np.asarray(a, np.float32)
            for k, a in (("proto", prototypes), ("z", z), ("mask", masks)) if a is not None}
    with span("sample.call", items=n):
        with span("sample.copy_in"):
            # A generator already on the device is left as it is: ``.to``
            # walks every parameter, a fixed cost of each call.
            if any(p.device != device for p in generator.parameters()):
                generator = generator.to(device)
            keys = chunk_keys(seed, n_chunks) if z is None else None
        with torch.inference_mode():
            if device.type == "cuda":
                return SampleGraph.of(generator).run(generator, truncation, rows, keys, chunk)
            return _sample_eagerly(generator, truncation, rows, keys, chunk, n_chunks, device)


def _sample_eagerly(generator: Generator, truncation: float, rows: Dict[str, np.ndarray],
                    keys: Optional[torch.Tensor], chunk: int, n_chunks: int,
                    device: torch.device) -> np.ndarray:
    """``generate_gestures`` off the card: the rows zero-padded to whole
    chunks, and each chunk run eagerly."""
    with span("sample.pad"):
        # Every input as (n_chunks, ...): a row a chunk.
        inputs = {k: torch.from_numpy(pad_to_chunks(a, chunk, n_chunks)).to(device)
                  .unflatten(0, (n_chunks, chunk)) for k, a in rows.items()}
        if keys is not None:
            inputs["key"] = keys.to(device)
    out = []
    for c in range(n_chunks):
        with span("sample.chunk"):
            out.append(sample_chunk(generator, truncation, **{k: v[c] for k, v in inputs.items()}))
    with span("sample.copy_out"):
        return torch.cat(out)[:len(rows["proto"])].cpu().numpy().copy()
