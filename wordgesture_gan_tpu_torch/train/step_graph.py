"""The scanned epoch: every batch of an epoch through one train step (the
machinery of ``gan_step.gan_train_epoch`` and
``masked_step.gan_train_epoch_masked``, the counterparts of the JAX package's
``lax.scan`` epoch, ``RuntimeConfig.scan_epoch``).

On a CUDA device the step is captured once as a CUDA graph and replayed once
per batch: one launch of the whole step in place of one Python dispatch per
kernel. A replay re-runs the kernels its capture recorded, on the addresses
it recorded, so:

  * the state keeps every tensor at a fixed address: the steps update the
    parameters, the Adam moments and the critics' u vectors in place;
  * before each replay its inputs are copied into static buffers: the batch,
    and the step's keys, split off ``state["rng"]`` on the host for every
    step of the epoch up front (``step_keys``, the JAX step's own key chain)
    and copied to the device once an epoch; the step draws its noise from
    the key buffer inside the graph (``utils/prng.py``: one threefry launch
    a step), so a graphed epoch draws the numbers an eager one does; the
    learning rate once an epoch;
  * inside the graph the learning rate and each optimizer's step count are
    0-d device tensors (``state.apply_update``); the state's int counts are
    advanced on the host, by the updates a step makes times the replays;
  * the first batch of the first epoch runs eagerly on the capture stream as
    the warm-up: a real step, after which cuBLAS and cuDNN workspaces, NCCL's
    communicator and the kernels' attributes exist before the capture;
  * the launch counters of kernels 1-3, of the threefry draws, of the
    activations, of the attention, of the layer norms, of the bias adds and
    of the gradient all-reduces are bumped in Python where a wrapper
    launches, which a replay does not do: each replay adds the launches its
    capture counted.

A ``StepGraph`` captures again only when the state's tensors, the batch's
shapes or the step's configuration change. There is no eager fallback: a
capture that fails raises. On the CPU the epoch runs the same steps in a
loop. Each step's metrics land in one (n_batches, n_metrics) buffer on the
device, which the caller reads once.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..ops.activations import activation_launches
from ..ops.attention import attention_launches
from ..ops.bias import bias_launches
from ..ops.bilstm_fused import fused_bilstm_fwd
from ..ops.bilstm_train import bilstm_train_bwd, bilstm_train_fwd
from ..ops.layernorm import layernorm_launches
from ..ops.threefry import threefry_draw
from ..parallel.mesh import Mesh, all_reduce_gradients, require_capturable
from ..utils import prng
from ..utils.profiling import span
from ..utils.tree import tree_leaves
from .state import ADAM_B1, ADAM_B2, MODELS, inverse_bias_corrections

# The launch counters a replay must advance: kernels 1-3, the draws, the
# activations, the attention, the layer norms, the bias adds and the
# collectives.
COUNTED = (fused_bilstm_fwd, bilstm_train_fwd, bilstm_train_bwd, threefry_draw,
           activation_launches, attention_launches, layernorm_launches, bias_launches,
           all_reduce_gradients)

NOISE_NAMES = ("z_rand", "eps_enc", "z1", "eps_rec", "eps2", "z_ms")


def step_keys(rng: torch.Tensor, n_critic: int,
              diversity: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One train step's key chain, as the JAX step splits it: each critic
    iteration ``rng, kz, ke = split(rng, 3)``; the joint step ``rng, kz1,
    ke1, ke2 = split(rng, 4)``, then ``rng, kz_ms = split(rng)`` with the
    diversity terms. Returns (the advanced rng, the draws' keys (n, 2) in
    ``step_noise``'s order: the kz's, the ke's, kz1, ke1, ke2[, kz_ms])."""
    kz, ke = [], []
    for _ in range(n_critic):
        rng, z, e = prng.split(rng, 3)
        kz.append(z)
        ke.append(e)
    rng, kz1, ke1, ke2 = prng.split(rng, 4)
    keys = kz + ke + [kz1, ke1, ke2]
    if diversity:
        rng, kz_ms = prng.split(rng)
        keys.append(kz_ms)
    return rng, torch.stack(keys)


def step_noise(keys: torch.Tensor, batch: int, latent: int,
               n_critic: int) -> Dict[str, torch.Tensor]:
    """A step's noise from its keys (``step_keys``), all in one draw of
    (n, batch, latent) normals on the keys' device: ``z_rand`` and
    ``eps_enc`` (n_critic, B, Z), ``z1``, ``eps_rec``, ``eps2`` and, with a
    seventh key, ``z_ms`` (B, Z). Each (B, Z) normal is JAX's
    ``normal(key, (B, Z))`` (the encoder draws with ``mu.shape``)."""
    draws = prng.normal(keys, (batch, latent))
    out = {"z_rand": draws[:n_critic], "eps_enc": draws[n_critic:2 * n_critic]}
    for i, name in enumerate(NOISE_NAMES[2:2 + keys.shape[0] - 2 * n_critic]):
        out[name] = draws[2 * n_critic + i]
    return out


def step_draws(noise: Optional[Dict[str, torch.Tensor]], state: Dict, batch: int, latent: int,
               n_critic: int, diversity: bool, device) -> Dict[str, torch.Tensor]:
    """The noise a step uses: ``noise`` as injected, or drawn from
    ``noise["keys"]`` (a captured step's key buffer), or, without ``noise``,
    from keys split off ``state["rng"]`` (advancing it) and sent to
    ``device`` without a wait."""
    if noise is None:
        state["rng"], keys = step_keys(state["rng"], n_critic, diversity)
        noise = {"keys": keys}
    if "keys" not in noise:
        return noise
    keys = noise["keys"]
    if keys.device != torch.device(device):
        keys = keys.pin_memory().to(device, non_blocking=True) if device.type == "cuda" \
            else keys.to(device)
    return step_noise(keys, batch, latent, n_critic)


def launch_counts() -> list:
    """The counters of ``COUNTED`` as they stand."""
    return [(c.launches, dict(getattr(c, "launches_by_path", {}))) for c in COUNTED]


def take_back_launches(before: list) -> list:
    """What was counted since ``before`` (``launch_counts()``), set back out
    of the counters: a capture launches nothing, and each replay adds what
    it recorded (``add_launches``)."""
    after = launch_counts()
    for c, (n, by_path) in zip(COUNTED, before):
        c.launches = n
        if by_path:
            c.launches_by_path.update(by_path)
    return [(n1 - n0, {p: k - b0.get(p, 0) for p, k in b1.items()})
            for (n0, b0), (n1, b1) in zip(before, after)]


def add_launches(delta: list) -> None:
    for c, (n, by_path) in zip(COUNTED, delta):
        c.launches += n
        for path, k in by_path.items():
            c.launches_by_path[path] += k


def _state_tensors(state: Dict) -> list:
    return [t for m in MODELS for t in tree_leaves(state[m]) if torch.is_tensor(t)]


class StepGraph:
    """A train step captured as a CUDA graph, with its static inputs and
    outputs and the stream it runs on. A run keeps one across its epochs
    (``gan_loop.run_epochs``); ``run`` captures on first use and again only
    when ``signature`` changes."""

    def __init__(self) -> None:
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.signature = None
        self.captures = 0
        self.replays = 0
        self._stream = None

    def _signature(self, state: Dict, batch: Dict[str, torch.Tensor], key) -> tuple:
        return (key, tuple(t.data_ptr() for t in _state_tensors(state)),
                tuple((k, tuple(v.shape), v.dtype, v.device) for k, v in batch.items()))

    def _capture(self, step: Callable, state: Dict, batch: Dict[str, torch.Tensor],
                 noise: Dict[str, torch.Tensor], metric_keys: Sequence[str]) -> None:
        """Record ``step`` on static copies of ``batch`` and ``noise`` (the
        injected draws, or the step's keys), a device learning rate and
        device step counts, with the state's own parameters, moments and u
        vectors."""
        device = next(iter(batch.values())).device
        self._batch = {k: torch.empty_like(v) for k, v in batch.items()}
        self._noise = {k: torch.empty_like(v) for k, v in noise.items()}
        self._lr = torch.zeros((), dtype=torch.float32, device=device)
        self._counts = {m: torch.zeros((), dtype=torch.int64, device=device) for m in MODELS}
        # The bias-correction tables are built here, not during the capture,
        # which cannot record their host-to-device copy.
        inverse_bias_corrections(self._counts["g"], ADAM_B1, ADAM_B2)
        view = dict(state)
        for m in MODELS:
            view[m] = dict(state[m], opt=dict(state[m]["opt"], count=self._counts[m]))
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=self._stream):
            _, metrics = step(view, self._batch, self._lr, self._noise)
            self._metrics = torch.stack([metrics[k].reshape(()) for k in metric_keys])
        self._launches = take_back_launches(before)
        self.captures += 1

    def run(self, step: Callable, state: Dict, epoch_batches: Dict[str, torch.Tensor], lr: float,
            noise_at: Callable, traces: torch.Tensor, metric_keys: Sequence[str],
            key=None, mesh: Optional[Mesh] = None) -> None:
        """Every batch of ``epoch_batches`` (n_batches, B, ...) through ``step``
        (``step(state, batch, lr, noise)``), each step's metrics into row i of
        ``traces``; ``noise_at(i, out)`` gives step i's noise or keys (into
        ``out``'s buffers when given). The first batch warms up and the step is
        captured when there is no graph for this state, batch and ``key``;
        every other batch is a replay."""
        require_capturable(mesh)
        n = traces.shape[0]
        if n == 0:
            return
        device = traces.device
        caller = torch.cuda.current_stream(device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        self._stream.wait_stream(caller)
        with torch.cuda.stream(self._stream):
            first = {k: v[0] for k, v in epoch_batches.items()}
            start = 0
            signature = self._signature(state, first, key)
            if self.graph is None or signature != self.signature:
                # The warm-up: batch 0 eagerly, on the capture stream.
                with span("step.capture"):
                    counts = {m: state[m]["opt"]["count"] for m in MODELS}
                    noise = noise_at(0, None)
                    _, metrics = step(state, first, lr, noise)
                    traces[0].copy_(torch.stack([metrics[k].reshape(()) for k in metric_keys]))
                    self._updates = {m: state[m]["opt"]["count"] - counts[m] for m in MODELS}
                    self._capture(step, state, first, noise, metric_keys)
                    self.signature = signature
                    start = 1
            with span("epoch.steps"):
                self._lr.fill_(lr)
                for m in MODELS:
                    self._counts[m].fill_(state[m]["opt"]["count"])
                for i in range(start, n):
                    for k, v in self._batch.items():
                        v.copy_(epoch_batches[k][i])
                    noise_at(i, self._noise)
                    self.graph.replay()
                    traces[i].copy_(self._metrics)
                    add_launches(self._launches)
            for m in MODELS:
                state[m]["opt"]["count"] += (n - start) * self._updates[m]
            self.replays += n - start
        caller.wait_stream(self._stream)


def run_epoch(step: Callable, state: Dict, epoch_batches: Dict[str, torch.Tensor], lr: float,
              keys_of: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
              metric_keys: Sequence[str], noise: Optional[Dict[str, torch.Tensor]] = None,
              graph: Optional[StepGraph] = None, key=None,
              mesh: Optional[Mesh] = None) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """One epoch: ``step(state, batch, lr, noise)`` on each batch of
    ``epoch_batches`` (n_batches, B, ...), as a graph replay on a CUDA device
    (``graph``, a fresh ``StepGraph`` when None) and as a loop on the CPU.
    Step i's noise is ``noise[k][i]`` for each name, or, without ``noise``,
    drawn inside the step from its keys: ``keys_of(rng) -> (rng, keys)``
    (``step_keys``) splits every step's keys off ``state["rng"]`` on the host
    up front, and they reach the device in one copy. Returns the state, its
    epoch advanced by one, and {metric: (n_batches,) float32 trace on the
    device}."""
    n = next(iter(epoch_batches.values())).shape[0]
    device = next(iter(epoch_batches.values())).device
    traces = torch.zeros((n, len(metric_keys)), dtype=torch.float32, device=device)
    if noise is None and n:
        with span("epoch.keys"):
            keys = []
            for _ in range(n):
                state["rng"], k = keys_of(state["rng"])
                keys.append(k)
            noise = {"keys": torch.stack(keys).to(device)}

    def noise_at(i: int, out: Optional[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
        if out is None:
            return {k: v[i] for k, v in noise.items()}
        for k, v in out.items():
            v.copy_(noise[k][i])
        return out

    if device.type == "cuda":
        (graph or StepGraph()).run(step, state, epoch_batches, lr, noise_at, traces, metric_keys,
                                   key, mesh)
    else:
        with span("epoch.steps"):
            for i in range(n):
                _, metrics = step(state, {k: v[i] for k, v in epoch_batches.items()}, lr,
                                  noise_at(i, None))
                traces[i] = torch.stack([metrics[k].reshape(()) for k in metric_keys])
    state["epoch"] += 1
    return state, dict(zip(metric_keys, traces.t().contiguous()))
