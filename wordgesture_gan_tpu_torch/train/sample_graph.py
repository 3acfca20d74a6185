"""The sampling loop's chunk as a CUDA graph, and a call's data staged
through buffers kept across calls (``gan_loop.generate_gestures`` on a CUDA
device).

``sample_chunk`` is one chunk's work: its normals drawn from its key (or its
rows of the given z), scaled by the truncation, the generator's forward and
the mask multiply. On a CUDA device a ``SampleGraph`` captures it once per
chunk shape and replays it for the chunks after, on the pattern of
``step_graph.StepGraph``:

  * static buffers hold one chunk's inputs: its prototype rows, its mask rows
    (with masks) and its key (or, with z, its noise rows); before each replay
    the chunk's rows are copied into them from the call's rows on the card,
    and after it the output is copied into the call's output rows there;
  * every chunk's key (``chunk_keys``) reaches the card in one copy a call;
  * the first chunk of a new shape runs eagerly on the capture stream as the
    warm-up, a real chunk whose result is kept; then the chunk is captured;
  * a replay bumps no launch counter in Python: each replay adds the
    launches its capture counted (``step_graph.COUNTED``), so a call counts
    what the eager loop counts.

A call's rows move chunk by chunk on three streams, so that the copies and
the host's work run under the replays:

  * in: the host writes a chunk's real rows into pinned host buffers, and
    they cross to card buffers on the input stream (the last chunk's padding
    rows are zeroed there); the chunk's replay waits for them by an event;
  * out: as soon as a chunk's replay is enqueued, its real rows cross back
    into a pinned host buffer on the output stream, ordered after the replay
    by an event; once every chunk is enqueued, the host copies each chunk
    into the returned array as its copy arrives.

The pinned and card buffers grow to the largest call and are reused by the
calls after; the returned array is a new one each call.

The graphs and buffers live on the generator (``SampleGraph.of``), so they
go with it. A chunk is captured again when its rows, L, a feature width,
whether masks or z are given, a dtype, the generator's configuration or the
truncation change; all of a generator's graphs and buffers go when its
parameters' storages change (a parameter replaced or moved).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..utils import prng
from ..utils.profiling import span
from .step_graph import add_launches, launch_counts, take_back_launches


def chunk_keys(seed: int, n_chunks: int) -> torch.Tensor:
    """The keys of a sampling call's chunks, (n_chunks, 2) on the host: row c
    is ``fold_in(PRNGKey(seed), c)``, as the JAX package keys chunk c."""
    key = prng.PRNGKey(seed)
    return torch.stack([prng.fold_in(key, c) for c in range(n_chunks)])


def sample_chunk(generator: nn.Module, truncation: float, proto: torch.Tensor,
                 mask: Optional[torch.Tensor] = None, key: Optional[torch.Tensor] = None,
                 z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One chunk of ``generate_gestures``: (rows, L, 3) prototypes → (rows, L,
    3) gestures, with noise ``z`` (rows, Z) or ``normal(key, (rows, Z))``,
    times ``truncation``; zero where ``mask`` (rows, L) is 0."""
    with span("sample.noise"):
        eps = z if z is not None else prng.normal(key, (proto.shape[0],
                                                        generator.config.latent_dim))
    out = generator(proto, eps * truncation, inference=True, pad_mask=mask)
    return out if mask is None else out * mask[:, :, None]


@dataclass
class _Captured:
    graph: torch.cuda.CUDAGraph
    inputs: Dict[str, torch.Tensor]
    out: torch.Tensor
    launches: list


class SampleGraph:
    """A generator's chunk graphs, one per chunk shape, with the streams they
    and the copies run on and the staging buffers; ``captures`` and
    ``replays`` count the chunks captured and replayed."""

    def __init__(self) -> None:
        self.graphs: Dict[tuple, _Captured] = {}
        self.captures = 0
        self.replays = 0
        self._storages = None
        self._streams = None
        self._events: list = []
        # {name: (pinned host rows, card rows)}: the row arguments' and the
        # output's buffers.
        self._buffers: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    @staticmethod
    def of(generator: nn.Module) -> "SampleGraph":
        """The generator's own ``SampleGraph``, made at first use."""
        graphs = generator.__dict__.get("_sample_graph")
        if graphs is None:
            graphs = generator._sample_graph = SampleGraph()
        return graphs

    def run(self, generator: nn.Module, truncation: float, rows: Dict[str, np.ndarray],
            keys: Optional[torch.Tensor], chunk: int) -> np.ndarray:
        """Every chunk of a call: ``rows`` maps ``sample_chunk``'s row
        arguments (``proto``, and ``mask`` and ``z`` where given) to (n, ...)
        float32 host arrays, ``keys`` is ``chunk_keys``'s stack (None with
        z), and the call's n gestures come back as a new (n, L, 3) float32
        array. The first chunk is the warm-up and the chunk is captured when
        there is no graph for this shape; every other chunk is a replay."""
        storages = tuple((p.data_ptr(), p.device, p.dtype, p.shape)
                         for p in generator.parameters())
        if storages != self._storages:
            self.graphs.clear()
            self._buffers.clear()
            self._storages = storages
        device = storages[0][1]
        n, L = rows["proto"].shape[:2]
        n_chunks = -(-n // chunk)
        if self._streams is None or self._streams[0].device != device:
            self._streams = tuple(torch.cuda.Stream(device) for _ in range(3))
            self._events = []
        replay, copy_in, copy_out = self._streams
        caller = torch.cuda.current_stream(device)
        with span("sample.copy_in"):
            for stream in self._streams:
                stream.wait_stream(caller)
            staged = {k: self._staged(k, n_chunks * chunk, a.shape[1:], device)
                      for k, a in rows.items()}
            out_host, out_card = self._staged("out", n_chunks * chunk,
                                              (L, generator.config.input_dim), device)
            inputs = {k: card.unflatten(0, (n_chunks, chunk)) for k, (_, card) in staged.items()}
            if keys is not None:
                with torch.cuda.stream(copy_in):
                    inputs["key"] = keys.pin_memory().to(device, non_blocking=True)
            out = out_card.unflatten(0, (n_chunks, chunk))
            while len(self._events) < 3 * n_chunks:
                self._events.append(torch.cuda.Event())
        shape = (generator.config, truncation,
                 tuple((k, v.shape[1:], v.dtype) for k, v in inputs.items()))
        captured = self.graphs.get(shape)
        for c in range(n_chunks):
            lo, hi = c * chunk, min(c * chunk + chunk, n)
            arrived, done, back = self._events[3 * c:3 * c + 3]
            with span("sample.pad"):
                for k, (host, _) in staged.items():
                    host.numpy()[lo:hi] = rows[k][lo:hi]
            with span("sample.copy_in"), torch.cuda.stream(copy_in):
                for host, card in staged.values():
                    card[lo:hi].copy_(host[lo:hi], non_blocking=True)
                    if hi < lo + chunk:
                        card[hi:lo + chunk].zero_()
                arrived.record(copy_in)
            replay.wait_event(arrived)
            with torch.cuda.stream(replay):
                if captured is None:
                    with span("sample.capture"):
                        captured = self.graphs[shape] = self._capture(generator, truncation,
                                                                      inputs, out)
                else:
                    with span("sample.chunk"):
                        for k, v in captured.inputs.items():
                            v.copy_(inputs[k][c])
                        captured.graph.replay()
                        out[c].copy_(captured.out)
                        add_launches(captured.launches)
                        self.replays += 1
                done.record(replay)
            with span("sample.copy_out"), torch.cuda.stream(copy_out):
                copy_out.wait_event(done)
                out_host[lo:hi].copy_(out_card[lo:hi], non_blocking=True)
                back.record(copy_out)
        result = np.empty((n, L, generator.config.input_dim), np.float32)
        arrived_rows = out_host.numpy()
        for c in range(n_chunks):
            lo, hi = c * chunk, min(c * chunk + chunk, n)
            with span("sample.drain"):
                self._events[3 * c + 2].synchronize()
            with span("sample.copy_out"):
                result[lo:hi] = arrived_rows[lo:hi]
        for stream in self._streams:
            caller.wait_stream(stream)
        return result

    def _staged(self, name: str, rows: int, row_shape: tuple,
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The first ``rows`` rows of ``name``'s pinned host buffer and card
        buffer, float32 of ``row_shape``: the buffers of earlier calls where
        they hold as many rows of that shape, new ones otherwise."""
        have = self._buffers.get(name)
        if have is None or have[0].shape[0] < rows or have[0].shape[1:] != row_shape:
            have = self._buffers[name] = (
                torch.empty((rows, *row_shape), dtype=torch.float32, pin_memory=True),
                torch.empty((rows, *row_shape), dtype=torch.float32, device=device))
        return have[0][:rows], have[1][:rows]

    def _capture(self, generator: nn.Module, truncation: float, inputs: Dict[str, torch.Tensor],
                 out: torch.Tensor) -> _Captured:
        """Chunk 0 eagerly into ``out[0]``, then ``sample_chunk`` recorded on
        static copies of its inputs."""
        static = {k: v[0].clone() for k, v in inputs.items()}
        out[0].copy_(sample_chunk(generator, truncation, **static))
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._streams[0]):
            result = sample_chunk(generator, truncation, **static)
        self.captures += 1
        return _Captured(graph, static, result, take_back_launches(before))
