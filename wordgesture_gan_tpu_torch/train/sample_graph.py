"""The sampling loop's chunk as a CUDA graph (``gan_loop.generate_gestures``
on a CUDA device).

``sample_chunk`` is one chunk's work: its normals drawn from its key (or its
rows of the given z), scaled by the truncation, the generator's forward and
the mask multiply. On a CUDA device a ``SampleGraph`` captures it once per
chunk shape and replays it for the chunks after, on the pattern of
``step_graph.StepGraph``:

  * static buffers hold one chunk's inputs: its prototype rows, its mask rows
    (with masks) and its key (or, with z, its noise rows); before each replay
    the chunk's rows are copied into them from the call's arrays on the
    card, and after it the output is copied into the call's output buffer;
  * every chunk's key (``chunk_keys``) reaches the card in one copy a call,
    so nothing in the loop waits for the card;
  * the first chunk of a new shape runs eagerly on the capture stream as the
    warm-up, a real chunk whose result is kept; then the chunk is captured;
  * a replay bumps no launch counter in Python: each replay adds the
    launches its capture counted (``step_graph.COUNTED``), so a call counts
    what the eager loop counts.

The graphs live on the generator (``SampleGraph.of``), so they go with it. A
chunk is captured again when its rows, L, a feature width, whether masks or
z are given, a dtype, the generator's configuration or the truncation change;
all of a generator's graphs go when its parameters' storages change (a
parameter replaced or moved).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

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
    """A generator's chunk graphs, one per chunk shape, with the stream they
    run on; ``captures`` and ``replays`` count the chunks captured and
    replayed."""

    def __init__(self) -> None:
        self.graphs: Dict[tuple, _Captured] = {}
        self.captures = 0
        self.replays = 0
        self._storages = None
        self._stream = None

    @staticmethod
    def of(generator: nn.Module) -> "SampleGraph":
        """The generator's own ``SampleGraph``, made at first use."""
        graphs = generator.__dict__.get("_sample_graph")
        if graphs is None:
            graphs = generator._sample_graph = SampleGraph()
        return graphs

    def run(self, generator: nn.Module, truncation: float, inputs: Dict[str, torch.Tensor],
            out: torch.Tensor) -> None:
        """Every chunk of a call: ``inputs`` maps ``sample_chunk``'s tensor
        arguments to (n_chunks, ...) tensors on the card, a row a chunk, and
        chunk c's gestures land in ``out[c]`` (n_chunks, rows, L, 3). The
        first chunk is the warm-up and the chunk is captured when there is no
        graph for this shape; every other chunk is a replay."""
        storages = tuple((p.data_ptr(), p.device, p.dtype, p.shape)
                         for p in generator.parameters())
        if storages != self._storages:
            self.graphs.clear()
            self._storages = storages
        shape = (generator.config, truncation,
                 tuple((k, v.shape[1:], v.dtype) for k, v in inputs.items()))
        device = out.device
        caller = torch.cuda.current_stream(device)
        if self._stream is None or self._stream.device != device:
            self._stream = torch.cuda.Stream(device)
        self._stream.wait_stream(caller)
        with torch.cuda.stream(self._stream):
            start = 0
            captured = self.graphs.get(shape)
            if captured is None:
                with span("sample.capture"):
                    captured = self.graphs[shape] = self._capture(generator, truncation,
                                                                  inputs, out)
                start = 1
            for c in range(start, out.shape[0]):
                with span("sample.chunk"):
                    for k, v in captured.inputs.items():
                        v.copy_(inputs[k][c])
                    captured.graph.replay()
                    out[c].copy_(captured.out)
                    add_launches(captured.launches)
            self.replays += out.shape[0] - start
        caller.wait_stream(self._stream)

    def _capture(self, generator: nn.Module, truncation: float, inputs: Dict[str, torch.Tensor],
                 out: torch.Tensor) -> _Captured:
        """Chunk 0 eagerly into ``out[0]``, then ``sample_chunk`` recorded on
        static copies of its inputs."""
        static = {k: v[0].clone() for k, v in inputs.items()}
        out[0].copy_(sample_chunk(generator, truncation, **static))
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._stream):
            result = sample_chunk(generator, truncation, **static)
        self.captures += 1
        return _Captured(graph, static, result, take_back_launches(before))
