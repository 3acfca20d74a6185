"""The data-parallel axis and the collectives the train steps need (the port
of the JAX package's ``parallel/mesh.py``).

The JAX package lays a 1-D ``data`` mesh over its devices and lets XLA insert
the collectives of a sharded step. Here the axis is the ranks of a
``torch.distributed`` process group, one process per card, and the steps call
the collectives themselves:

  * a batch is cut into contiguous ceil-division blocks, one per rank
    (``shard_batch``), the JAX package's layout;
  * the state is broadcast from rank 0 once, after init or restore
    (``replicate``), and stays replicated because every rank applies the same
    update;
  * each gradient computation ends in ONE all-reduce of one flat buffer
    (``all_reduce_gradients``), never one per parameter leaf; the step's
    metrics ride in the same buffer;
  * BatchNorm's moments go through a differentiable all-reduce
    (``all_reduce_sum``) and the contrastive embeddings through a
    differentiable all-gather (``all_gather_rows``).

A ``Mesh`` without a process group (the default single-process run) makes
every function here return its input untouched, launching nothing.

A train step captured as a CUDA graph (``RuntimeConfig.scan_epoch``,
``train/step_graph.py``) takes its all-reduces into the graph under NCCL;
gloo's collectives run on the host and cannot be captured
(``require_capturable``).

``packed_replicate`` (one host-to-device transfer per dtype through a remote
TPU link), ``batch_sharding`` and ``replicated`` (XLA sharding annotations)
have no counterpart here.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class Mesh:
    """The data axis: ``world_size`` ranks of ``group`` (None: one process,
    no collectives), this process's ``rank`` and the ``device`` it computes on."""

    world_size: int = 1
    rank: int = 0
    group: Optional[object] = None
    device: Optional[torch.device] = None
    axis_names: Tuple[str, ...] = ("data",)

    @property
    def active(self) -> bool:
        """True when collectives run (a process group exists, even of one rank)."""
        return self.group is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's contiguous block of ``n`` rows (ceil division)."""
        per = -(-n // self.world_size)
        return slice(min(self.rank * per, n), min((self.rank + 1) * per, n))


SINGLE = Mesh()


def create_mesh(data_axis_size: int = -1, axis_names: Tuple[str, ...] = ("data",),
                device=None) -> Mesh:
    """The data axis over the ranks of the current process group, or a
    single-process ``Mesh`` when there is none. ``data_axis_size`` -1 takes
    every rank; any other value must equal the world size (1 without a
    group): a run starts as many processes as it has ranks."""
    device = torch.device(device) if device is not None else None
    if not dist.is_initialized():
        if data_axis_size not in (-1, 1):
            raise ValueError(f"data_axis_size={data_axis_size} needs that many processes in a "
                             f"process group: start them with torchrun or the CLIs' "
                             f"--data-axis-size")
        return Mesh(device=device, axis_names=tuple(axis_names))
    world = dist.get_world_size()
    if data_axis_size not in (-1, world):
        raise ValueError(f"data_axis_size={data_axis_size} but the process group has "
                         f"{world} ranks")
    return Mesh(world_size=world, rank=dist.get_rank(), group=dist.group.WORLD, device=device,
                axis_names=tuple(axis_names))


def _mesh(mesh: Optional[Mesh]) -> Mesh:
    return SINGLE if mesh is None else mesh


def shard_batch(mesh: Optional[Mesh], tree, batch_axis: int = 0):
    """This rank's rows of every tensor or array of ``tree`` along
    ``batch_axis`` (views; the whole tree without a process group)."""
    mesh = _mesh(mesh)
    if not mesh.active:
        return tree

    def take(x):
        rows = mesh.rows(x.shape[batch_axis])
        if rows.stop <= rows.start:
            raise ValueError(f"a batch of {x.shape[batch_axis]} rows leaves rank {mesh.rank} "
                             f"of {mesh.world_size} none")
        return x[(slice(None),) * batch_axis + (rows,)]

    return tree_map(take, tree)


global_shard = shard_batch


@torch.no_grad()
def replicate(mesh: Optional[Mesh], tree):
    """Overwrite every tensor of ``tree`` with rank 0's values, in place: one
    broadcast of one flat buffer per (device, dtype). Returns ``tree``."""
    mesh = _mesh(mesh)
    if not mesh.active:
        return tree
    groups = {}
    for t in tree_leaves(tree):
        if torch.is_tensor(t):
            groups.setdefault((t.device, t.dtype), []).append(t)
    for leaves in groups.values():
        flat = torch.cat([t.detach().reshape(-1) for t in leaves])
        dist.broadcast(flat, src=0, group=mesh.group)
        for t, part in zip(leaves, flat.split([t.numel() for t in leaves])):
            t.copy_(part.view_as(t))
    return tree


global_replicate = replicate


def all_reduce_gradients(mesh: Optional[Mesh], grads: Sequence[torch.Tensor],
                         extra: Optional[torch.Tensor] = None
                         ) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
    """Sum each rank's gradient contributions, and ``extra`` (the step's
    metrics, each rank's share of them), in one all-reduce of one flat
    buffer. Each rank passes gradients already weighted by its share of the
    global objective, so the sum is the global gradient.
    ``all_reduce_gradients.launches`` counts the all-reduces. Without a
    process group: the inputs, untouched. A replay of a captured step adds
    the all-reduces its capture counted (``train/step_graph.py``)."""
    mesh = _mesh(mesh)
    if not mesh.active:
        return list(grads), extra
    parts = [g.reshape(-1) for g in grads]
    if extra is not None:
        parts.append(extra.reshape(-1).to(parts[0].dtype))
    flat = torch.cat(parts)
    dist.all_reduce(flat, group=mesh.group)
    all_reduce_gradients.launches += 1
    sizes = [p.numel() for p in parts]
    pieces = flat.split(sizes)
    out = [p.view_as(g) for p, g in zip(pieces, grads)]
    return out, (pieces[-1].view_as(extra) if extra is not None else None)


all_reduce_gradients.launches = 0


def require_capturable(mesh: Optional[Mesh]) -> None:
    """Raise ValueError unless the step's collectives can be captured into a
    CUDA graph: no process group, or an NCCL one (gloo's run on the host)."""
    mesh = _mesh(mesh)
    if mesh.active:
        backend = dist.get_backend(mesh.group)
        if backend != "nccl":
            raise ValueError(f"scan_epoch on a CUDA device captures the train step as a CUDA "
                             f"graph, which the {backend!r} backend's collectives cannot join; "
                             f"train under an NCCL process group, or without scan_epoch")


class _SumRanks(torch.autograd.Function):
    """Sum over ranks; the backward sums the incoming gradients over ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum over ranks (its backward sums the gradients over
    ranks too); ``x`` itself without a process group."""
    mesh = _mesh(mesh)
    if not mesh.active:
        return x
    return _SumRanks.apply(x, mesh.group)


def all_gather_rows(mesh: Optional[Mesh], x: torch.Tensor, n: int) -> torch.Tensor:
    """The global (n, ...) batch from every rank's block ``x`` (its rows
    ``mesh.rows(n)``), differentiably: each rank places its block among
    zeros and ``all_reduce_sum`` adds them (adding zeros is exact; uneven
    blocks need no padding, and gloo takes CUDA tensors for an all-reduce,
    not for an all-gather). The backward sums over ranks: when every rank
    computes the same loss of the gathered batch, each must take
    1/world_size of it for the summed gradient to be the loss's."""
    mesh = _mesh(mesh)
    if not mesh.active:
        return x
    rows = mesh.rows(n)
    placed = torch.cat([x.new_zeros((rows.start, *x.shape[1:])), x,
                        x.new_zeros((n - rows.stop, *x.shape[1:]))])
    return all_reduce_sum(mesh, placed)


def max_over_ranks(mesh: Optional[Mesh], flag: bool) -> bool:
    """True if ``flag`` is true on any rank (a collective every rank must reach)."""
    mesh = _mesh(mesh)
    if not mesh.active:
        return flag
    device = mesh.device if dist.get_backend(mesh.group) == "nccl" else torch.device("cpu")
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(t.item())


def is_main_process() -> bool:
    """True unless this process is a rank other than 0 of a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait until every rank gets here (nothing without a process group)."""
    mesh = _mesh(mesh)
    if mesh.active:
        if dist.get_backend(mesh.group) == "nccl":
            dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
        else:
            dist.barrier(group=mesh.group)


@contextlib.contextmanager
def main_rank_first(device=None) -> Iterator[None]:
    """Run the body on rank 0 first, then on the other ranks (for work that
    writes a shared cache, such as generating and parsing the corpus); a
    plain block without a process group."""
    if not dist.is_initialized():
        yield
        return
    mesh = create_mesh(device=device)
    if not mesh.is_main:
        barrier(mesh)
    yield
    if mesh.is_main:
        barrier(mesh)
