"""Joining a data-parallel run: one process per card, one ``torch.distributed``
process group (the port of the JAX package's ``parallel/distributed.py``).

A run is data-parallel when its environment says so: torchrun's variables
(``WORLD_SIZE`` > 1 with ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``), or ``WGG_DISTRIBUTED=1``, which asks for a process group
even at world size 1. Without either, every entry point runs in one process
with no process group, and nothing in ``parallel/`` launches anything.

``maybe_init_distributed`` joins the group: NCCL for CUDA devices, gloo for
the CPU; each rank binds to ``cuda:LOCAL_RANK % device_count``. The backend
is a library argument only (a test may ask for gloo on the card, where NCCL
refuses two ranks on one GPU); no environment variable picks it, and a CUDA
run that cannot join NCCL raises instead of falling back.

``local_ranks`` is what the CLIs' ``--data-axis-size N`` does on one host
without torchrun: the calling process becomes rank 0 and starts ranks
1..N-1 as copies of the same command.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import socket
import subprocess
import sys
from pathlib import Path
from typing import Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

_INITIALIZED = False
_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
_PACKAGE_ROOT = Path(__file__).resolve().parent.parent.parent


def distributed_env_requested() -> bool:
    """True when the environment asks for a process group: ``WORLD_SIZE`` > 1
    (torchrun, or ``local_ranks``), or ``WGG_DISTRIBUTED=1``."""
    if os.environ.get("WGG_DISTRIBUTED") == "1":
        return True
    n = os.environ.get("WORLD_SIZE")
    return n is not None and n.isdigit() and int(n) > 1


def free_port() -> int:
    """A TCP port on localhost that nothing listens on right now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device="cuda") -> torch.device:
    """The device this process computes on: ``cuda:LOCAL_RANK % device_count``
    for CUDA, the CPU otherwise."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available")
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    return torch.device("cuda", local % torch.cuda.device_count())


def maybe_init_distributed(device="cuda", backend: Optional[str] = None, verbose: bool = True,
                           timeout: Optional[float] = None) -> bool:
    """Join the process group the environment asks for; True when this
    process is (now) part of one. Idempotent; without the environment it
    returns False and imports nothing else.

    ``backend`` defaults to NCCL for a CUDA ``device`` and gloo for the CPU.
    ``timeout`` (seconds) bounds every collective of the group, so a rank
    that dies makes the others raise instead of waiting forever."""
    global _INITIALIZED
    if _INITIALIZED or dist.is_initialized():
        _INITIALIZED = True
        return True
    if not distributed_env_requested():
        return False
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ.get("MASTER_PORT")
    if port is None:
        if world > 1:
            raise RuntimeError("WORLD_SIZE > 1 needs MASTER_ADDR and MASTER_PORT (torchrun sets "
                               "them; so does the CLIs' --data-axis-size)")
        port = str(free_port())
    device = rank_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device    # eager NCCL init: a failure raises here
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", world_size=world,
                            rank=rank, **kwargs)
    _INITIALIZED = True
    if verbose and rank == 0:
        print(f"Distributed: {world} rank(s) over {backend}, rank {rank} on {device}", flush=True)
    return True


def shutdown_distributed() -> None:
    """Leave the process group (if any)."""
    global _INITIALIZED
    if dist.is_initialized():
        dist.destroy_process_group()
    _INITIALIZED = False


def process_local_batch_slice(global_batch: int) -> slice:
    """The rows of a global batch this process trains on: contiguous
    ceil-division blocks in rank order (the last may be short or empty), the
    JAX package's layout. Without a process group: the whole batch."""
    n = dist.get_world_size() if _INITIALIZED else 1
    i = dist.get_rank() if _INITIALIZED else 0
    per = -(-global_batch // n)
    return slice(min(i * per, global_batch), min((i + 1) * per, global_batch))


@contextlib.contextmanager
def local_ranks(world_size: int, module: str, argv: Sequence[str],
                timeout: Optional[float] = None) -> Iterator[List[subprocess.Popen]]:
    """Run the body as rank 0 of ``world_size`` local ranks: ranks 1..N-1 are
    ``python -m module *argv`` with torchrun's variables set, and this
    process gets the same variables (restored afterwards) for rank 0. On
    leaving, the other ranks are waited for (``timeout`` seconds) and a
    failed one raises; if the body raises, they are killed. The process
    group, if the body joined one, is left."""
    base = {"WORLD_SIZE": str(world_size), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(free_port())}
    path = os.pathsep.join(p for p in (str(_PACKAGE_ROOT), os.environ.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen([sys.executable, "-m", module, *argv],
                              env={**os.environ, **base, "RANK": str(r), "LOCAL_RANK": str(r),
                                   "PYTHONPATH": path})
             for r in range(1, world_size)]
    saved = {k: os.environ.get(k) for k in _ENV}
    os.environ.update(base, RANK="0", LOCAL_RANK="0")
    try:
        yield procs
        failed = [(r, p.wait(timeout=timeout)) for r, p in enumerate(procs, start=1)]
        failed = [(r, rc) for r, rc in failed if rc != 0]
        if failed:
            raise RuntimeError(f"local ranks failed (rank, exit code): {failed}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutdown_distributed()
