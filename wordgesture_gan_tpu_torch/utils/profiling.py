"""Throughput counters and the profiler hook (the port of the JAX package's
``utils/profiling.py``).

``StepTimer`` times host-clock windows whose ``stop()`` first waits for the
card, ``Throughput`` accumulates items per second and per chip (the training
loops report gestures per second through it), and ``trace_profile`` wraps a
run in ``torch.profiler``, writing a Chrome trace into a directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch


def _synchronize(tensors) -> None:
    """Wait for the devices ``tensors`` live on; with none given, for the
    current CUDA device if CUDA is in use."""
    devices = {t.device for t in tensors if torch.is_tensor(t) and t.device.type == "cuda"}
    if not tensors and torch.cuda.is_available() and torch.cuda.is_initialized():
        devices = {torch.device("cuda", torch.cuda.current_device())}
    for d in devices:
        torch.cuda.synchronize(d)


class StepTimer:
    """Host-clock timings of windows opened by entering the timer: leaving
    it records the window as is; ``stop(*tensors)`` waits for the card first
    (for the devices of ``tensors``, or the current CUDA device), so queued
    work is counted."""

    def __init__(self):
        self.times: List[float] = []
        self._start: Optional[float] = None

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._start)
        return False

    def stop(self, *sync_tensors) -> float:
        _synchronize(sync_tensors)
        dt = time.perf_counter() - self._start
        self.times.append(dt)
        return dt

    @property
    def last(self) -> float:
        return self.times[-1] if self.times else float("nan")

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


class Throughput:
    """Items per second, and per chip, over accumulated timed windows.
    ``n_chips`` defaults to the process group's world size (1 without one)."""

    def __init__(self, n_chips: Optional[int] = None):
        self.n_chips = n_chips or _world_size()
        self.items = 0
        self.seconds = 0.0

    def update(self, n_items: int, seconds: float) -> None:
        self.items += n_items
        self.seconds += seconds

    @property
    def per_sec(self) -> float:
        return self.items / self.seconds if self.seconds else float("nan")

    @property
    def per_sec_per_chip(self) -> float:
        return self.per_sec / self.n_chips

    def summary(self) -> Dict[str, float]:
        return {"items_per_sec": self.per_sec, "items_per_sec_per_chip": self.per_sec_per_chip,
                "n_chips": self.n_chips}


@contextlib.contextmanager
def trace_profile(log_dir: Optional[str]):
    """Profile the body with ``torch.profiler`` (host, and CUDA when a card
    is present) and write a Chrome trace ``trace_rank<R>_<pid>.json`` into
    ``log_dir``; a no-op without a directory. The trace names every kernel
    the body launched, the port's own included."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else 0
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f"trace_rank{rank}_{os.getpid()}.json"))
