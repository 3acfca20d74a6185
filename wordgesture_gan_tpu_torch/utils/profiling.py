"""Throughput counters, the profiler hook and the program's spans (the port
of the JAX package's ``utils/profiling.py``, without its ``StepTimer``).

``Throughput`` accumulates items per second and per chip (the training
loops report gestures per second through it), ``trace_profile`` wraps a run
in ``torch.profiler``, writing a Chrome trace into a directory, and ``span``
names a stretch of the program's host work on the profiler's timeline and
in an in-memory table (``span_totals``) while a profiler runs.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Dict, Optional

import torch
from torch._C._autograd import _profiler_enabled


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


# {name: [count, host seconds, items]} of the spans entered while a
# profiler ran, since the last ``reset_spans``.
_SPANS: Dict[str, list] = {}


# What ``span`` returns with no profiler running: one shared object whose
# entering and leaving do nothing.
_NO_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "items", "_range", "_start")

    def __init__(self, name: str, items: int):
        self.name, self.items = name, items

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        seconds = time.perf_counter() - self._start
        # Also when the profiler stopped inside the span: the range closes
        # on no profiler, and the table keeps the span.
        self._range.__exit__(*exc)
        row = _SPANS.setdefault(self.name, [0, 0.0, 0])
        row[0] += 1
        row[1] += seconds
        row[2] += self.items
        return False


def span(name: str, items: int = 0):
    """A context manager naming the host work inside it. With a profiler
    running (``torch.profiler.profile``, ``trace_profile``) it is a
    ``record_function`` range on the profiler's timeline, and leaving it adds
    one to the span's count, its host seconds (``time.perf_counter``) and
    ``items`` to the table ``span_totals`` reads. With none it is one shared
    object that does nothing: a check of the profiler's state, well under a
    microsecond, where a ``record_function`` costs several."""
    if not _profiler_enabled():
        return _NO_SPAN
    return _Span(name, items)


def span_totals() -> Dict[str, Dict[str, float]]:
    """{name: {"count", "seconds", "items"}} of the spans entered while a
    profiler ran, since the last ``reset_spans``; a copy."""
    return {name: {"count": c, "seconds": s, "items": i} for name, (c, s, i) in _SPANS.items()}


def reset_spans() -> None:
    """Empty the table ``span_totals`` reads."""
    _SPANS.clear()
