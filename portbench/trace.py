"""What a profiled slice of a run says: the device's busy time as the union of
its operations' intervals (operations on several streams overlap, so a sum
would count time twice), device time and counts by operation name, the
longest idle gaps with what the host was doing in each, and the device
time of the host-device copies.

``reduce_events`` takes plain tuples, so the arithmetic is tested without a
device; ``from_profiler`` turns a finished ``torch.profiler.profile`` into
those tuples.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[float, float]
COPY_PREFIXES = ("Memcpy", "Memset")
NAME_CHARS = 160   # of an operation's name in the breakdown


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def gaps(busy: Sequence[Interval], start: float, end: float) -> List[Interval]:
    """The idle intervals of [start, end] outside ``busy`` (sorted, disjoint)."""
    out, t = [], start
    for s, e in busy:
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]


def _host_at(host: Sequence[Tuple[str, float, float]], t: float) -> str:
    """The innermost host operation running at time t."""
    best = None
    for name, s, e in host:
        if s <= t <= e and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0][:NAME_CHARS] if best else "host: no traced operation"


def reduce_events(device: Sequence[Tuple[str, float, float]],
                  host: Sequence[Tuple[str, float, float]], start: float, end: float,
                  top: int = 10) -> Dict:
    """``device``/``host``: (name, start_s, end_s) of each operation in the
    traced window [start, end] (seconds, one clock). Returns busy_s (the
    union of device intervals clipped to the window), window_s, the device
    operations by name {name: [count, seconds]}, kernel and copy totals,
    and the breakdown (top device operations, longest idle gaps)."""
    clipped = [(max(s, start), min(e, end)) for _, s, e in device if e > start and s < end]
    busy = union(clipped)
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for name, s, e in device:
        if e <= start or s >= end:
            continue
        by_name[name][0] += 1
        by_name[name][1] += e - s
    idle = sorted(gaps(busy, start, end), key=lambda g: g[0] - g[1])[:top]
    copies = {n: v for n, v in by_name.items() if n.startswith(COPY_PREFIXES)}
    return {
        "window_s": end - start,
        "busy_s": sum(e - s for s, e in busy),
        "ops": dict(by_name),
        "kernels": sum(v[0] for n, v in by_name.items() if n not in copies),
        "copy_s": sum(v[1] for v in copies.values()),
        "breakdown": {
            "device_ops": [[n[:NAME_CHARS], v[1]] for n, v in sorted(
                by_name.items(), key=lambda kv: -kv[1][1])[:top]],
            "idle_gaps": [[_host_at(host, (s + e) / 2), e - s] for s, e in idle],
        },
    }


def device_seconds(ops: Dict[str, List[float]], *fragments: str) -> Tuple[int, float]:
    """(launches, device seconds) of the operations whose name holds any of
    ``fragments``."""
    n, t = 0, 0.0
    for name, (count, seconds) in ops.items():
        if any(f in name for f in fragments):
            n += count
            t += seconds
    return n, t


def from_profiler(prof, span: str, outside: str = "host: no traced operation",
                  inner: tuple = ()) -> Dict:
    """``reduce_events`` of a stopped ``torch.profiler.profile`` over the
    window of the host span named ``span`` (a ``record_function`` the
    benchmark opened around the traced slice; ``inner`` names the spans it
    opened inside it); an idle gap in which the host ran no traced
    operation or inner span is labelled ``outside``."""
    from torch.autograd import DeviceType

    device, host, window = [], [], None
    for e in prof.events():
        item = (e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
        if e.device_type == DeviceType.CUDA:
            # A host span is mirrored on the device's timeline as an
            # annotation: no work of the device.
            if e.name != span and e.name not in inner \
                    and not getattr(e, "is_user_annotation", False):
                device.append(item)
        elif e.name == span:
            window = item[1:]
            host.append((outside, *item[1:]))
        elif e.device_type == DeviceType.CPU:
            host.append(item)
    if window is None:
        raise RuntimeError(f"the trace holds no span {span!r}")
    return reduce_events(device, host, *window)
