"""How far the synthetic corpus is from the real "How We Swipe" data (the
port's own copy of the JAX package's ``data/realism.py``).

The real gesture logs are not in the repository, but the dataset's published
per-sentence aggregates are (``dataset/stats-sentences.tsv``: medians of
swipe time, length and DTW to the prototype, inter-word intervals and WPM,
with ``dataset/metadata.tsv`` for each user's screen width). This module
recomputes the same per-sentence statistics from a synthetic
``swipelogs_*.zip`` and reports where each synthetic median falls inside the
real distribution.

Comparable statistics (length-like quantities are normalized by keyboard
width so a 1080 px synthetic keyboard compares against 360-412 px phones):

* ``time_ms``      — median swipe time per good word (ms)
* ``length_w``     — median swipe path length / keyboard width
* ``interval_ms``  — median inter-word interval (ms)
* ``wpm_swipe``    — words / total minute, including intervals
* ``dtw_w``        — median DTW cost to the ideal key-center trajectory,
                     / keyboard width. Approximate on the real side: the
                     published costs sum point distances over the alignment
                     path, whose length the aggregates do not record; both
                     sides are renormalized to a per-step cost with an
                     estimated 60 Hz event rate for the real traces.

The corpus-wide DTW is one batched ``ops.dtw.dtw_pairs`` call over (trace,
prototype) pairs resampled to 64 points of (x, y): the CUDA kernel
``csrc/dtw.cu`` on the card, its plain version on the CPU.

Usage::

    python -m wordgesture_gan_tpu_torch.data.realism [--zip PATH] [--users N]
        [--device cuda|cpu] [--save-stats PATH.npz]

It exits 1 when an exact statistic's synthetic median falls outside the real
[p10, p90] band, 0 otherwise.
"""

from __future__ import annotations

import argparse
import csv
import math
import zipfile
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..keyboard import QWERTYKeyboard
from ..utils.logging import log

_DATASET_DIR = Path(__file__).resolve().parent.parent.parent / "dataset"

#: statistic name -> (real column, is_exactly_comparable)
STATS = ("time_ms", "length_w", "interval_ms", "wpm_swipe", "dtw_w")

# Assumed touch-event rate of the real logs, for renormalizing the published
# DTW sums to a per-step cost (reference logs show ~8-25 ms between
# touchmoves, i.e. 40-120 Hz; 60 Hz is the typical browser frame clock).
_REAL_EVENT_HZ = 60.0


# ---------------------------------------------------------------------------
# Real side: published per-sentence aggregates
# ---------------------------------------------------------------------------

def _load_screen_widths(metadata_tsv: Path) -> Dict[str, float]:
    widths: Dict[str, float] = {}
    with open(metadata_tsv, newline="") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            try:
                widths[row["uid"]] = float(row["screen_width"])
            except (KeyError, ValueError):
                continue
    return widths


def load_real_sentence_stats(
    stats_tsv: Optional[Path] = None,
    metadata_tsv: Optional[Path] = None,
) -> Dict[str, np.ndarray]:
    """Per-sentence statistic arrays from the published aggregates.

    Returns ``{stat_name: 1-D float array}`` over all sentences with valid
    entries for that statistic. Length-like stats are divided by the user's
    screen width (the rendered keyboard width on the study's mobile layout).
    """
    stats_tsv = stats_tsv or _DATASET_DIR / "stats-sentences.tsv"
    metadata_tsv = metadata_tsv or _DATASET_DIR / "metadata.tsv"
    widths = _load_screen_widths(metadata_tsv)

    out: Dict[str, List[float]] = {k: [] for k in STATS}
    with open(stats_tsv, newline="") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            w = widths.get(row.get("username", ""))

            def val(col: str) -> float:
                try:
                    v = float(row.get(col, "nan"))
                except ValueError:
                    return math.nan
                return v

            t = val("good_time")
            if math.isfinite(t) and t > 0:
                out["time_ms"].append(t)
            if w:
                l = val("good_length")
                if math.isfinite(l) and l > 0:
                    out["length_w"].append(l / w)
            iv = val("good_interval_time")
            if math.isfinite(iv) and iv > 0:
                out["interval_ms"].append(iv)
            wpm = val("good_wpm_swipe")
            if math.isfinite(wpm) and wpm > 0:
                out["wpm_swipe"].append(wpm)
            d = val("good_dtw")
            if w and math.isfinite(d) and d > 0 and math.isfinite(t) and t > 0:
                # Per-alignment-step cost: the published value sums over the
                # alignment path, whose length ~ the touch-event count
                # ~ time * event rate.
                n_est = max(t / 1000.0 * _REAL_EVENT_HZ, 3.0)
                out["dtw_w"].append(d / n_est / w)

    return {k: np.asarray(v, dtype=np.float64) for k, v in out.items()}


# ---------------------------------------------------------------------------
# Synthetic side: recompute the same statistics from raw logs
# ---------------------------------------------------------------------------

def _resample_polyline(pts: np.ndarray, n: int) -> np.ndarray:
    """Arc-length-uniform resampling of an (m, 2) polyline to n points."""
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    total = s[-1]
    if total <= 0:
        return np.repeat(pts[:1], n, axis=0)
    grid = np.linspace(0.0, total, n)
    x = np.interp(grid, s, pts[:, 0])
    y = np.interp(grid, s, pts[:, 1])
    return np.column_stack([x, y])


#: fixed resampling length for the batched DTW-to-prototype computation
_DTW_POINTS = 64


@dataclass
class _WordEntry:
    word: str
    t_start: float
    t_end: float
    length_px: float
    dtw_idx: int                # index into the batched DTW pair list, or -1
    n_points: int


def _scan_log_sentences(
    content: str,
    keyboard: QWERTYKeyboard,
    prototype_cache: Dict[Tuple[str, float, float], Optional[np.ndarray]],
    dtw_batch: Optional[List[Tuple[np.ndarray, np.ndarray]]],
) -> List[List[_WordEntry]]:
    """Group one log's good (is_err == 0) word gestures by sentence, with
    per-word time span and path length. When ``dtw_batch`` is given, each
    word's (trace, ideal-prototype) pair — both arc-length-resampled to
    ``_DTW_POINTS`` — is appended to it for one batched ``ops.dtw.dtw_pairs``
    call by the caller."""
    sentences: Dict[str, List[_WordEntry]] = {}
    cur_word = ""
    cur_sentence = ""
    pts: List[Tuple[float, float, float]] = []
    kb_w = kb_h = 0.0

    def flush() -> None:
        nonlocal cur_word, pts
        if cur_word and len(pts) >= 3 and kb_w > 0:
            arr = np.asarray(pts, dtype=np.float64)
            xy = arr[:, :2]
            length = float(np.linalg.norm(np.diff(xy, axis=0), axis=1).sum())
            dtw_idx = -1
            if dtw_batch is not None:
                key = (cur_word, kb_w, kb_h)
                if key not in prototype_cache:
                    centers = keyboard.get_key_centers_for_word(cur_word)
                    proto = None
                    if len(centers) >= 2:
                        c = np.asarray(centers, dtype=np.float64)
                        px = (c[:, 0] + 1.0) / 2.0 * kb_w
                        py = (c[:, 1] + 1.0) / 2.0 * kb_h
                        proto = _resample_polyline(
                            np.column_stack([px, py]), _DTW_POINTS)
                    prototype_cache[key] = proto
                proto = prototype_cache[key]
                if proto is not None:
                    dtw_idx = len(dtw_batch)
                    dtw_batch.append((_resample_polyline(xy, _DTW_POINTS), proto))
            sentences.setdefault(cur_sentence, []).append(_WordEntry(
                cur_word, arr[0, 2], arr[-1, 2], length, dtw_idx, len(arr)))
        cur_word = ""
        pts = []

    for line in content.strip().split("\n")[1:]:
        parts = line.split()
        if len(parts) < 12:
            continue
        try:
            if int(parts[11]) == 1:
                continue
            word = parts[10].lower()
            if len(word) <= 1:
                continue
            event = parts[4]
            x, y, t = float(parts[5]), float(parts[6]), float(int(parts[1]))
            if event == "touchstart":
                flush()
                cur_word = word
                cur_sentence = parts[0]
                kb_w, kb_h = float(parts[2]), float(parts[3])
                pts = [(x, y, t)]
            elif event == "touchmove" and cur_word:
                pts.append((x, y, t))
            elif event == "touchend" and cur_word:
                pts.append((x, y, t))
                flush()
        except (ValueError, IndexError):
            continue
    flush()

    # keyboard width is per-log-constant in practice; keep entries grouped
    return [v for v in sentences.values() if v]


def synthetic_sentence_stats(
    zip_path: str,
    max_users: Optional[int] = None,
    compute_dtw: bool = True,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Recompute the published per-sentence statistics from a (synthetic)
    swipelogs zip: medians over each sentence's good words, as the dataset's
    README defines them.

    All DTW-to-prototype costs across the whole corpus run as ONE batched
    ``ops.dtw.dtw_pairs`` call on ``device`` over (trace, prototype) pairs
    arc-length-resampled to ``_DTW_POINTS``."""
    keyboard = QWERTYKeyboard()
    proto_cache: Dict[Tuple[str, float, float], Optional[np.ndarray]] = {}
    dtw_batch: Optional[List[Tuple[np.ndarray, np.ndarray]]] = (
        [] if compute_dtw else None)
    out: Dict[str, List[float]] = {k: [] for k in STATS}
    # (kb_w, per-sentence kept entries), resolved after the batched DTW
    pending: List[Tuple[float, List[_WordEntry]]] = []

    with zipfile.ZipFile(zip_path) as zf:
        names = sorted(n for n in zf.namelist() if n.endswith(".log"))
        if max_users is not None:
            names = names[:max_users]
        for name in names:
            content = zf.read(name).decode("utf-8", errors="replace")
            # Every synthetic log renders one keyboard width; read it from
            # the first well-formed row for the length normalization.
            kb_w = None
            for line in content.split("\n")[1:]:
                p = line.split()
                if len(p) >= 12:
                    try:
                        w = float(p[2])
                    except ValueError:
                        continue
                    if w > 0:
                        kb_w = w
                        break
            if not kb_w:
                continue
            for entries in _scan_log_sentences(content, keyboard, proto_cache,
                                               dtw_batch):
                times = np.array([e.t_end - e.t_start for e in entries])
                ok = times > 0
                if not ok.any():
                    continue
                times = times[ok]
                kept = [e for e, o in zip(entries, ok) if o]
                out["time_ms"].append(float(np.median(times)))
                out["length_w"].append(
                    float(np.median([e.length_px for e in kept])) / kb_w)
                # Inter-word intervals: touchend of word i -> touchstart of i+1.
                ivs = [b.t_start - a.t_end for a, b in zip(kept, kept[1:])
                       if b.t_start > a.t_end]
                if ivs:
                    out["interval_ms"].append(float(np.median(ivs)))
                total_ms = float(times.sum() + sum(ivs))
                if total_ms > 0:
                    out["wpm_swipe"].append(len(kept) / (total_ms / 60000.0))
                if compute_dtw:
                    pending.append((kb_w, kept))

    if compute_dtw and dtw_batch:
        import torch

        from ..ops.dtw import dtw_pairs
        device = torch.device(device)
        traces = torch.from_numpy(np.stack([t for t, _ in dtw_batch]).astype(np.float32))
        protos = torch.from_numpy(np.stack([p for _, p in dtw_batch]).astype(np.float32))
        costs = dtw_pairs(traces.to(device), protos.to(device)).cpu().numpy().astype(np.float64)
        for kb_w, kept in pending:
            vals = [costs[e.dtw_idx] / _DTW_POINTS for e in kept
                    if e.dtw_idx >= 0]
            if vals:
                out["dtw_w"].append(float(np.median(vals)) / kb_w)

    return {k: np.asarray(v, dtype=np.float64) for k, v in out.items()}


# ---------------------------------------------------------------------------
# Comparison report
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StatComparison:
    stat: str
    real_median: float
    real_p10: float
    real_p90: float
    syn_median: float
    inside_band: bool
    approximate: bool


def compare_to_real(
    syn: Dict[str, np.ndarray],
    real: Optional[Dict[str, np.ndarray]] = None,
) -> List[StatComparison]:
    """Where does each synthetic median fall inside the real per-sentence
    distribution? ``dtw_w`` is flagged approximate (event-rate renormalized,
    see module docstring); the rest are unit-exact."""
    real = real if real is not None else load_real_sentence_stats()
    rows: List[StatComparison] = []
    for stat in STATS:
        r, s = real.get(stat), syn.get(stat)
        if r is None or s is None or len(r) == 0 or len(s) == 0:
            continue
        p10, p50, p90 = (float(np.percentile(r, q)) for q in (10, 50, 90))
        sm = float(np.median(s))
        rows.append(StatComparison(
            stat=stat, real_median=p50, real_p10=p10, real_p90=p90,
            syn_median=sm, inside_band=bool(p10 <= sm <= p90),
            approximate=(stat == "dtw_w")))
    return rows


def format_report(rows: Sequence[StatComparison]) -> str:
    lines = [
        "Synthetic-vs-real realism report (per-sentence medians)",
        f"{'stat':<12} {'real p10':>10} {'real med':>10} {'real p90':>10} "
        f"{'synthetic':>10}  verdict",
        "-" * 68,
    ]
    for r in rows:
        verdict = "inside" if r.inside_band else "OUTSIDE"
        if r.approximate:
            verdict += " (approx metric)"
        lines.append(
            f"{r.stat:<12} {r.real_p10:>10.3f} {r.real_median:>10.3f} "
            f"{r.real_p90:>10.3f} {r.syn_median:>10.3f}  {verdict}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Synthetic-vs-real realism report")
    ap.add_argument("--zip", default=None,
                    help="synthetic swipelogs zip, generated there if missing (default: "
                         "dataset/synthetic_swipelogs_<users>.zip)")
    ap.add_argument("--users", type=int, default=200,
                    help="users to generate / scan (default 200)")
    ap.add_argument("--no-dtw", action="store_true",
                    help="skip the (slow, approximate) DTW statistic")
    ap.add_argument("--sloppiness-scale", type=float, default=1.0,
                    help="aim-noise/tremor multiplier for a freshly generated "
                         "corpus (explore closing the measured ~5x accuracy "
                         "gap; forces generation to a scale-suffixed zip)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the batched DTW; 'cpu' runs its plain version")
    ap.add_argument("--save-stats", type=str, default=None,
                    help="write the per-sentence statistics to this .npz")
    args = ap.parse_args(argv)
    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda but no CUDA device is available; pass --device cpu")

    zip_path = args.zip
    if zip_path is None:
        suffix = ("" if args.sloppiness_scale == 1.0
                  else f"_slop{args.sloppiness_scale:g}")
        zip_path = str(_DATASET_DIR /
                       f"synthetic_swipelogs_{args.users}{suffix}.zip")
    if not Path(zip_path).exists():
        from .synthetic import write_synthetic_swipelogs_zip
        log(f"Generating synthetic swipelogs ({args.users} users) at {zip_path}")
        wf = _DATASET_DIR / "wordfreq.txt"
        write_synthetic_swipelogs_zip(
            zip_path, n_users=args.users, seed=7,
            wordfreq_path=str(wf) if wf.exists() else None,
            n_sentences=12, words_per_sentence=6,
            sloppiness_scale=args.sloppiness_scale)

    log(f"Scanning {zip_path}")
    syn = synthetic_sentence_stats(zip_path, max_users=args.users,
                                   compute_dtw=not args.no_dtw, device=args.device)
    if args.save_stats:
        np.savez(args.save_stats, **syn)
    rows = compare_to_real(syn)
    print(format_report(rows))
    exact_outside = [r.stat for r in rows if not r.inside_band and not r.approximate]
    if exact_outside:
        print(f"\nExact stats outside the real [p10, p90] band: {exact_outside}")
        return 1
    print("\nAll exact stats inside the real [p10, p90] band.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
