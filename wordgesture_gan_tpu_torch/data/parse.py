"""Swipelog parser: raw "How We Swipe" `.log` text → per-word touch traces.

Behavior-equivalent to the reference parser (the port's copy of the JAX
package's ``data/parse.py``)
but returns compact numpy arrays per gesture instead of lists of dicts:
each gesture is a (n_points, 3) float64 array of (x, y, t_ms) plus the
keyboard (width, height) captured at touchstart.

Log format (reference dataset/README.md:14-44), whitespace-separated columns:
  0 sentence  1 timestamp  2 keyb_width  3 keyb_height  4 event
  5 x_pos     6 y_pos      7 x_radius    8 y_radius     9 angle
  10 word     11 is_err
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple


class RawGesture(NamedTuple):
    points: "object"            # (n, 3) float64 numpy array: x, y, t_ms
    keyb_width: float
    keyb_height: float


def parse_log_file(log_content: str) -> Dict[str, List[RawGesture]]:
    """Parse one swipelog into word → list of raw gestures.

    State machine over touchstart/touchmove/touchend events; skips
    error-flagged rows (is_err == 1), single-letter words, and gestures with
    fewer than 3 points; words are lowercased. Malformed lines are dropped
    (reference data.py:183-229).
    """
    import numpy as np

    gestures_by_word: Dict[str, List[RawGesture]] = {}
    word: str = ""
    pts: List[Tuple[float, float, float]] = []
    kb_w = kb_h = 0.0

    for line in log_content.strip().split("\n")[1:]:      # skip header row
        parts = line.split()
        if len(parts) < 12:
            continue
        try:
            event = parts[4]
            if int(parts[11]) == 1:                        # error gesture
                continue
            raw_word = parts[10]
            if len(raw_word) <= 1:                         # single-letter word
                continue
            x, y = float(parts[5]), float(parts[6])
            t = int(parts[1])

            if event == "touchstart":
                # Word is committed before the keyboard-dim parse, matching
                # the reference's statement order (data.py:205-210).
                word = raw_word.lower()
                kb_w, kb_h = float(parts[2]), float(parts[3])
                pts = [(x, y, t)]
            elif event == "touchmove" and word:
                # The reference parses keyboard dims on every event row while
                # building the point dict — a malformed value drops the line
                # (data.py:211-216).
                float(parts[2]), float(parts[3])
                pts.append((x, y, t))
            elif event == "touchend" and word and pts:
                float(parts[2]), float(parts[3])
                pts.append((x, y, t))
                if len(pts) >= 3:
                    gestures_by_word.setdefault(word, []).append(
                        RawGesture(np.array(pts, dtype=np.float64), kb_w, kb_h)
                    )
                word = ""
                pts = []
        except (ValueError, IndexError):
            continue

    return gestures_by_word
