"""Synthetic swipelog generation in the "How We Swipe" on-disk format (the
port's copy of the JAX package's ``data/synthetic.py``: the same seed writes
the same zip bytes).

The reference dataset's ``swipelogs.zip`` is a large stripped blob, so the
framework bundles a generator that synthesizes `.log` files with the exact
column layout the parser consumes (reference dataset/README.md:14-44 and
data.py:167-231), rendered in pixel space so the full pipeline — parser,
normalizer, canonical-transform fit — is exercised end-to-end.

The traces are deliberately NOT the minimum-jerk process the eval suite uses
as its baseline (that would make every eval circular — a min-jerk "baseline"
would match "real" data perfectly). Each user gets a persistent style
(speed, aim bias, sloppiness, overshoot/corner-cutting tendency, tremor),
and each trace layers non-min-jerk structure on top of the smooth base path:

* corner-cutting — interior waypoints pulled toward the straight chord;
* overshoot — sharp turns overshoot along the incoming direction first;
* correlated tremor — smoothed low-frequency wobble, not white noise;
* tempo warping — a smooth random speed profile multiplying the clock;
* mid-gesture pauses — dwell points where time advances but the finger
  doesn't;
* per-trace style jitter — each trace deviates from its user's persistent
  style (jitter_style), so same-word clusters have real-data-like spread
  and contrastive retrieval doesn't saturate;
* occasional malformed rows — the pipeline's per-file guards must earn
  their keep.

The real data's measured gap from the min-jerk model (the reference reports
a 5.29% real-vs-fitted-min-jerk centroid-distance gap) is the behavior this
stand-in is tuned to reproduce qualitatively: close to min-jerk, measurably
not it. This is a data stand-in, not part of the reference's surface;
training and eval run unchanged on the real zip when present.
"""

from __future__ import annotations

import zipfile
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..keyboard import QWERTYKeyboard, generate_minimum_jerk_trajectory

HEADER = (
    "sentence timestamp keyb_width keyb_height event x_pos y_pos x_radius y_radius "
    "angle word is_err"
)

_DEFAULT_WORDS = (
    "the and you that was for are with his they this have from one had word but what "
    "some can out other were all there when your how said each she which their time "
    "will way about many then them write would like these her long make thing see him "
    "two has look more day could come did number sound most people over know water "
    "than call first who may down side been now find any new work part take get place "
    "made live where after back little only round man year came show every good give "
    "under name very through just form sentence great think say help low line differ "
    "turn cause much mean before move right boy old too same tell does set three want "
    "air well also play small end put home read hand port large spell add even land "
    "here must big high such follow act why ask men change went light kind off need "
    "house picture try again animal point mother world near build self earth father"
).split()


def load_word_list(wordfreq_path: Optional[str] = None, max_words: int = 2000) -> List[str]:
    """Word vocabulary for synthesis: the bundled wordfreq table when
    available (``count word`` rows, ascending by count — reference
    dataset/wordfreq.txt), else a built-in common-word list. Returns the
    ``max_words`` most frequent words, most frequent first."""
    if wordfreq_path and Path(wordfreq_path).exists():
        entries = []
        with open(wordfreq_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2 and parts[0].isdigit() and len(parts[1]) >= 2 and parts[1].isalpha():
                    entries.append((int(parts[0]), parts[1].lower()))
        if entries:
            entries.sort(key=lambda e: -e[0])
            return [w for _, w in entries[:max_words]]
    return [w for w in _DEFAULT_WORDS if len(w) >= 2]


@dataclass(frozen=True)
class UserStyle:
    """Persistent per-user swiping style; every trace a user produces shares
    these parameters, so users form distinct clusters (which is what makes
    contrastive retrieval non-trivial and recall@1 < 1.0)."""

    speed: float          # duration multiplier (fast vs slow swipers)
    bias_x: float         # systematic aim offset (canonical units)
    bias_y: float
    sloppiness: float     # scales aim noise + tremor amplitude
    corner_cut: float     # 0..1: pull interior waypoints toward the chord
    overshoot: float      # overshoot magnitude at sharp turns
    pause_prob: float     # per-trace probability of a mid-gesture dwell
    tempo_wobble: float   # amplitude of the smooth speed-profile warp


def sample_user_style(rng: np.random.Generator) -> UserStyle:
    return UserStyle(
        speed=float(np.exp(rng.normal(0.0, 0.25))),
        bias_x=float(rng.normal(0.0, 0.015)),
        bias_y=float(rng.normal(0.012, 0.015)),   # most users aim slightly high
        sloppiness=float(np.exp(rng.normal(0.0, 0.4))),
        corner_cut=float(rng.beta(2.0, 5.0)),             # mean ≈ 0.29
        overshoot=float(rng.beta(2.0, 8.0) * 0.12),       # mean ≈ 0.024
        pause_prob=float(rng.beta(1.5, 10.0)),            # mean ≈ 0.13
        tempo_wobble=float(rng.uniform(0.1, 0.45)),
    )


def jitter_style(style: UserStyle, rng: np.random.Generator,
                 amount: float = 1.0) -> UserStyle:
    """Per-trace deviation around a user's persistent style.

    Real swipers are not metronomes: hand pose, attention, and fatigue vary
    between traces, so two gestures of the same word by the same user differ
    by more than sensor noise. Without this, per-word gesture clusters are
    so tight that contrastive retrieval saturates (synthetic recall@1 ≈ 0.98
    vs the reference's 95.87% on real data) and stops working as a
    regression oracle. Multiplicative lognormal on the positive knobs,
    additive on the aim bias; ``amount`` scales every deviation.
    """
    def e(s: float) -> float:
        return float(np.exp(rng.normal(0.0, s * amount)))

    return UserStyle(
        speed=style.speed * e(0.18),
        bias_x=style.bias_x + float(rng.normal(0.0, 0.010 * amount)),
        bias_y=style.bias_y + float(rng.normal(0.0, 0.010 * amount)),
        sloppiness=style.sloppiness * e(0.35),
        corner_cut=float(np.clip(style.corner_cut * e(0.45), 0.0, 0.9)),
        overshoot=style.overshoot * e(0.45),
        pause_prob=style.pause_prob,
        tempo_wobble=style.tempo_wobble * e(0.30),
    )


def _smooth_noise(rng: np.random.Generator, n: int, scale: float, half_window: int = 6) -> np.ndarray:
    """Correlated (low-frequency) 1-D noise: white noise box-filtered twice.
    Unlike white sensor jitter this survives the pipeline's arc-length
    resampling, so it measurably breaks min-jerk smoothness."""
    w = rng.normal(0.0, 1.0, n + 4 * half_window)
    k = np.ones(2 * half_window + 1) / (2 * half_window + 1)
    w = np.convolve(np.convolve(w, k, mode="same"), k, mode="same")
    w = w[2 * half_window: 2 * half_window + n]
    s = float(w.std())
    return w * (scale / s) if s > 0 else w * 0.0


def _perturb_waypoints(centers: np.ndarray, style: UserStyle,
                       rng: np.random.Generator) -> np.ndarray:
    """Apply aim bias/noise, corner-cutting, and overshoot to the key-center
    waypoints. Overshoot inserts an extra waypoint past a sharp corner along
    the incoming direction (real swipers' fingers carry momentum)."""
    pts = centers.astype(np.float64).copy()
    pts[:, 0] += style.bias_x
    pts[:, 1] += style.bias_y
    pts += rng.normal(0.0, 0.012 * style.sloppiness, pts.shape)

    # Corner-cutting: pull interior points toward their neighbors' midpoint,
    # more strongly for shallow turns (swipers straight-line through them).
    for i in range(1, len(pts) - 1):
        mid = 0.5 * (pts[i - 1] + pts[i + 1])
        pts[i] = pts[i] + style.corner_cut * rng.uniform(0.4, 1.0) * (mid - pts[i])

    # Overshoot: at sharp direction changes, go past the corner first.
    out: List[np.ndarray] = [pts[0]]
    for i in range(1, len(pts) - 1):
        v_in = pts[i] - pts[i - 1]
        v_out = pts[i + 1] - pts[i]
        ni, no = np.linalg.norm(v_in), np.linalg.norm(v_out)
        if ni > 1e-9 and no > 1e-9:
            cos = float(np.dot(v_in, v_out) / (ni * no))
            if cos < 0.3 and style.overshoot > 0:   # > ~72° turn
                out.append(pts[i] + (v_in / ni) * style.overshoot * rng.uniform(0.5, 1.5))
        out.append(pts[i])
    out.append(pts[-1])
    return np.asarray(out)


def _render_word_trace(
    keyboard: QWERTYKeyboard,
    word: str,
    rng: np.random.Generator,
    keyb_w: float,
    keyb_h: float,
    style: Optional[UserStyle] = None,
) -> Optional[np.ndarray]:
    """One trace for a word in pixel coordinates: a smooth base path through
    style-perturbed waypoints, plus correlated tremor, tempo warping, and
    optional mid-gesture pauses, with a monotone millisecond clock."""
    centers = keyboard.get_key_centers_for_word(word)
    if len(centers) < 2:
        return None
    if style is None:
        style = sample_user_style(rng)
    # Persistent style + per-trace deviation (see jitter_style): the user
    # stays recognizable, but same-user-same-word traces are not clones.
    style = jitter_style(style, rng)

    waypoints = _perturb_waypoints(np.asarray(centers), style, rng)

    n_raw = int(rng.integers(24, 96))
    traj = generate_minimum_jerk_trajectory(
        waypoints, num_points=n_raw, include_midpoints=True,
        offset_std=0.02 * style.sloppiness, rng=rng,
    ).astype(np.float64)

    # Correlated tremor (survives resampling) + white sensor jitter.
    amp = 0.008 * style.sloppiness
    traj[:, 0] += _smooth_noise(rng, n_raw, amp)
    traj[:, 1] += _smooth_noise(rng, n_raw, amp)
    traj[:, :2] += rng.normal(0, 0.004, (n_raw, 2))

    # Tempo: warp the base profile's increments by a smooth positive speed
    # wobble — the time channel is no longer the min-jerk s(t).
    dt = np.diff(traj[:, 2], prepend=0.0)
    warp = np.exp(_smooth_noise(rng, n_raw, style.tempo_wobble))
    tau = np.cumsum(np.maximum(dt * warp, 0.0))

    # Mid-gesture pause: a dwell where the clock advances but the finger
    # holds (with tremor-scale drift).
    if rng.random() < style.pause_prob and n_raw > 16:
        at = int(rng.integers(n_raw // 4, 3 * n_raw // 4))
        dwell = rng.uniform(0.08, 0.35) * tau[-1]
        n_hold = int(rng.integers(3, 7))
        hold_xy = traj[at, :2] + rng.normal(0, 0.002, (n_hold, 2))
        hold_t = tau[at] + np.linspace(0, dwell, n_hold + 1)[1:]
        # Every segment uses the WARPED clock tau — splicing the unwarped
        # min-jerk times onto the pre-pause segment would mix two time bases
        # (hold_t could then start before the last pre-pause timestamp and
        # the dwell would be flattened by the monotone clamp below).
        traj = np.concatenate([
            np.column_stack([traj[: at + 1, :2], tau[: at + 1]]),
            np.column_stack([hold_xy, hold_t]),
            np.column_stack([traj[at + 1:, :2], tau[at + 1:] + dwell]),
        ])
        tau = traj[:, 2]
    else:
        traj = np.column_stack([traj[:, :2], tau])

    total = tau[-1] if tau[-1] > 0 else 1.0
    n_pts = traj.shape[0]

    # Canonical [-1,1] → pixels. Canonical x spans ±0.9; leave a margin.
    px = (traj[:, 0] + 1.0) / 2.0 * keyb_w
    py = (traj[:, 1] + 1.0) / 2.0 * keyb_h

    # Duration 300–1200 ms scaled by the user's speed, with per-sample jitter,
    # kept monotone.
    duration = rng.uniform(300, 1200) * style.speed
    t = traj[:, 2] / total * duration
    t = np.maximum.accumulate(t + rng.normal(0, 2.0, n_pts))
    t = t - t[0]
    return np.column_stack([px, py, t])


def word_frequencies(wordfreq_path: Optional[str], words: Sequence[str]) -> Optional[np.ndarray]:
    """Sampling probabilities for ``words`` from the wordfreq table (None →
    uniform). Makes synthetic word occurrence Zipf-like, as in real logs."""
    if not (wordfreq_path and Path(wordfreq_path).exists()):
        return None
    counts = {}
    with open(wordfreq_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2 and parts[0].isdigit():
                counts[parts[1].lower()] = int(parts[0])
    weights = np.array([counts.get(w, 1) for w in words], dtype=np.float64)
    return weights / weights.sum()


def generate_log_content(
    keyboard: QWERTYKeyboard,
    words: Sequence[str],
    rng: np.random.Generator,
    n_sentences: int = 8,
    words_per_sentence: int = 5,
    keyb_w: float = 1080.0,
    keyb_h: float = 360.0,
    error_rate: float = 0.03,
    word_probs: Optional[np.ndarray] = None,
    malformed_rate: float = 0.002,
    epoch_clock: bool = True,
    sloppiness_scale: float = 1.0,
) -> str:
    """One user's `.log` file content (header + event rows). All traces share
    one sampled :class:`UserStyle`; a small fraction of rows is malformed
    (zero keyboard width / garbage fields) to exercise the pipeline's
    per-file guards the way real logs do.

    ``epoch_clock`` starts each log at a Unix-epoch-millisecond base
    (~1.6e12), as the real swipelogs do — which is what exposes the
    reference pipeline's float32-timestamp collapse (preprocess.py:40-47):
    float32 spacing at 1.6e12 is 131072 ms, so every sub-2-minute gesture's
    duration rounds to 0 there. Set False for small log-relative clocks
    (no collapse).

    ``sloppiness_scale`` multiplies the sampled user's aim-noise/tremor knob
    after sampling (so 1.0 — the default — leaves the RNG stream AND output
    byte-identical). data/realism.py measures synthetic swipers tracking
    the ideal path ~5x more closely than real ones; raising this closes
    that accuracy gap for future corpora without retuning anything else."""
    lines = [HEADER]
    clock = float(rng.integers(10_000, 50_000))
    if epoch_clock:
        # A random instant in 2020-2021, in ms — same magnitude as the real
        # "How We Swipe" logs' touch timestamps.
        clock += 1.577e12 + float(rng.integers(0, 31_536_000_000))
    style = sample_user_style(rng)
    if sloppiness_scale != 1.0:
        from dataclasses import replace as _dc_replace
        style = _dc_replace(style, sloppiness=style.sloppiness * sloppiness_scale)

    for sent_idx in range(n_sentences):
        chosen = rng.choice(len(words), size=words_per_sentence, replace=True, p=word_probs)
        for wi in chosen:
            word = words[int(wi)]
            trace = _render_word_trace(keyboard, word, rng, keyb_w, keyb_h, style)
            if trace is None:
                continue
            is_err = 1 if rng.random() < error_rate else 0
            for j, (x, y, t) in enumerate(trace):
                event = (
                    "touchstart" if j == 0
                    else "touchend" if j == len(trace) - 1
                    else "touchmove"
                )
                ts = int(clock + t)
                if event == "touchmove" and rng.random() < malformed_rate:
                    # Real logs contain corrupt rows: zero keyboard geometry
                    # or non-numeric junk. The loader must survive them.
                    if rng.random() < 0.5:
                        lines.append(
                            f"s{sent_idx} {ts} 0 0 {event} {x:.2f} {y:.2f} "
                            f"10.0 10.0 0.0 {word} {is_err}"
                        )
                    else:
                        lines.append(f"s{sent_idx} {ts} {keyb_w:.0f} corrupted")
                    continue
                lines.append(
                    f"s{sent_idx} {ts} {keyb_w:.0f} {keyb_h:.0f} {event} "
                    f"{x:.2f} {y:.2f} 10.0 10.0 0.0 {word} {is_err}"
                )
            # Inter-word interval: log-uniform over 400-2400 ms (median
            # ≈ 980 ms), matching the real corpus's per-sentence
            # good_interval_time band (p10 479 / median 1006 / p90 1858 ms,
            # dataset/stats-sentences.tsv; validated by data/realism.py).
            # Single uniform draw — same RNG-stream footprint as before, so
            # trace content is unchanged by this retune.
            clock += trace[-1, 2] + float(400.0 * 6.0 ** rng.uniform(0.0, 1.0))

    return "\n".join(lines)


def write_synthetic_swipelogs_zip(
    out_path: str,
    n_users: int = 40,
    seed: int = 0,
    wordfreq_path: Optional[str] = None,
    n_sentences: int = 8,
    words_per_sentence: int = 5,
    max_vocab: int = 500,
    epoch_clock: bool = True,
    sloppiness_scale: float = 1.0,
) -> str:
    """Write a synthetic ``swipelogs.zip`` with ``n_users`` `.log` members."""
    keyboard = QWERTYKeyboard()
    words = load_word_list(wordfreq_path, max_words=max_vocab)
    probs = word_frequencies(wordfreq_path, words)
    rng = np.random.default_rng(seed)

    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(out_path, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        for u in range(n_users):
            content = generate_log_content(
                keyboard, words, rng,
                n_sentences=n_sentences, words_per_sentence=words_per_sentence,
                word_probs=probs, epoch_clock=epoch_clock,
                sloppiness_scale=sloppiness_scale,
            )
            zf.writestr(f"user{u:04d}.log", content)
    return out_path
