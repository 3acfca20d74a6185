"""The readings a cell's limits are set from, in one process: for each seed
the numbers the program's run gives against the reference (the lower
readings), and for the first ``--controls`` seeds the numbers the control
gives (the reference with float8 products in the program's place) and, for
a training cell, two planted faults of half of each batch left out: in the
program's replays alone (``half_batch_replays``: the step sound on its
first call, the eager warm-up, and halved from its second, the capture, so
in every replay the window times), and in the reference at every step
(``half_batch``). Not run by the benchmark; see PERF.md for the limits set
from it.

    python3 portbench/calibrate.py --workload flagship.train --seeds 101 102 ... --controls 3
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.kinds import generate, train  # noqa: E402


def half_batch(step, sound_calls: int = 0):
    """``step`` with a planted fault: from its call ``sound_calls + 1`` on,
    it sees the first half of its batch only, the mean taken over that."""
    calls = [0]

    def broken(state, batch, *args, **kwargs):
        calls[0] += 1
        if calls[0] <= sound_calls:
            return step(state, batch, *args, **kwargs)
        half = next(iter(batch.values())).shape[0] // 2
        return step(state, {k: v[:half] for k, v in batch.items()}, *args, **kwargs)
    return broken


STEPS = (("wordgesture_gan_tpu_torch.train.gan_step", "gan_train_step"),
         ("wordgesture_gan_tpu_torch.train.masked_step", "gan_train_step_masked"))


@contextlib.contextmanager
def half_batch_in_replays():
    """The program's train steps with ``half_batch(step, 1)`` planted."""
    import importlib

    saved = [(importlib.import_module(m), name) for m, name in STEPS]
    originals = [getattr(m, name) for m, name in saved]
    for (m, name), step in zip(saved, originals):
        setattr(m, name, half_batch(step, 1))
    try:
        yield
    finally:
        for (m, name), step in zip(saved, originals):
            setattr(m, name, step)


def _program_readings(cell, seed, device):
    r = train.program_run(cell, seed, 0.0, False, time.perf_counter(), device)
    readings, data = r["readings"], r["data"]
    del r
    gc.collect()
    return readings, data


def train_readings(cell, seed, control: bool, device: str) -> dict:
    readings, data = _program_readings(cell, seed, device)
    want = train.reference_steps(cell, seed, data, device)
    out = {}
    out["program"], out["program_extra"] = train.compare(readings, want)
    if control:
        out["control"], out["control_extra"] = train.compare(
            train.reference_steps(cell, seed, data, device, "float8"), want)
        out["half_batch"], out["half_batch_extra"] = train.compare(
            train.reference_steps(cell, seed, data, device, half_from=0), want)
        with half_batch_in_replays():
            broken, _ = _program_readings(cell, seed, device)
        out["half_batch_replays"], out["half_batch_replays_extra"] = train.compare(broken, want)
    return out


def generate_readings(cell, seed, control: bool, device: str, seconds: float) -> dict:
    r = generate.program_run(cell, seed, seconds, False, time.perf_counter(), device)
    want = generate.reference_rows(cell, r, device)
    out = {"program": generate.compare(r, want)[0], "rows": int(want.shape[0]),
           "jobs": len(r["jobs"])}
    if control:
        fp8 = generate.reference_rows(cell, r, device, "float8")
        out["control"] = {"widest_gap": float(abs(fp8 - want).max())}
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--controls", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=3.0,
                        help="window of a sampling cell's runs")
    parser.add_argument("--out", default="chiprun_out")
    args = parser.parse_args()
    cell = harness.load_cell(args.workload)
    harness.require_cards(int(cell["chips"]))
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        control = i < args.controls
        if cell["traffic_spec"]["kind"] == "train":
            row = train_readings(cell, seed, control, "cuda")
        else:
            row = generate_readings(cell, seed, control, "cuda", args.seconds)
        row.update(seed=seed, seconds=time.perf_counter() - t)
        rows.append(row)
        print(json.dumps(row), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    summary = {"workload": args.workload, "lower": {}}
    for k in rows[0]["program"]:
        summary["lower"][k] = max(r["program"][k] for r in rows)
        for part in ("control", "half_batch", "half_batch_replays"):
            least = [r[part][k] for r in rows if part in r]
            if least:
                summary.setdefault(f"{part}_least", {})[k] = min(least)
    print(json.dumps(summary), flush=True)
    with open(out_dir / f"calibrate_{args.workload}.jsonl", "a") as fh:
        for r in rows + [summary]:
            fh.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
