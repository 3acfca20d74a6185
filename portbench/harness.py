"""The benchmark's driver: one run of one cell of ``BENCHMARK.json``.

A cell names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); the mix's ``kind`` names the module under
``kinds/`` that sets up the program, measures its window and checks what
the window produced against the plain reference (``reference/``), with the
limits of ``limits/<cell>.json``. Each metric is read by its own file,
``metrics/<metric name>.py`` (``read(ctx)``, None where it finds nothing).

Printed: an earlier JSON line of what the run used and counted (card, power
limit, peak memory, kernel launches, graph replays, window counts), then the
result as the last line of standard output, whose last key, ``checks``,
gives each compared number beside its limit; the same numbers close
standard error. A run that cannot be measured (no card, too few cards, a
JAX module loaded) prints no result and exits with 2.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "wordgesture_gan_tpu")


class NotMeasurable(RuntimeError):
    """The run cannot give a result on this machine."""


def load_cell(name: str, benchmark: Optional[Dict] = None) -> Dict:
    """The cell's entry with its configuration, traffic and limits loaded."""
    bench = benchmark or json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = dict(cells[name])
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cell["config_entry"] = cfg
    cell["model_config"] = json.loads((ROOT / cfg["file"]).read_text())
    cell["traffic_spec"] = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = HERE / "limits" / f"{name}.json"
    cell["limits"] = json.loads(limits.read_text()) if limits.exists() else {}
    cell["metrics"] = metrics_of(bench, name)
    return cell


def metrics_of(bench: Dict, cell: str) -> Dict[str, List[Dict]]:
    """The end-to-end and per-layer metrics this cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell in m.get("workloads", [cell] if m["moves"] in names else [])]
    return {"end_to_end": e2e, "per_layer": layer}


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric:{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(metrics: List[Dict], ctx: Dict, required: bool) -> Dict[str, Dict]:
    out = {}
    for m in metrics:
        value = reader(m["name"])(ctx)
        if value is None:
            if required:
                raise RuntimeError(f"metric {m['name']} found nothing to read")
            continue
        if not math.isfinite(value):
            raise RuntimeError(f"metric {m['name']} read {value}")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, Dict]) -> Dict[str, Dict]:
    """Each number the cell's limits file compares, beside its limit; the
    file's entries without a limit are read and not compared."""
    compared = {k for k, v in limits.items() if isinstance(v, dict) and "limit" in v}
    return {k: {"value": numbers.get(k, math.nan), "limit": limits[k]["limit"]}
            for k in sorted(compared)}


def passed(checks: Dict[str, Dict]) -> bool:
    """Every compared number finite and within its limit, and at least one."""
    return bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                for c in checks.values())


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_info(chips: int) -> Dict:
    import torch

    info = {"name": torch.cuda.get_device_name(0), "count": chips}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        info["nvidia_smi"] = out.stdout.strip().splitlines()[:chips]
    except (OSError, subprocess.SubprocessError) as err:
        info["nvidia_smi"] = f"unavailable: {err}"
    return info


def require_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NotMeasurable("torch.cuda.is_available() is false: no card to measure on")
    if torch.cuda.device_count() < chips:
        raise NotMeasurable(f"the cell needs {chips} card(s); {torch.cuda.device_count()} seen")


def run(cell: Dict, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda") -> Dict:
    """One run of ``cell``: the kind's measurement, the metric readers, the
    JAX check. Returns {"info": earlier line, "result": last line}."""
    kind = importlib.import_module(f"portbench.kinds.{cell['traffic_spec']['kind']}")
    outcome = kind.run(cell, seed, seconds, trace, t0, device)
    found = loaded_forbidden()
    if found:
        raise NotMeasurable(f"JAX modules loaded in the measuring process: {found}")
    ctx = outcome["ctx"]
    metrics = read_metrics(cell["metrics"]["per_layer" if trace else "end_to_end"], ctx,
                           required=not trace)
    checks = judge(outcome["numbers"], cell["limits"])
    outcome["info"]["not_compared"] = {k: v for k, v in outcome["numbers"].items()
                                       if k not in checks}
    result = {"correct": outcome["complete"] and passed(checks),
              "attempted": outcome["attempted"], "failed": outcome["failed"],
              "metrics": metrics, "device": outcome["device"]}
    if trace:
        result["breakdown"] = ctx["trace"]["breakdown"]
    result["checks"] = checks
    return {"info": outcome["info"], "result": result}


def main(argv: List[str], t0: float) -> int:
    parser = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = load_cell(args.workload)
    import torch

    # One host thread for the program's host work: the card is fed by one
    # process, and idle worker threads only add noise on a shared host.
    torch.set_num_threads(1)
    try:
        require_cards(int(cell["chips"]))
        out = run(cell, args.seed, args.seconds, bool(args.trace), t0)
    except NotMeasurable as err:
        print(f"portbench: not measurable: {err}", file=sys.stderr)
        return 2
    gc.collect()
    print(json.dumps({"portbench_info": out["info"]}), flush=True)
    print(json.dumps(out["result"]), flush=True)
    for name, c in out["result"]["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {out['result']['correct']}", file=sys.stderr, flush=True)
    return 0
