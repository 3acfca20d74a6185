"""Tests of the benchmark's harness. Most run on the CPU at small sizes;
those marked ``cuda`` need the card and skip elsewhere (decided inside a
fixture, never at import)."""

import copy
import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips elsewhere")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture
def cell_of():
    """Loads a cell: see ``load``."""
    return load


def load(name):
    """The cell ``name`` of ``BENCHMARK.json``. A name it does not list,
    ``<configuration>.<traffic>``, is made of that configuration and that
    mix: the flagship's sampling cell, out of the benchmark while its rate
    follows the host (PERF.md), keeps its limits and its tests."""
    from portbench import harness

    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    if name not in {w["name"] for w in bench["workloads"]}:
        config, traffic = name.split(".", 1)
        bench = dict(bench, workloads=[*bench["workloads"], {
            "name": name, "config": config, "traffic": traffic, "chips": 1}])
    return harness.load_cell(name, bench)


@pytest.fixture
def small():
    """Shrinks a cell: see ``shrink``."""
    return shrink


def shrink(cell, compute_dtype="float32"):
    """The cell at a size a CPU test run holds: L=16, batch 8, 5 steps an
    epoch, a pool of 512 and jobs of 8-64 rows in chunks of 16."""
    c = copy.deepcopy(cell)
    m = c["model_config"]
    m["model"].update(seq_length=16, compute_dtype=compute_dtype)
    m["training"]["batch_size"] = 8
    m["data"]["train_gestures"] = 44
    lengths = m["data"]["lengths"]
    m["data"]["lengths"] = dict(lengths, max=16, **({"min": 6} if "min" in lengths else {}))
    t = c["traffic_spec"]
    if t["kind"] == "generate":
        t.update(pool=512, job_sizes={"min": 8, "max": 64, "count": 8}, batch=16,
                 sample_rows_per_job=8, trace_jobs=2)
    return c
