"""Durable per-epoch loss history: one JSON line per completed epoch in
``<checkpoint_dir>/history.jsonl`` (the port of the JAX package's
``train/history.py``). On resume, records past the restored epoch are
dropped, so a crash between logging and checkpointing leaves no duplicate
epochs."""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Mapping, Optional


def append_history(checkpoint_dir: Optional[str], epoch: int,
                   losses: Mapping[str, float]) -> None:
    """Append one epoch record (1-based ``epoch`` field in the file)."""
    if not checkpoint_dir:
        return
    path = Path(checkpoint_dir)
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "history.jsonl", "a") as f:
        f.write(json.dumps({"epoch": epoch + 1, **losses}) + "\n")


def truncate_history(checkpoint_dir: Optional[str], restored_epoch: int) -> None:
    """Drop records with ``epoch > restored_epoch``; rewrites atomically and
    drops malformed lines."""
    if not checkpoint_dir:
        return
    path = Path(checkpoint_dir) / "history.jsonl"
    if not path.exists():
        return
    kept = []
    for line in path.read_text().splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict) and rec.get("epoch", 0) <= restored_epoch:
            kept.append(line)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=".history_", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write("".join(line + "\n" for line in kept))
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
