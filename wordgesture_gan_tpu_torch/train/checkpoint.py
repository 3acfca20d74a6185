"""Checkpoints of the train state, run metadata, and the generator weights
serving reads (the port of the JAX package's ``train/checkpoint.py``).

A checkpoint is one ``torch.save`` file per saved epoch, ``epoch_{N}.pt``,
written to a hidden temporary file and renamed into place, and ``latest.pt``,
a relative symlink to the newest one swapped in by an atomic rename: a kill
at any point leaves the previous snapshot or the new one, never a partial
file. It holds the state's trees on the CPU, the random generator's state and
the epoch. The contrastive trainer's state ({params, bn, opt, epoch, step,
best_recall}) is saved the same way, as ``epoch_{N}.pt`` without moving
``latest.pt`` and as a named snapshot ``<name>.pt`` (``save_named``); both
kinds restore through ``restore_checkpoint``. Like the JAX package's, the
contrastive trainer writes ``epoch_{N}`` under the names the GAN trainer
uses, so in one shared directory it replaces a GAN snapshot of the same
epoch.

Generator weights for serving come from a port checkpoint (a train state, or
``torch.save`` of a ``Generator`` state dict) or from a path-keyed JAX
generator ``.npz`` (``interop/from_jax.py``).
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Dict, Optional

import torch

from ..configs import ModelConfig
from ..interop.from_jax import flatten_tree, generator_from_npz
from ..models.gan import Generator
from ..utils.tree import tree_map


def _atomic_write(path: Path, write) -> None:
    """``write(tmp_path)``, then rename over ``path``; the temporary file is
    removed if anything fails."""
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.name}.", suffix=".tmp")
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _snapshot(state: Dict) -> Dict:
    """The state as CPU tensors and numbers (what ``torch.save`` writes)."""
    return {k: tree_map(lambda t: t.detach().cpu() if torch.is_tensor(t) else t, v)
            for k, v in state.items()}


def save_checkpoint(state: Dict, checkpoint_dir: str, epoch: int,
                    keep_latest: bool = True) -> None:
    """Write ``epoch_{epoch+1}.pt`` and, with ``keep_latest``, point
    ``latest.pt`` at it."""
    base = Path(checkpoint_dir).absolute()
    base.mkdir(parents=True, exist_ok=True)
    name = f"epoch_{epoch + 1}.pt"
    snapshot = _snapshot(state)
    _atomic_write(base / name, lambda tmp: torch.save(snapshot, tmp))
    if not keep_latest:
        return
    link = base / f".latest.lnk.{os.getpid()}"
    if link.is_symlink() or link.exists():
        link.unlink()
    os.symlink(name, link)
    os.replace(link, base / "latest.pt")


def save_named(state: Dict, checkpoint_dir: str, name: str) -> None:
    """Write a standalone named snapshot ``<name>.pt`` (e.g.
    ``contrastive_latest.pt``), atomically."""
    base = Path(checkpoint_dir).absolute()
    base.mkdir(parents=True, exist_ok=True)
    snapshot = _snapshot(state)
    _atomic_write(base / f"{name}.pt", lambda tmp: torch.save(snapshot, tmp))


def _copy_into(dst, src, where: str, path: Path) -> None:
    """Copy the saved tree ``src`` into the live tree ``dst`` in place:
    tensors by ``copy_`` (shapes must match; the key too),
    numbers by value."""
    for key in (dst if isinstance(dst, dict) else range(len(dst))):
        d, s = dst[key], src[key]
        here = f"{where}/{key}" if where else str(key)
        if isinstance(d, (dict, list)):
            _copy_into(d, s, here, path)
        elif torch.is_tensor(d):
            if d.shape != s.shape:
                raise ValueError(f"checkpoint {path}: {here} holds {tuple(s.shape)} where the "
                                 f"model has {tuple(d.shape)}; the run's configuration does "
                                 f"not match the one that wrote it")
            d.copy_(s)
        else:
            dst[key] = type(d)(s)


@torch.no_grad()
def restore_checkpoint(state: Dict, checkpoint_dir: str, name: str = "latest.pt") -> Optional[Dict]:
    """Copy a checkpoint into ``state`` (a fresh state of the same kind and
    configuration) and return it, or None when there is none. A missing or
    dangling snapshot ``name`` falls back to the newest ``epoch_N.pt``; a
    snapshot of another kind of state raises."""
    path = find_checkpoint(checkpoint_dir, name)
    if path is None:
        return None
    saved = torch.load(path, map_location="cpu", weights_only=True)
    try:
        _copy_into(state, saved, "", path)
    except (KeyError, IndexError, TypeError) as e:
        raise ValueError(f"checkpoint {path} does not match this kind of state (no {e}); it "
                         f"was written by another trainer or configuration") from e
    return state


def find_checkpoint(checkpoint_dir: str, name: str = "latest.pt") -> Optional[Path]:
    """The snapshot ``name`` of a checkpoint directory; a missing or dangling
    ``latest.pt`` falls back to the newest ``epoch_N.pt``. None when the
    directory holds no snapshot."""
    base = Path(checkpoint_dir).absolute()
    path = base / name
    if path.exists():
        return path
    n = latest_epoch(checkpoint_dir)
    return base / f"epoch_{n}.pt" if n > 0 else None


def latest_epoch(checkpoint_dir: str) -> int:
    """Highest epoch number with a snapshot, or 0."""
    base = Path(checkpoint_dir)
    if not base.exists():
        return 0
    epochs = [int(p.stem.split("_")[1]) for p in base.glob("epoch_*.pt")
              if p.stem.split("_")[1].isdigit()]
    return max(epochs, default=0)


def save_run_metadata(checkpoint_dir: str, **fields) -> None:
    """Merge ``fields`` into ``run_meta.json`` (written atomically)."""
    base = Path(checkpoint_dir).absolute()
    base.mkdir(parents=True, exist_ok=True)
    meta = load_run_metadata(checkpoint_dir)
    meta.update(fields)
    _atomic_write(base / "run_meta.json", lambda tmp: Path(tmp).write_text(json.dumps(meta, indent=2)))


def load_run_metadata(checkpoint_dir: str) -> dict:
    """``run_meta.json`` of a checkpoint directory, or {} if it is missing or
    unreadable (a corrupt sidecar must not block a run)."""
    meta_path = Path(checkpoint_dir).absolute() / "run_meta.json"
    if not meta_path.exists():
        return {}
    try:
        return json.loads(meta_path.read_text())
    except (json.JSONDecodeError, OSError):
        return {}


def load_generator_weights(path: str) -> Dict[str, torch.Tensor]:
    """Generator state dict from a ``.npz`` (JAX tree), a port train-state
    checkpoint, or a saved ``Generator`` state dict."""
    if str(path).endswith(".npz"):
        return generator_from_npz(path)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if "g" in saved and "rng" in saved:
        return _generator_state_dict(saved["g"]["params"])
    return saved


def _generator_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """A generator parameter tree (CPU tensors) as a ``Generator`` state dict."""
    return {k.replace("/", "."): torch.as_tensor(v) for k, v in flatten_tree(params).items()}


def generator_from_state(state: Dict, config: ModelConfig, device="cuda") -> Generator:
    """A serving ``Generator`` of ``config`` on ``device`` holding a copy of a
    train state's generator weights (sampling during training)."""
    model = Generator(config)
    model.load_state_dict(_generator_state_dict(
        tree_map(lambda t: t.detach().cpu(), state["g"]["params"])))
    return model.to(device).eval()


def load_generator(path: str, config: ModelConfig, device="cuda") -> Generator:
    """A ``Generator`` of ``config`` on ``device`` holding the weights at
    ``path``; weights of another shape raise."""
    model = Generator(config)
    model.load_state_dict(load_generator_weights(path))
    return model.to(device).eval()
