"""Weights and train states from the JAX package, without importing JAX.

The JAX generator's parameters (``state["g"]["params"]``) are a tree of
nested dicts and lists: ``lstm[k].{fwd,bwd}.{w_ih, w_hh, b_ih, b_hh}`` and
``out.{w, b}``. ``generator_from_jax`` turns that tree, given as numpy
arrays, into the port's ``Generator`` state dict; ``train_state_from_jax``
turns a whole JAX train state (all four models, the critics' spectral-norm
u vectors and, optionally, the Adam moments) into the port's train state.
The port keeps the JAX layout, so no weight is transposed.

To move trained weights, flatten the tree by path into an ``.npz``
(``lstm/0/fwd/w_ih``, ..., ``out/w``). Anyone with the JAX package can write
one from a restored state:

    params = jax.device_get(state["g"]["params"])
    write_generator_npz(params, "generator.npz")      # this module, numpy only

and ``generator_from_npz`` reads it back. Orbax checkpoint directories are
not read here, because reading them needs JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts/lists of arrays → {"a/0/b": array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for key, value in items:
        out.update(flatten_tree(value, f"{prefix}/{key}" if prefix else str(key)))
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]):
    """Inverse of ``flatten_tree``: path components that are all digits at
    one level become a list."""
    root: dict = {}
    for path, value in flat.items():
        node = root
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def write_generator_npz(tree, path: str) -> None:
    """Write a JAX-layout generator tree (numpy leaves) as a path-keyed npz."""
    np.savez(path, **flatten_tree(tree))


def read_generator_npz(path: str):
    """Read a path-keyed generator npz back into the nested tree."""
    with np.load(path) as data:
        return unflatten_tree({k: data[k] for k in data.files})


def generator_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX generator params (numpy leaves) → the port's ``Generator`` state
    dict (float32 tensors, same layout)."""
    state: Dict[str, torch.Tensor] = {}
    for k, layer in enumerate(tree["lstm"]):
        for direction in ("fwd", "bwd"):
            for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
                state[f"lstm.{k}.{direction}.{name}"] = torch.tensor(
                    np.asarray(layer[direction][name], np.float32))
    for name in ("w", "b"):
        state[f"out.{name}"] = torch.tensor(np.asarray(tree["out"][name], np.float32))
    return state


def generator_from_npz(path: str) -> Dict[str, torch.Tensor]:
    """The port's state dict from a path-keyed JAX generator npz."""
    return generator_from_jax(read_generator_npz(path))


def autoencoder_from_jax(tree, device="cpu") -> Dict:
    """The FID autoencoder's JAX parameter tree (numpy leaves) → the port's
    tree of float32 tensors on ``device`` (same structure, same layout)."""
    from ..utils.tree import tree_map

    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32), device=device), tree)


def adam_moments(opt) -> Dict:
    """{"mu", "nu", "count"} of an optax chain state (a tuple holding one
    ``ScaleByAdamState``, numpy leaves)."""
    for part in opt:
        if all(hasattr(part, k) for k in ("mu", "nu", "count")):
            return {"mu": part.mu, "nu": part.nu, "count": int(np.asarray(part.count))}
    raise ValueError("no Adam state (mu, nu, count) in the optimizer state")


def train_state_from_jax(tree, device="cuda", seed: int = 0) -> Dict:
    """The port's train state (``train/state.py``) from a JAX train state
    with numpy leaves: ``tree[m]["params"]`` for m in g, e, d1, d2, the
    critics' ``tree[m]["sn"]``, and optionally ``tree[m]["opt"]`` (optax's
    chain state) and ``tree["epoch"]``. Without an optimizer state a model
    gets fresh Adam moments. The port's random generator is seeded with
    ``seed``: JAX's key has no PyTorch counterpart."""
    from ..train.state import MODELS, make_train_state

    params = {m: tree[m]["params"] for m in MODELS}
    sn = {m: tree[m]["sn"] for m in ("d1", "d2")}
    opt = {m: adam_moments(tree[m]["opt"]) for m in MODELS if tree[m].get("opt") is not None}
    return make_train_state(params, sn, device, seed=seed, opt=opt,
                            epoch=int(np.asarray(tree.get("epoch", 0))))
