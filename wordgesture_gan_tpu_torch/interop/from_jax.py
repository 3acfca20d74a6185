"""Weights and train states from the JAX package, without importing JAX.

The JAX generator's parameters (``state["g"]["params"]``) are a tree of
nested dicts and lists, one layout per family: the BiLSTM's
``lstm[k].{fwd,bwd}.{w_ih, w_hh, b_ih, b_hh}`` and ``out.{w, b}``; the MLP's
``mlp[i].{w, b}`` and ``out.{w, b}``; the transformer's ``embed``, ``pos``,
``blocks[i].{ln1, qkv, attn_out, ln2, mlp1, mlp2}``, ``ln_f`` and ``out``.
``generator_from_jax`` turns such a tree, given as numpy arrays, into the
port's ``Generator`` state dict; ``train_state_from_jax``
turns a whole JAX train state (all four models, the critics' spectral-norm
u vectors and, optionally, the Adam moments) into the port's train state,
and ``contrastive_state_from_jax`` does the same for the contrastive
encoder's state (parameters, BatchNorm statistics, optionally the Adam
moments and the counters). The port keeps the JAX layout, so no weight is
transposed.

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


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _dense_from_jax(state: Dict[str, torch.Tensor], name: str, layer) -> None:
    for key in ("w", "b"):
        state[f"{name}.{key}"] = _tensor(layer[key])


def bilstm_generator_from_jax(tree) -> Dict[str, torch.Tensor]:
    """The BiLSTM generator's tree: ``lstm.{k}.{fwd,bwd}.*``, ``out.{w, b}``."""
    state: Dict[str, torch.Tensor] = {}
    for k, layer in enumerate(tree["lstm"]):
        for direction in ("fwd", "bwd"):
            for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
                state[f"lstm.{k}.{direction}.{name}"] = _tensor(layer[direction][name])
    _dense_from_jax(state, "out", tree["out"])
    return state


def mlp_generator_from_jax(tree) -> Dict[str, torch.Tensor]:
    """The MLP generator's tree: ``mlp.{i}.{w, b}``, ``out.{w, b}``."""
    state: Dict[str, torch.Tensor] = {}
    for i, layer in enumerate(tree["mlp"]):
        _dense_from_jax(state, f"mlp.{i}", layer)
    _dense_from_jax(state, "out", tree["out"])
    return state


_BLOCK_DENSE = ("qkv", "attn_out", "mlp1", "mlp2")


def transformer_generator_from_jax(tree) -> Dict[str, torch.Tensor]:
    """The transformer generator's tree: ``embed``, ``pos``,
    ``blocks.{i}.{ln1, qkv, attn_out, ln2, mlp1, mlp2}``, ``ln_f``, ``out``;
    a layer norm holds ``scale`` and ``bias``."""
    state: Dict[str, torch.Tensor] = {"pos": _tensor(tree["pos"])}
    _dense_from_jax(state, "embed", tree["embed"])
    for i, block in enumerate(tree["blocks"]):
        for name in ("ln1", "ln2"):
            for key in ("scale", "bias"):
                state[f"blocks.{i}.{name}.{key}"] = _tensor(block[name][key])
        for name in _BLOCK_DENSE:
            _dense_from_jax(state, f"blocks.{i}.{name}", block[name])
    for key in ("scale", "bias"):
        state[f"ln_f.{key}"] = _tensor(tree["ln_f"][key])
    _dense_from_jax(state, "out", tree["out"])
    return state


def generator_family(tree) -> str:
    """"bilstm", "mlp" or "transformer", from a generator tree's top level."""
    for family, key in (("bilstm", "lstm"), ("mlp", "mlp"), ("transformer", "blocks")):
        if key in tree:
            return family
    raise ValueError(f"not a generator tree: top-level keys {sorted(tree)}")


_FROM_JAX = {"bilstm": bilstm_generator_from_jax, "mlp": mlp_generator_from_jax,
             "transformer": transformer_generator_from_jax}


def generator_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX generator params (numpy leaves) of any family → the port's
    ``Generator`` state dict (float32 tensors, same layout)."""
    return _FROM_JAX[generator_family(tree)](tree)


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
    gets fresh Adam moments. The state's key is ``tree["rng"]`` (JAX's key
    data), or ``PRNGKey(seed)`` without one."""
    from ..train.state import MODELS, make_train_state

    params = {m: tree[m]["params"] for m in MODELS}
    sn = {m: tree[m]["sn"] for m in ("d1", "d2")}
    opt = {m: adam_moments(tree[m]["opt"]) for m in MODELS if tree[m].get("opt") is not None}
    return make_train_state(params, sn, device, seed=seed, opt=opt,
                            epoch=int(np.asarray(tree.get("epoch", 0))), rng=tree.get("rng"))


def contrastive_state_from_jax(tree, device="cuda") -> Dict:
    """The port's contrastive train state (``train/contrastive_loop.py``)
    from a JAX one with numpy leaves: ``tree["params"]`` and ``tree["bn"]``
    (``{"bns": [{"mean", "var"}, ...]}``), and optionally ``tree["opt"]``
    (optax's chain state: clipping, then Adam), ``epoch``, ``step`` and
    ``best_recall``. Without an optimizer state the Adam moments are fresh."""
    from ..train.contrastive_loop import make_contrastive_state

    opt = adam_moments(tree["opt"]) if tree.get("opt") is not None else None
    return make_contrastive_state(
        tree["params"], tree["bn"], device, opt=opt,
        epoch=int(np.asarray(tree.get("epoch", 0))), step=int(np.asarray(tree.get("step", 0))),
        best_recall=float(np.asarray(tree.get("best_recall", 0.0))))
