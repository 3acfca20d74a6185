"""GAN train state: the four models' parameters, their optimizer states, the
critics' spectral-norm u state, the random key and the epoch (the port of
the JAX package's ``train/state.py``).

The state is a plain dict of trees of float32 tensors in the JAX layout::

    {"g":  {"params": tree, "opt": adam},
     "e":  {"params": tree, "opt": adam},
     "d1": {"params": tree, "opt": adam, "sn": u tree},
     "d2": {"params": tree, "opt": adam, "sn": u tree},
     "rng": key, "epoch": int}

with ``adam = {"mu": tree, "nu": tree, "count": int}``. Parameters are leaf
tensors that require grad; the train step takes gradients with
``torch.autograd.grad`` (so no ``.grad`` is ever left on a leaf) and updates
parameters and moments in place, where the JAX step returns new arrays.
The key is the JAX package's ``state["rng"]``, an int64 (2,) CPU tensor of
two uint32 words (``utils/prng.py``): each step splits its draws off it on
the host, as the JAX step does, so a seed gives the JAX package's numbers.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..configs import DEFAULT_MODEL_CONFIG, ModelConfig
from ..models.gan import disc_init, encoder_init, generator_init
from ..utils import prng
from ..utils.tree import tree_leaves, tree_map

MODELS = ("g", "e", "d1", "d2")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.5, 0.999, 1e-8


def adam_init(params) -> Dict:
    """Zero moments shaped like ``params``, step count 0."""
    return {"mu": tree_map(torch.zeros_like, params), "nu": tree_map(torch.zeros_like, params),
            "count": 0}


@functools.lru_cache(maxsize=8)
def _inverse_correction_table(beta: float, device: torch.device) -> torch.Tensor:
    """1 / (1 - β^c) for c = 1, 2, ... (row c - 1), up to the first c at
    which it rounds to 1.0 in float32 (it stays there for every larger c):
    each value computed in Python's double precision, as ``apply_update``
    computes it for an int count, then rounded to float32, as a kernel
    rounds a Python number."""
    if not 0.0 <= beta < 1.0:
        raise ValueError(f"Adam's beta must lie in [0, 1), got {beta}")
    values, count = [], 1
    while not values or np.float32(values[-1]) != 1.0:
        values.append(1.0 / (1.0 - beta ** count))
        count += 1
    return torch.tensor(values, dtype=torch.float32, device=device)


def inverse_bias_corrections(count, b1: float, b2: float):
    """The reciprocals of Adam's bias corrections, 1 / (1 - β1^count) and
    1 / (1 - β2^count), count >= 1. For an int count they are Python numbers.
    For a 0-d int64 count on the device (a step captured as a CUDA graph,
    ``train/step_graph.py``) they are 0-d float32 tensors read from a table
    of the same numbers, so a replay and an eager step multiply by the same
    float32 values and no host number is frozen into the graph."""
    if not torch.is_tensor(count):
        return 1.0 / (1.0 - b1 ** count), 1.0 / (1.0 - b2 ** count)
    out = []
    for beta in (b1, b2):
        table = _inverse_correction_table(beta, count.device)
        index = torch.clamp(count - 1, min=0, max=table.shape[0] - 1).reshape(1)
        out.append(table.index_select(0, index).reshape(()))
    return tuple(out)


@torch.no_grad()
def apply_update(params, grads: List[torch.Tensor], opt: Dict, lr,
                 grad_clip_norm: float, b1: float = ADAM_B1, b2: float = ADAM_B2) -> None:
    """One optimizer step, in place: global-norm clipping, then Adam
    (β = (0.5, 0.999) for the GAN's models, ε = 1e-8 outside the square root,
    bias-corrected), then ``p -= lr · u`` (``lr · u`` rounded, then
    subtracted, as optax's ``p + (-lr · u)``). The moments are bias-corrected
    by multiplying with the float32 reciprocal of 1 - β^count, which is what
    CUDA's division by a Python number computes (the CPU's divides).

    Clipping is optax's ``clip_by_global_norm``: the gradients are scaled by
    max / ‖g‖ only when ‖g‖ >= max (no ε in the denominator), decided on the
    device without a host round trip. ``grads`` are in ``tree_leaves(params)``
    order.

    ``lr`` is a Python number, or a 0-d float32 tensor on the device, and
    ``opt["count"]`` an int, or a 0-d int64 tensor on the device that is
    incremented in place: the forms a step captured as a CUDA graph takes,
    so that every replay reads its own learning rate and step count. The
    two forms give bit-equal results."""
    p = tree_leaves(params)
    g = list(grads)
    mu, nu = tree_leaves(opt["mu"]), tree_leaves(opt["nu"])
    if grad_clip_norm and grad_clip_norm > 0:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        scale = torch.where(norm < grad_clip_norm, torch.ones_like(norm), grad_clip_norm / norm)
        g = torch._foreach_mul(g, scale)
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, g, alpha=1.0 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
    opt["count"] += 1
    r1, r2 = inverse_bias_corrections(opt["count"], b1, b2)
    denom = torch._foreach_mul(nu, r2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, ADAM_EPS)
    update = torch._foreach_mul(mu, r1)
    torch._foreach_div_(update, denom)
    torch._foreach_mul_(update, lr)
    torch._foreach_sub_(p, update)


def make_optimizer(grad_clip_norm: float = 1.0, b1: float = ADAM_B1,
                   b2: float = ADAM_B2) -> Callable[..., None]:
    """The GAN models' optimizer as one call, ``update(params, grads, opt,
    lr)``: global-norm clipping to ``grad_clip_norm``, then Adam
    (``apply_update``); the counterpart of the JAX package's optax chain.
    Its state is ``adam_init(params)``."""
    return functools.partial(apply_update, grad_clip_norm=grad_clip_norm, b1=b1, b2=b2)


def param_count(state: Dict) -> Dict[str, int]:
    """Parameters per model of a GAN train state: {"g", "e", "d1", "d2": n}."""
    return {m: sum(int(t.numel()) for t in tree_leaves(state[m]["params"])) for m in MODELS}


def _state(t, device) -> torch.Tensor:
    """A float32 copy of a tensor or array on ``device``."""
    if not torch.is_tensor(t):
        t = torch.from_numpy(np.array(t, dtype=np.float32))
    return t.detach().to(device=device, dtype=torch.float32).clone()


def _leaf(t, device) -> torch.Tensor:
    return _state(t, device).requires_grad_(True)


def make_train_state(params: Dict, sn: Dict, device="cuda", seed: int = 0,
                     opt: Optional[Dict] = None, epoch: int = 0, rng=None) -> Dict:
    """A train state on ``device`` from parameter trees ``params[m]`` and
    spectral states ``sn["d1" | "d2"]`` (tensors or arrays), with fresh Adam
    states unless ``opt[m]`` gives ``{"mu", "nu", "count"}``. The state's
    key is ``rng`` (two uint32 words, e.g. a JAX state's key) or else
    ``PRNGKey(seed)``."""
    device = torch.device(device)
    state: Dict = {}
    for m in MODELS:
        p = tree_map(lambda t: _leaf(t, device), params[m])
        if opt is not None and m in opt:
            o = {"mu": tree_map(lambda t: _state(t, device), opt[m]["mu"]),
                 "nu": tree_map(lambda t: _state(t, device), opt[m]["nu"]),
                 "count": int(opt[m]["count"])}
        else:
            o = adam_init(tree_map(lambda t: t.detach(), p))
        state[m] = {"params": p, "opt": o}
        if m in ("d1", "d2"):
            state[m]["sn"] = tree_map(lambda t: _state(t, device), sn[m])
    state["rng"] = prng.PRNGKey(seed) if rng is None else prng.as_key(rng)
    state["epoch"] = epoch
    return state


def init_gan_state(seed: int = 0, model_config: ModelConfig = DEFAULT_MODEL_CONFIG,
                   device="cuda") -> Dict:
    """Fresh train state for (G, E, D1, D2) on ``device``: the JAX package's
    ``init_gan_state(seed)``. ``PRNGKey(seed)`` splits into the keys of G, E,
    D1, D2 and the state's own; the weights are drawn on the CPU (PyTorch's
    default initializers, as the JAX package draws them), then moved in one
    go. The optimizer needs no configuration here: the step passes the
    learning rate and the clip norm."""
    kg, ke, kd1, kd2, krng = prng.split(prng.PRNGKey(seed), 5)
    d1, d1_sn = disc_init(model_config, kd1)
    d2, d2_sn = disc_init(model_config, kd2)
    params = {"g": generator_init(model_config, kg), "e": encoder_init(model_config, ke),
              "d1": d1, "d2": d2}
    return make_train_state(params, {"d1": d1_sn, "d2": d2_sn}, device, rng=krng)
