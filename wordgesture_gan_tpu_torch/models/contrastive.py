"""The contrastive gesture encoder: a strided Conv1D stack and a projection
head (the port of the JAX package's ``models/contrastive.py``).

Three stride-2 conv blocks (BatchNorm + ReLU), the mean over the time axis,
a two-layer projection MLP, and L2 normalization onto the unit sphere.
Parameters and BatchNorm running statistics are two explicit trees in the
JAX layout, so ``interop/from_jax.py`` moves a JAX encoder without
transposes.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs import DEFAULT_CONTRASTIVE_CONFIG, ContrastiveConfig
from ..ops.bias import add_bias
from ..utils import prng
from .layers import Key, _key, batchnorm, batchnorm_init, conv1d, conv1d_init, dense_init

# (in_ch, out_ch, kernel, stride, padding) of each conv block.
_CONV_SPEC = ((3, 32, 7, 2, 3), (32, 64, 5, 2, 2), (64, 128, 3, 2, 1))


def contrastive_encoder_init(
    config: ContrastiveConfig = DEFAULT_CONTRASTIVE_CONFIG, key: Key = None,
) -> Tuple[Dict, Dict]:
    """(params, batchnorm state) with PyTorch's default initializers, drawn
    from ``key`` split as the JAX package splits it: the three convs, then
    the two dense layers."""
    keys = prng.split(_key(key), len(_CONV_SPEC) + 2)
    convs, bns, bn_states = [], [], []
    for i, (cin, cout, k, _s, _p) in enumerate(_CONV_SPEC):
        convs.append(conv1d_init(cin, cout, k, keys[i]))
        bn_p, bn_s = batchnorm_init(cout)
        bns.append(bn_p)
        bn_states.append(bn_s)
    proj1 = dense_init(_CONV_SPEC[-1][1], config.embedding_dim, keys[-2])
    proj2 = dense_init(config.embedding_dim, config.embedding_dim, keys[-1])
    return {"convs": convs, "bns": bns, "proj": [proj1, proj2]}, {"bns": bn_states}


def contrastive_encoder_apply(params: Dict, state: Dict, x: torch.Tensor, train: bool,
                              normalize: bool = True, mesh=None) -> Tuple[torch.Tensor, Dict]:
    """(B, L, 3) → ((B, embedding_dim), new batchnorm state); in train mode
    BatchNorm uses the batch's statistics and advances the running ones.
    With a process group in ``mesh`` (``parallel/mesh.py``), x is this
    rank's rows and BatchNorm's statistics are the global batch's."""
    h = x
    new_bn_states = []
    for conv_p, bn_p, bn_s, (_ci, _co, _k, stride, pad) in zip(
            params["convs"], params["bns"], state["bns"], _CONV_SPEC):
        h = conv1d(conv_p, h, stride=stride, padding=pad)
        h, bn_s_new = batchnorm(bn_p, bn_s, h, train=train, mesh=mesh)
        h = torch.relu(h)
        new_bn_states.append(bn_s_new)

    h = h.mean(dim=1)                        # global average pool over time
    h = torch.relu(add_bias(h @ params["proj"][0]["w"], params["proj"][0]["b"]))
    h = add_bias(h @ params["proj"][1]["w"], params["proj"][1]["b"])
    if normalize:
        h = h / (torch.linalg.vector_norm(h, dim=-1, keepdim=True) + 1e-12)
    return h, {"bns": new_bn_states}
