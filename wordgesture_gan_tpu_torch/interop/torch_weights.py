"""Reference PyTorch ``state_dict``s into the port's parameter trees and
train state (the port of the JAX package's ``interop/torch_weights.py``), so
trained checkpoints of the CHI'23 reference implementation can be migrated.

Input is a plain ``{name: np.ndarray}`` mapping (call
``{k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}`` on
the reference's modules); the output trees hold float32 tensors in the JAX
package's layout, which the port shares.

Layout notes:
  * ``nn.Linear`` stores ``weight`` as (out, in); the trees hold (in, out) →
    transpose.
  * ``nn.LSTM``'s gate order (i, f, g, o) is the trees'; ``weight_ih_l{k}``
    is (4H, in) → transpose. Layer-0 input rows are ordered [proto | z] in
    both.
  * ``nn.Conv1d`` stores (out, in, k); the trees hold WIO (k, in, out).
  * ``spectral_norm`` stores the unnormalized weight as ``weight_orig`` plus
    power-iteration buffers ``weight_u`` (out,) / ``weight_v``; the params
    hold the unnormalized weight and the spectral state holds u (v is
    recomputed from u each step, as PyTorch does).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..configs import ModelConfig


Array = np.ndarray
StateDict = Mapping[str, Array]


def _f32(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _lin(sd: StateDict, prefix: str) -> Dict[str, torch.Tensor]:
    return {
        "w": _f32(sd[f"{prefix}.weight"].T),
        "b": _f32(sd[f"{prefix}.bias"]),
    }


def _sn_lin(sd: StateDict, prefix: str) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    params = {
        "w": _f32(sd[f"{prefix}.weight_orig"].T),
        "b": _f32(sd[f"{prefix}.bias"]),
    }
    return params, _f32(sd[f"{prefix}.weight_u"])


def _sn_conv(sd: StateDict, prefix: str) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    w = sd[f"{prefix}.weight_orig"]            # (out, in, k)
    params = {
        "w": _f32(np.transpose(w, (2, 1, 0))),  # WIO
        "b": _f32(sd[f"{prefix}.bias"]),
    }
    return params, _f32(sd[f"{prefix}.weight_u"])


def encoder_from_torch(sd: StateDict, config: ModelConfig) -> Dict:
    """VariationalEncoder → encoder tree."""
    n_hidden = len(config.enc_hidden_dims)
    # Sequential interleaves LeakyReLU: Linear modules sit at indices 0,2,4,…
    mlp = [_lin(sd, f"encoder.{2 * i}") for i in range(n_hidden)]
    return {"mlp": mlp, "mu": _lin(sd, "fc_mu"), "log_var": _lin(sd, "fc_log_var")}


def generator_from_torch(sd: StateDict, config: ModelConfig) -> Dict:
    """BiLSTM Generator → generator tree."""
    layers = []
    for k in range(config.gen_num_layers):
        layer = {}
        for our_dir, suffix in (("fwd", ""), ("bwd", "_reverse")):
            layer[our_dir] = {
                "w_ih": _f32(sd[f"lstm.weight_ih_l{k}{suffix}"].T),
                "w_hh": _f32(sd[f"lstm.weight_hh_l{k}{suffix}"].T),
                "b_ih": _f32(sd[f"lstm.bias_ih_l{k}{suffix}"]),
                "b_hh": _f32(sd[f"lstm.bias_hh_l{k}{suffix}"]),
            }
        layers.append(layer)
    return {"lstm": layers, "out": _lin(sd, "output_layer")}


def mlp_disc_from_torch(sd: StateDict, config: ModelConfig) -> Tuple[Dict, Dict]:
    """MLP Discriminator → (params, sn_state)."""
    layers, us = [], []
    for i in range(len(config.disc_hidden_dims)):
        p, u = _sn_lin(sd, f"layers.{i}")
        layers.append(p)
        us.append(u)
    out_p, out_u = _sn_lin(sd, "output_layer")
    return {"layers": layers, "out": out_p}, {"layers": us, "out": out_u}


def temporal_disc_from_torch(sd: StateDict, config: ModelConfig) -> Tuple[Dict, Dict]:
    """TemporalDiscriminator → (params, sn_state).

    Spectral-norm u vectors transfer unchanged: PyTorch power-iterates the
    (out, in·k) view, the port the (k·in, out) view, a row permutation of the
    same matrix, which leaves u (and sigma) identical.
    """
    convs, conv_us = [], []
    for seq_idx in (0, 2, 4):                  # LeakyReLUs at odd indices
        p, u = _sn_conv(sd, f"temporal_conv.{seq_idx}")
        convs.append(p)
        conv_us.append(u)
    mlps, mlp_us = [], []
    for seq_idx in (0, 2):
        p, u = _sn_lin(sd, f"mlp.{seq_idx}")
        mlps.append(p)
        mlp_us.append(u)
    out_p, out_u = _sn_lin(sd, "output_layer")
    return (
        {"convs": convs, "mlp": mlps, "out": out_p},
        {"convs": conv_us, "mlp": mlp_us, "out": out_u},
    )


def disc_from_torch(sd: StateDict, config: ModelConfig) -> Tuple[Dict, Dict]:
    if config.use_temporal_disc:
        return temporal_disc_from_torch(sd, config)
    return mlp_disc_from_torch(sd, config)


def autoencoder_from_torch(sd: StateDict, config: ModelConfig) -> Dict:
    """FID AutoEncoder → autoencoder tree."""
    return {
        "enc": [_lin(sd, f"timestep_encoder.{i}") for i in (0, 2, 4, 6)],
        "post_pool": _lin(sd, "post_pool"),
        "pre_expand": _lin(sd, "pre_expand"),
        "dec": [_lin(sd, f"timestep_decoder.{i}") for i in (0, 2, 4, 6)],
    }


def contrastive_encoder_from_torch(sd: StateDict) -> Tuple[Dict, Dict]:
    """ContrastiveEncoder → (params, batchnorm_state). Its layout:
    ``conv_layers`` Sequential with Conv1d at 0/3/6 and BatchNorm1d at
    1/4/7; ``projection`` Linear at 0/2."""
    convs, bns, bn_states = [], [], []
    for conv_i, bn_i in ((0, 1), (3, 4), (6, 7)):
        w = sd[f"conv_layers.{conv_i}.weight"]            # (out, in, k)
        convs.append({
            "w": _f32(np.transpose(w, (2, 1, 0))),  # WIO
            "b": _f32(sd[f"conv_layers.{conv_i}.bias"]),
        })
        bns.append({
            "scale": _f32(sd[f"conv_layers.{bn_i}.weight"]),
            "bias": _f32(sd[f"conv_layers.{bn_i}.bias"]),
        })
        bn_states.append({
            "mean": _f32(sd[f"conv_layers.{bn_i}.running_mean"]),
            "var": _f32(sd[f"conv_layers.{bn_i}.running_var"]),
        })
    params = {
        "convs": convs,
        "bns": bns,
        "proj": [_lin(sd, "projection.0"), _lin(sd, "projection.2")],
    }
    return params, {"bns": bn_states}


def trainer_state_from_torch(
    checkpoint: Mapping[str, StateDict],
    model_config: ModelConfig,
    training_config=None,
    seed: int = 0,
    device="cuda",
) -> Dict:
    """A reference trainer checkpoint (keys ``generator``, ``encoder``,
    ``discriminator_1``, ``discriminator_2``) → the port's train state on
    ``device`` (``train/state.py``) with those weights, the critics' u
    vectors, fresh Adam moments and epoch 0, its key ``PRNGKey(seed)``. The reference's Adam state is not carried over (its step
    count and moments follow another schedule); ``training_config`` is
    accepted for the JAX function's signature and not needed: the step
    passes the learning rate and the clip norm."""
    from ..train.state import make_train_state

    g = generator_from_torch(checkpoint["generator"], model_config)
    e = encoder_from_torch(checkpoint["encoder"], model_config)
    d1_p, d1_u = disc_from_torch(checkpoint["discriminator_1"], model_config)
    d2_p, d2_u = disc_from_torch(checkpoint["discriminator_2"], model_config)
    return make_train_state({"g": g, "e": e, "d1": d1_p, "d2": d2_p},
                            {"d1": d1_u, "d2": d2_u}, device, seed=seed)
