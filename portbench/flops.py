"""Operations and bytes from shapes, and the peaks they are held against.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s in bfloat16 on the tensor cores, 67 TFLOP/s in float32
on the CUDA cores, 3.35 TB/s of HBM. A share of a peak is stated with the
card's power limit beside it.

``bilstm_bound_ms`` and ``train_bounds_ms`` are the least times of the
program's BiLSTM kernels (its kernels 1, 2 and 3) at a shape; the model
counts (``*_flops``) are the multiply-adds of every product of an
application, two operations each, forward only: a backward that gives
parameter gradients costs two forwards, one that gives input gradients
alone one.
"""

from __future__ import annotations

from typing import Dict, Tuple

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# bf16 terms a float32 gate gradient is split into for the tensor cores in
# the training backward: each backward product runs that often.
BWD_SPLIT_TERMS = 2
CRITIC_CONVS = ((3, 64, 5), (64, 64, 5), (64, 32, 3))   # in, out, kernel (length kept)
CRITIC_DENSE = ((32 * 8, 128), (128, 64), (64, 1))


def _bound(nbytes: float, flops: float, peak_flops: float) -> Tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bilstm_flops(batch: int, seq: int, hidden: int, layers: int, latent: int) -> float:
    """The gate products of a stacked BiLSTM with a 2-wide sequence input
    and a latent input projected once: both directions, every step."""
    g = 4 * hidden
    return batch * 2 * (seq * 2 * g * (hidden + 2) + (layers - 1) * seq * 2 * g * 3 * hidden
                        + 2 * g * latent)


def bilstm_bound_ms(batch: int, seq: int, hidden: int, layers: int, latent: int,
                    dtype: str) -> Tuple[float, str]:
    """Least time of the inference forward (kernel 1): (ms, "bytes" or
    "operations"). Bytes: each input read once (prototype, z, weights), the
    output written once."""
    item = 2 if dtype == "bfloat16" else 4
    g = 4 * hidden
    weights = (2 * 2 * g + layers * 2 * hidden * g + (layers - 1) * 2 * 2 * hidden * g) * item \
        + (2 * latent * g + layers * 2 * g) * 4
    nbytes = batch * seq * 2 * item + batch * latent * 4 + weights \
        + batch * seq * 2 * hidden * item
    return _bound(nbytes, bilstm_flops(batch, seq, hidden, layers, latent), PEAK_FLOPS[dtype])


def train_bounds_ms(batch: int, seq: int, hidden: int, layers: int, latent: int,
                    dtype: str) -> Dict[str, Tuple[float, str]]:
    """Least times of the training forward (kernel 2) and backward through
    time (kernel 3): {"fwd": (ms, by), "bwd": (ms, by)}. Kernel 2: kernel 1's
    products; bytes: inputs once, the residuals (layers, 2, L, B, 6H) and
    the output once. Kernel 3: per step and direction dh through W_hh^T,
    the input gradient and the weight gradients, plus dW_z and dz; in
    bfloat16 each product as BWD_SPLIT_TERMS tensor-core products (the
    float32 gate gradient split in bf16 terms)."""
    item = 2 if dtype == "bfloat16" else 4
    H, g = hidden, 4 * hidden
    weights = (2 * 2 * g + layers * 2 * H * g + (layers - 1) * 2 * 2 * H * g) * item
    res = layers * 2 * seq * batch * 6 * H * item
    proto_z = batch * seq * 2 * item + batch * latent * 4
    fwd_bytes = proto_z + weights + (2 * latent * g + layers * 2 * g) * 4 + res \
        + batch * seq * 2 * H * item
    macs_first = H * g + 2 * g + (2 + H) * g
    macs_rest = H * g + 2 * H * g + (2 * H + H) * g
    bwd_flops = batch * 2 * (2 * seq * (macs_first + (layers - 1) * macs_rest)
                             + 2 * 2 * latent * g)
    dw = 2 * ((2 + latent + H + 1) + (layers - 1) * (3 * H + 1)) * g * 4
    bwd_bytes = res + batch * seq * 2 * H * item + proto_z + weights + latent * 2 * g * item \
        + dw + batch * latent * 4 + batch * seq * 2 * 4
    bwd_peak = PEAK_FLOPS["bfloat16"] / BWD_SPLIT_TERMS if dtype == "bfloat16" \
        else PEAK_FLOPS["float32"]
    return {"fwd": _bound(fwd_bytes, bilstm_flops(batch, seq, H, layers, latent),
                          PEAK_FLOPS[dtype]),
            "bwd": _bound(bwd_bytes, bwd_flops, bwd_peak)}


def generator_flops(model: Dict) -> float:
    """One gesture through the generator, forward."""
    L, Z = model["seq_length"], model["latent_dim"]
    if model["generator_type"] == "bilstm":
        H = model["gen_hidden_dim"]
        return bilstm_flops(1, L, H, model["gen_num_layers"], Z) + 2 * L * 2 * H * 3
    if model["generator_type"] == "transformer":
        d = model["tfm_d_model"]
        m = model["tfm_mlp_ratio"] * d
        block = 2 * L * (d * 3 * d + d * d + 2 * d * m) + 2 * 2 * L * L * d
        return 2 * L * (2 + Z) * d + model["tfm_num_layers"] * block + 2 * L * d * 3
    raise ValueError(f"no operation count for generator {model['generator_type']!r}")


def encoder_flops(model: Dict) -> float:
    dims = (model["seq_length"] * 3,) + tuple(model["enc_hidden_dims"])
    return 2 * (sum(a * b for a, b in zip(dims, dims[1:])) + 2 * dims[-1] * model["latent_dim"])


def critic_flops(model: Dict) -> float:
    L = model["seq_length"]
    return 2 * (L * sum(i * o * k for i, o, k in CRITIC_CONVS)
                + sum(i * o for i, o in CRITIC_DENSE))


def train_step_flops(model: Dict, training: Dict) -> float:
    """One two-cycle step at the configuration's batch: the critic loop
    (the encoder once, per update a generator forward at 2B and two critic
    updates, each scoring B real and B fake rows with parameter
    gradients), then the joint step (two or three generator applications
    and one encoder application with parameter gradients, the encoder once
    on the fakes, each critic once with input gradients on the fakes and
    once forward on the real rows)."""
    B, n_c = training["batch_size"], training["n_critic"]
    G, E, D = generator_flops(model), encoder_flops(model), critic_flops(model)
    diversity = bool(training.get("lambda_div") or training.get("lambda_ms")) \
        and model["generator_type"] != "transformer"
    critic_loop = B * E + n_c * (2 * B * G + 2 * (2 * B * D * 3))
    joint = B * ((2 + diversity) * 3 * G + E + 3 * E + 2 * (2 * D + D))
    return critic_loop + joint
