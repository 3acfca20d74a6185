"""Kernels 1-3's share of their roofline in the traced epochs: the least
time of the BiLSTM work a step needs (n_critic inference forwards at twice
the batch; a training forward and a backward through time at the batch for
each differentiated generator application: two, three with the diversity
terms) times the traced steps, over the device time of the kernels of that
name (``bilstm_fused*``, ``train_fwd*``, ``train_bwd*``), in percent."""

from portbench.flops import bilstm_bound_ms, train_bounds_ms
from portbench.trace import device_seconds


def read(ctx):
    t, spec = ctx.get("trace"), ctx["cell"]["model_config"]
    m, tc = spec["model"], spec["training"]
    if not t or not t.get("steps") or m["generator_type"] != "bilstm":
        return None
    launches, seconds = device_seconds(t["ops"], "bilstm_fused", "train_fwd", "train_bwd")
    if not seconds:
        return None
    shape = (m["seq_length"], m["gen_hidden_dim"], m["gen_num_layers"], m["latent_dim"],
             m["compute_dtype"])
    B = tc["batch_size"]
    differentiated = 2 + bool(tc.get("lambda_div") or tc.get("lambda_ms"))
    pair = train_bounds_ms(B, *shape)
    step_ms = (tc["n_critic"] * bilstm_bound_ms(2 * B, *shape)[0]
               + differentiated * (pair["fwd"][0] + pair["bwd"][0]))
    return 100.0 * step_ms * t["steps"] / (seconds * 1e3)
