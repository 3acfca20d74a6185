"""The attention kernels' share of their roofline in the traced epochs: the
least time of the attention work a masked step needs (n_critic x layers
forwards at twice the batch in the critic loop; 2 x layers forwards and 2 x
layers backwards at the batch in the joint step) times the traced steps,
over the device time of the kernels named ``attn_core_*``, in percent.
None where the generator is not the transformer or no such kernel ran."""

from portbench.attention_bounds import attention_bounds_ms
from portbench.trace import device_seconds


def read(ctx):
    t, spec = ctx.get("trace"), ctx["cell"]["model_config"]
    m, tc = spec["model"], spec["training"]
    if not t or not t.get("steps") or m["generator_type"] != "transformer":
        return None
    _, seconds = device_seconds(t["ops"], "attn_core_")
    if not seconds:
        return None
    B, layers, heads = tc["batch_size"], m["tfm_num_layers"], m["tfm_num_heads"]
    shape = (m["seq_length"], heads, m["tfm_d_model"] // heads, m["compute_dtype"],
             bool(spec.get("variable_length")))
    critic, joint = attention_bounds_ms(2 * B, *shape), attention_bounds_ms(B, *shape)
    step_ms = layers * (tc["n_critic"] * critic["fwd"][0]
                        + 2 * (joint["fwd"][0] + joint["bwd"][0]))
    return 100.0 * step_ms * t["steps"] / (seconds * 1e3)
