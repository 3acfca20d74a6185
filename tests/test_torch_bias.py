"""The bias adds' dispatch (``ops/bias.py``) on the CPU.

Every bias add of ``models/`` goes through ``ops.bias.add_bias``: a CUDA
tensor takes the kernel of ``csrc/bias.cu``, a CPU tensor the plain chain
``plain_add_bias`` (``y + b``, then ``residual +`` that). Here: the CPU path
equals the chain bit for bit, forward and gradients, and counts its calls;
the plain function a caller passes is the one a CPU tensor runs; y's stride
of b's step, which the kernel indexes by, in each layout the models make;
the operands the kernel refuses; every dense layer, conv and position add of
each model (and the transformer's residual adds) goes through the op; the
graph's launch counters; the kernel source's paths against the wrapper's.
The kernel itself is held against the chain on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 5o; the models'
outputs against the JAX package's in the parity tests.
"""

import re

import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test worker

from wordgesture_gan_tpu_torch.configs import ContrastiveConfig, ModelConfig
from wordgesture_gan_tpu_torch.models import contrastive, gan, generators, layers
from wordgesture_gan_tpu_torch.ops import bias
from wordgesture_gan_tpu_torch.ops.bias import add_bias, bias_launches, plain_add_bias
from wordgesture_gan_tpu_torch.ops.build import CSRC_DIR, library_path
from wordgesture_gan_tpu_torch.train import step_graph
from wordgesture_gan_tpu_torch.utils import prng

DTYPES = [torch.float32, torch.bfloat16, torch.float64]


def _draw(*shape, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=gen).to(dtype)


def _counts():
    return dict(bias_launches.launches_by_path)


def _moved(before):
    return {k: v - before[k] for k, v in bias_launches.launches_by_path.items() if v != before[k]}


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("y_shape,b_dims", [((6, 5), 1), ((3, 4, 8), 1), ((3, 4, 8), 2),
                                            ((0, 8), 1)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_path_equals_the_chain_bit_for_bit(dtype, y_shape, b_dims, residual):
    """The output and every gradient equal ``y + b`` / ``residual + (y + b)``
    run inline; one plain call counted, none on the card."""
    y, r, g = (_draw(*y_shape, dtype=dtype, seed=s) for s in (1, 2, 3))
    b = _draw(*y_shape[len(y_shape) - b_dims:], dtype=dtype, seed=4)
    leaves = [t.clone().requires_grad_() for t in (y, b, r)]
    inline = [t.clone().requires_grad_() for t in (y, b, r)]
    before = _counts()
    out = add_bias(leaves[0], leaves[1], leaves[2] if residual else None)
    assert _moved(before) == {("bias_residual" if residual else "bias", "plain"): 1}
    want = inline[0] + inline[1]
    want = inline[2] + want if residual else want
    assert torch.equal(out, want)
    used = 3 if residual else 2
    for a, w in zip(torch.autograd.grad(out, leaves[:used], g),
                    torch.autograd.grad(want, inline[:used], g)):
        assert torch.equal(a, w)


@pytest.mark.parametrize("residual", [False, True])
def test_kernel_function_gives_the_chains_gradients_and_only_those_asked(monkeypatch, residual):
    """The card's autograd function, run on the CPU with the chain in place
    of the launch: every gradient equals the chain's bit for bit, and b's
    reduction runs only when b's gradient is asked for (as autograd prunes
    the chain's): none in a backward to y alone."""
    monkeypatch.setattr(bias, "_launch", plain_add_bias)
    y, r, g = (_draw(64, 3, 8, dtype=torch.bfloat16, seed=s) for s in (1, 2, 3))
    b = _draw(8, dtype=torch.bfloat16, seed=4)
    leaves = [t.clone().requires_grad_() for t in (y, b, r)]
    inline = [t.clone().requires_grad_() for t in (y, b, r)]
    out = bias._kernel_add(leaves[0], leaves[1], leaves[2] if residual else None)
    want = plain_add_bias(inline[0], inline[1], inline[2] if residual else None)
    assert torch.equal(out, want)
    used = 3 if residual else 2
    for a, w in zip(torch.autograd.grad(out, leaves[:used], g, retain_graph=True),
                    torch.autograd.grad(want, inline[:used], g)):
        assert torch.equal(a, w)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.autograd.grad(out, leaves[0], g)
    assert not [e.name for e in prof.events() if e.name == "aten::sum"]


def test_cpu_tensors_run_the_plain_function_passed():
    """A CPU tensor runs ``plain(y, b, residual)``, whatever it computes."""
    seen = []

    def plain(y, b, residual):
        seen.append((y, b, residual))
        return plain_add_bias(y, b, residual) * 2

    y, b, r = _draw(4, 3), _draw(3, seed=1), _draw(4, 3, seed=2)
    assert torch.equal(add_bias(y, b, r, plain=plain), 2 * (r + (y + b)))
    assert len(seen) == 1 and seen[0][2] is r


@pytest.mark.parametrize("make,dims,stride", [
    (lambda: torch.empty(6, 5), 1, 1),                               # rows of a dense layer
    (lambda: torch.empty(2, 7, 5), 1, 1),
    (lambda: torch.empty(2, 5, 7).transpose(1, 2), 1, 7),           # a conv's (B, C, L) output
    (lambda: torch.empty(2, 7, 5), 2, 1),                            # the positions (L, D)
    (lambda: torch.empty(2, 5, 7).transpose(1, 2), 2, None),        # (L, D) out of order
    (lambda: torch.empty(6, 1), 1, 1),                               # one bias for all
    (lambda: torch.empty(6, 1, 5), 2, 1),
    (lambda: torch.empty(6, 10)[:, :5], 1, 1)])
def test_bias_stride_names_bs_step_in_ys_memory(make, dims, stride):
    assert bias.bias_stride(make(), dims) == stride


def test_operands_keep_a_dense_layout_and_copy_the_rest():
    """A conv's channel-first view keeps its layout, stride L; a y with gaps
    is made contiguous, stride 1; a residual in another layout is copied
    into y's."""
    ncl = torch.empty(2, 5, 7).transpose(1, 2)
    y, b, r, s = bias._operands(ncl, torch.empty(5), torch.empty(2, 7, 5))
    assert y is ncl and s == 7 and r.stride() == ncl.stride()
    gaps = torch.empty(6, 10)[:, :5]
    y, b, r, s = bias._operands(gaps, torch.empty(5), None)
    assert y.is_contiguous() and s == 1 and r is None


@pytest.mark.parametrize("y_dtype,b_dtype,b_shape,r_shape,match", [
    (torch.float16, torch.float16, (8,), None, "float32 or bfloat16"),
    (torch.float64, torch.float64, (8,), None, "float32 or bfloat16"),
    (torch.bfloat16, torch.float32, (8,), None, "dtype and device"),
    (torch.float32, torch.float32, (8,), (4, 8), "dtype and device"),
    (torch.float32, torch.float32, (1, 8), None, "trailing dimensions"),
    (torch.float32, torch.float32, (4,), None, "trailing dimensions"),
    (torch.float32, torch.float32, (), None, "trailing dimensions"),
    (torch.float32, torch.float32, (8,), (1, 8), "residual of y's shape")])
def test_operands_the_kernel_refuses_raise(y_dtype, b_dtype, b_shape, r_shape, match):
    y = torch.empty(4, 8, dtype=y_dtype)
    r_dtype = torch.float64 if r_shape == (4, 8) else y_dtype
    r = None if r_shape is None else torch.empty(r_shape, dtype=r_dtype)
    with pytest.raises(ValueError, match=match):
        bias.check_operands(y, torch.empty(b_shape, dtype=b_dtype), r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_operands_the_kernel_takes_pass(dtype):
    y = torch.empty(3, 4, 8, dtype=dtype)
    bias.check_operands(y, torch.empty(8, dtype=dtype), None)
    bias.check_operands(y, torch.empty(4, 8, dtype=dtype), torch.empty(3, 4, 8, dtype=dtype))


def _denses(tree) -> int:
    """The dense and conv layers of a parameter tree: dicts holding "w" and "b"."""
    if isinstance(tree, dict):
        return ("w" in tree and "b" in tree) + sum(_denses(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_denses(v) for v in tree)
    return 0


SMALL = dict(seq_length=16, latent_dim=4, gen_hidden_dim=8, enc_hidden_dims=(24, 16),
             disc_hidden_dims=(24, 12), mlp_gen_hidden_dims=(20, 20), tfm_d_model=16,
             tfm_num_heads=2, tfm_num_layers=2, time_head="monotone")


def _model_calls(name: str):
    """(calls, parameter tree) of one forward of model ``name`` at a small
    width on the CPU."""
    key = prng.PRNGKey(0)
    B, L = 3, SMALL["seq_length"]
    x = _draw(B, L, 3, seed=5)
    z = _draw(B, SMALL["latent_dim"], seed=6)
    if name in ("transformer", "mlp", "bilstm"):
        config = ModelConfig(**SMALL, generator_type=name, compute_dtype="bfloat16")
        params = gan.generator_init(config, key)
        run = lambda: gan.generator_apply(params, x, z, config, inference=name == "bilstm",
                                          pad_mask=torch.ones(B, L))
    elif name == "encoder":
        config = ModelConfig(**SMALL)
        params = gan.encoder_init(config, key)
        run = lambda: gan.encoder_apply(params, x, config, eps=z)
    elif name in ("temporal_critic", "mlp_critic"):
        config = ModelConfig(**SMALL, use_temporal_disc=name == "temporal_critic")
        params, state = gan.disc_init(config, key)
        run = lambda: gan.disc_apply(params, state, x, True, config)
    elif name == "autoencoder":
        params = gan.autoencoder_init(ModelConfig(**SMALL), key=key)
        run = lambda: gan.autoencoder_apply(params, x)
    elif name == "contrastive":
        config = ContrastiveConfig()
        params, state = contrastive.contrastive_encoder_init(config, key)
        run = lambda: contrastive.contrastive_encoder_apply(params, state, x, True)
    else:
        module = layers.Dense(3, 5, key)
        params = {"w": module.w, "b": module.b}
        run = lambda: module(x)
    before = _counts()
    run()
    return _moved(before), params


@pytest.mark.parametrize("name", ["transformer", "mlp", "bilstm", "encoder", "temporal_critic",
                                  "mlp_critic", "autoencoder", "contrastive", "dense"])
def test_every_bias_of_the_models_goes_through_the_op(name):
    """A forward makes one call of the op for each dense and conv layer of
    its tree (the transformer one more, for its positions), each on the
    plain path here; the transformer's attention output and second MLP layer
    carry the residual add of their block."""
    calls, params = _model_calls(name)
    adds = _denses(params) + (name == "transformer")
    if name == "transformer":
        residual = 2 * SMALL["tfm_num_layers"]
        assert calls == {("bias", "plain"): adds - residual, ("bias_residual", "plain"): residual}
    else:
        assert calls == {("bias", "plain"): adds}


def test_transformer_forward_equals_the_inline_chain():
    """The transformer's forward on the CPU, its residual adds folded into
    the dense layers' calls, equals the model as it was written before the
    op: ``h + (...)`` after each attention and MLP, the positions added as
    a (1, L, D) broadcast."""
    config = ModelConfig(**SMALL, generator_type="transformer", compute_dtype="bfloat16")
    params = gan.generator_init(config, prng.PRNGKey(1))
    B, L = 3, config.seq_length
    proto, z = _draw(B, L, 3, seed=7), _draw(B, config.latent_dim, seed=8)
    mask = (torch.arange(L)[None] < torch.tensor([[L], [9], [4]])).float()
    got = gan.generator_apply(params, proto, z, config, pad_mask=mask)

    dense = lambda p, x: x @ p["w"] + p["b"]
    p = layers.cast_floats({k: params[k] for k in ("embed", "pos", "blocks")}, torch.bfloat16)
    tokens = torch.cat([proto[..., :2], z[:, None, :].expand(B, L, z.shape[-1])], dim=-1)
    h = dense(p["embed"], tokens.to(torch.bfloat16)) + p["pos"][None, :L, :]
    for block in p["blocks"]:
        x = generators._layernorm(block["ln1"], h)
        qkv = dense(block["qkv"], x).reshape(B, L, 3, config.tfm_num_heads, -1)
        h = h + dense(block["attn_out"], generators.plain_attention(qkv, mask))
        h = h + dense(block["mlp2"], layers.gelu(dense(block["mlp1"],
                                                       generators._layernorm(block["ln2"], h))))
    h = generators._layernorm(params["ln_f"], h.to(torch.float32))
    want = gan.apply_time_head(dense(params["out"], h), config.time_head, pad_mask=mask)
    assert torch.equal(got, want)


def test_step_graph_replays_add_the_bias_launches():
    """A replayed graph (``StepGraph``, and ``SampleGraph`` through the same
    list) adds the launches its capture counted, the bias adds' among them,
    by op and path."""
    assert bias_launches in step_graph.COUNTED
    assert set(bias_launches.launches_by_path) == {
        (op, path) for op in bias.OPS for path in bias.PATHS}


def test_kernel_source_follows_the_wrapper():
    """``KINDS`` names ``csrc/bias.cu``'s paths in the order of its ``Kind``
    codes; a block is 256 threads and the grid at most as many blocks as an
    SM keeps of them; its one kernel carries the ``bias_`` prefix; its
    library is named like the others."""
    source = (CSRC_DIR / "bias.cu").read_text()
    enum = re.search(r"enum Kind \{([^}]*)\}", source).group(1)
    codes = {name.strip(): int(code) for name, code in
             (item.split("=") for item in enum.split(","))}
    assert codes == {"k" + kind.capitalize(): i for i, kind in enumerate(bias.KINDS)}
    threads = int(re.search(r"kThreads = (\d+);", source).group(1))
    assert bias._BLOCKS_PER_SM * threads == 2048     # an H100 SM's most threads
    kernels = re.findall(r"__global__ void __launch_bounds__\(.*?\)\s+(\w+)\(", source)
    assert kernels == ["bias_kernel"]
    assert library_path(bias.KERNEL).name.startswith("libbias-")
