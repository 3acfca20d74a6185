"""The port's last modules against their JAX twins, on the CPU: the batch
loaders, ``param_count``, the profiling helpers, the realism report, the
reference-weight converters, and the public API (every name the JAX
package's ``__init__`` files export resolves in the port, except the
TPU-only ones).

Reference-layout ``state_dict``s are made from numpy seeds with the CHI'23
reference implementation's key names and shapes and go through both
packages' converters. Tolerances: loaders, parameter counts and converted
weights exact; the realism statistics exact, ``dtw_w`` 1e-4 relative (the
JAX package's DTW and the port's plain version sum in different orders);
the generator on converted weights 1e-5 against the JAX ``generator_apply``.
"""

import importlib
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test worker

import wordgesture_gan_tpu as jax_pkg
from wordgesture_gan_tpu.configs import ModelConfig as JaxModelConfig
from wordgesture_gan_tpu.configs import TrainingConfig as JaxTrainingConfig
from wordgesture_gan_tpu.data import pipeline as jax_pipeline
from wordgesture_gan_tpu.data import realism as jax_realism
from wordgesture_gan_tpu.interop import torch_weights as jax_tw
from wordgesture_gan_tpu.models.gan import generator_apply as jax_generator_apply
from wordgesture_gan_tpu.ops import dtw as jax_dtw_module
from wordgesture_gan_tpu.ops.dtw_pallas import dtw_pairs_pallas
from wordgesture_gan_tpu.train.state import init_gan_state as jax_init_gan_state
from wordgesture_gan_tpu.train.state import param_count as jax_param_count
from wordgesture_gan_tpu.utils import profiling as jax_profiling
import wordgesture_gan_tpu_torch as port_pkg
from wordgesture_gan_tpu_torch.configs import ModelConfig
from wordgesture_gan_tpu_torch.data import pipeline, realism
from wordgesture_gan_tpu_torch.interop import torch_weights as tw
from wordgesture_gan_tpu_torch.models.gan import generator_apply
from wordgesture_gan_tpu_torch.ops import fastdtw_approx
from wordgesture_gan_tpu_torch.train.state import init_gan_state, param_count
from wordgesture_gan_tpu_torch.utils import profiling
from wordgesture_gan_tpu_torch.utils.tree import tree_leaves
from wordgesture_gan_tpu_torch.utils import prng

SMALL = dict(seq_length=16, gen_hidden_dim=8, gen_num_layers=2, latent_dim=4,
             enc_hidden_dims=(24, 16), disc_hidden_dims=(12, 6))


# -- loaders, parameter counts, profiling --------------------------------------------------


def _arrays(n=23, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n, 8, 3)).astype(np.float32)
    p = rng.normal(size=(n, 8, 3)).astype(np.float32)
    return [f"w{i % 5}" for i in range(n)], g, p


@pytest.mark.parametrize("batch_size,seed", [(5, 0), (8, 3), (30, 1)])
def test_data_loaders_yield_the_jax_batches(batch_size, seed):
    words, g, p = _arrays()
    ours = pipeline.create_data_loaders(pipeline.GestureArrays(g, p, words),
                                        pipeline.GestureArrays(g[:7], p[:7], words[:7]),
                                        batch_size=batch_size, seed=seed)
    theirs = jax_pipeline.create_data_loaders(jax_pipeline.GestureArrays(g, p, words),
                                              jax_pipeline.GestureArrays(g[:7], p[:7], words[:7]),
                                              batch_size=batch_size, seed=seed)
    for a, b in zip(ours, theirs):
        assert len(a) == len(b)
        for _ in range(2):                   # a second pass draws a new permutation
            got, want = list(a), list(b)
            assert len(got) == len(want)
            for x, y in zip(got, want):
                assert x["word"] == y["word"]
                np.testing.assert_array_equal(x["gesture"], y["gesture"])
                np.testing.assert_array_equal(x["prototype"], y["prototype"])
    assert pipeline.GestureDataset is pipeline.GestureArrays


@pytest.mark.parametrize("model", [{}, dict(use_temporal_disc=False)])
def test_param_count_matches_jax(model):
    cfg = dict(SMALL, **model)
    want = jax_param_count(jax_init_gan_state(jax.random.PRNGKey(0), JaxModelConfig(**cfg),
                                              JaxTrainingConfig()))
    assert param_count(init_gan_state(0, ModelConfig(**cfg), "cpu")) == want


def test_throughput_matches_jax():
    ours, theirs = profiling.Throughput(n_chips=2), jax_profiling.Throughput(n_chips=2)
    for n, dt in ((512, 0.5), (1024, 0.75)):
        ours.update(n, dt)
        theirs.update(n, dt)
    assert ours.summary() == theirs.summary()
    assert profiling.Throughput().n_chips == 1           # no process group: one chip


def test_trace_profile_writes_a_trace(tmp_path):
    with profiling.trace_profile(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    (trace,) = (tmp_path / "trace").glob("trace_rank0_*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with profiling.trace_profile(None) as prof:
        pass
    assert prof is None


def test_fastdtw_shim_installs_the_ports_copy(monkeypatch):
    import sys

    monkeypatch.delitem(sys.modules, "fastdtw", raising=False)
    monkeypatch.setattr("builtins.__import__", _no_fastdtw(__import__))
    fastdtw_approx.install_fastdtw_shim()
    assert sys.modules["fastdtw"].fastdtw is fastdtw_approx.fastdtw


def _no_fastdtw(real_import):
    def fake(name, *args, **kwargs):
        if name == "fastdtw":
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    return fake


# -- realism -----------------------------------------------------------------------------------


@pytest.mark.parametrize("jax_dtw", ["pallas_interpret", "xla_sweep"])
def test_synthetic_sentence_stats_match_jax(synthetic_zip, monkeypatch, jax_dtw):
    """The four exact statistics bit-equal; ``dtw_w`` 1e-4 relative against
    the JAX package with its batched DTW run either way: by the Pallas
    kernel in interpret mode (measured 1.3e-5: the port's plain version
    subtracts float32 prefix sums of up to 64 pixel-scale costs) and by its
    default XLA row sweep (measured 8.2e-5: its x² + y² − 2xy point costs
    lose more bits on pixel coordinates, as in tests/test_torch_dtw.py)."""
    if jax_dtw == "pallas_interpret":
        monkeypatch.setattr(jax_dtw_module, "dtw_pairs", lambda x, y: dtw_pairs_pallas(
            jnp.asarray(x), jnp.asarray(y), pair_tile=128, interpret=True))
    got = realism.synthetic_sentence_stats(synthetic_zip, device="cpu")
    want = jax_realism.synthetic_sentence_stats(synthetic_zip)
    assert set(got) == set(want) == set(realism.STATS)
    for k in realism.STATS:
        if k == "dtw_w":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
        else:
            np.testing.assert_array_equal(got[k], want[k])
    assert len(got["dtw_w"]) > 0


def test_real_stats_and_report_match_jax():
    got, want = realism.load_real_sentence_stats(), jax_realism.load_real_sentence_stats()
    for k in realism.STATS:
        np.testing.assert_array_equal(got[k], want[k])
    syn = {k: v[:50] * 0.9 for k, v in want.items()}
    rows, jrows = realism.compare_to_real(syn, got), jax_realism.compare_to_real(syn, want)
    assert [r.__dict__ for r in rows] == [r.__dict__ for r in jrows]
    assert realism.format_report(rows) == jax_realism.format_report(jrows)


def test_realism_cli_on_the_cpu(synthetic_zip, tmp_path, capsys):
    out = tmp_path / "stats.npz"
    code = realism.main(["--zip", synthetic_zip, "--users", "6", "--device", "cpu",
                         "--save-stats", str(out)])
    assert code in (0, 1)
    assert "realism report" in capsys.readouterr().out
    saved = np.load(out)
    want = jax_realism.synthetic_sentence_stats(synthetic_zip, max_users=6)
    np.testing.assert_array_equal(saved["time_ms"], want["time_ms"])


def test_realism_cli_defaults_to_the_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_info:
        realism.main(["--users", "1"])
    assert exit_info.value.code == 2 and "no CUDA device" in capsys.readouterr().err


# -- reference weights ------------------------------------------------------------------------


def _linear(rng, sd, prefix, n_in, n_out, sn=False):
    sd[f"{prefix}.weight_orig" if sn else f"{prefix}.weight"] = rng.normal(
        size=(n_out, n_in)).astype(np.float32)
    sd[f"{prefix}.bias"] = rng.normal(size=(n_out,)).astype(np.float32)
    if sn:
        sd[f"{prefix}.weight_u"] = rng.normal(size=(n_out,)).astype(np.float32)
        sd[f"{prefix}.weight_v"] = rng.normal(size=(n_in,)).astype(np.float32)


def _conv(rng, sd, prefix, cin, cout, k, sn=False):
    sd[f"{prefix}.weight_orig" if sn else f"{prefix}.weight"] = rng.normal(
        size=(cout, cin, k)).astype(np.float32)
    sd[f"{prefix}.bias"] = rng.normal(size=(cout,)).astype(np.float32)
    if sn:
        sd[f"{prefix}.weight_u"] = rng.normal(size=(cout,)).astype(np.float32)


def reference_state_dicts(cfg: ModelConfig, seed: int = 0) -> dict:
    """Seeded {name: array} state dicts with the reference models' keys and
    shapes: generator, encoder, MLP and temporal critics, FID autoencoder,
    contrastive encoder."""
    rng = np.random.default_rng(seed)
    H, L, Z = cfg.gen_hidden_dim, cfg.seq_length, cfg.latent_dim
    gen = {}
    for k in range(cfg.gen_num_layers):
        n_in = (2 + Z) if k == 0 else 2 * H
        for suffix in ("", "_reverse"):
            gen[f"lstm.weight_ih_l{k}{suffix}"] = rng.normal(size=(4 * H, n_in)).astype(np.float32)
            gen[f"lstm.weight_hh_l{k}{suffix}"] = rng.normal(size=(4 * H, H)).astype(np.float32)
            gen[f"lstm.bias_ih_l{k}{suffix}"] = rng.normal(size=(4 * H,)).astype(np.float32) * .1
            gen[f"lstm.bias_hh_l{k}{suffix}"] = rng.normal(size=(4 * H,)).astype(np.float32) * .1
    for key in [k for k in gen if "weight" in k]:
        gen[key] *= 0.3
    _linear(rng, gen, "output_layer", 2 * H, 3)
    enc = {}
    dims = (L * 3,) + tuple(cfg.enc_hidden_dims)
    for i in range(len(dims) - 1):
        _linear(rng, enc, f"encoder.{2 * i}", dims[i], dims[i + 1])
    _linear(rng, enc, "fc_mu", dims[-1], Z)
    _linear(rng, enc, "fc_log_var", dims[-1], Z)
    mlp = {}
    dims = (L * 3,) + tuple(cfg.disc_hidden_dims)
    for i in range(len(dims) - 1):
        _linear(rng, mlp, f"layers.{i}", dims[i], dims[i + 1], sn=True)
    _linear(rng, mlp, "output_layer", dims[-1], 1, sn=True)
    temporal = {}
    for idx, (cin, cout, k) in zip((0, 2, 4), ((3, 64, 5), (64, 64, 5), (64, 32, 3))):
        _conv(rng, temporal, f"temporal_conv.{idx}", cin, cout, k, sn=True)
    _linear(rng, temporal, "mlp.0", 32 * 8, 128, sn=True)
    _linear(rng, temporal, "mlp.2", 128, 64, sn=True)
    _linear(rng, temporal, "output_layer", 64, 1, sn=True)
    ae = {}
    for i, (a, b) in zip((0, 2, 4, 6), ((3, 192), (192, 96), (96, 48), (48, 32))):
        _linear(rng, ae, f"timestep_encoder.{i}", a, b)
    _linear(rng, ae, "post_pool", 32, 32)
    _linear(rng, ae, "pre_expand", 32, 32)
    for i, (a, b) in zip((0, 2, 4, 6), ((32, 48), (48, 96), (96, 192), (192, 3))):
        _linear(rng, ae, f"timestep_decoder.{i}", a, b)
    con = {}
    for (ci, bi), (cin, cout, k) in zip(((0, 1), (3, 4), (6, 7)),
                                        ((3, 32, 7), (32, 64, 5), (64, 128, 3))):
        _conv(rng, con, f"conv_layers.{ci}", cin, cout, k)
        con[f"conv_layers.{bi}.weight"] = rng.normal(size=(cout,)).astype(np.float32)
        con[f"conv_layers.{bi}.bias"] = rng.normal(size=(cout,)).astype(np.float32)
        con[f"conv_layers.{bi}.running_mean"] = rng.normal(size=(cout,)).astype(np.float32)
        con[f"conv_layers.{bi}.running_var"] = rng.uniform(0.5, 2, size=(cout,)).astype(
            np.float32)
    _linear(rng, con, "projection.0", 128, 64)
    _linear(rng, con, "projection.2", 64, 64)
    return {"generator": gen, "encoder": enc, "mlp_disc": mlp, "temporal_disc": temporal,
            "autoencoder": ae, "contrastive": con}


def _by_path(tree, prefix=""):
    """{path: numpy leaf} of a nested dict/list tree (the port's tensors or
    the JAX package's arrays), so leaf order does not matter."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _by_path(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree) for p, v in _by_path(x, f"{prefix}/{i}").items()}
    if torch.is_tensor(tree):
        assert tree.dtype == torch.float32
        return {prefix: tree.detach().numpy()}
    return {prefix: np.asarray(tree)}


def _assert_trees_equal(got, want):
    got, want = _by_path(got), _by_path(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


CONVERTERS = {
    "generator": ("generator_from_torch", True),
    "encoder": ("encoder_from_torch", True),
    "mlp_disc": ("mlp_disc_from_torch", True),
    "temporal_disc": ("temporal_disc_from_torch", True),
    "autoencoder": ("autoencoder_from_torch", True),
    "contrastive": ("contrastive_encoder_from_torch", False),
}


@pytest.mark.parametrize("kind", sorted(CONVERTERS))
def test_converters_match_jax(kind):
    cfg = ModelConfig(**SMALL)
    sd = reference_state_dicts(cfg)[kind]
    name, takes_config = CONVERTERS[kind]
    args = (sd, cfg) if takes_config else (sd,)
    jargs = (sd, JaxModelConfig(**SMALL)) if takes_config else (sd,)
    _assert_trees_equal(getattr(tw, name)(*args), getattr(jax_tw, name)(*jargs))


@pytest.mark.parametrize("temporal", [True, False])
def test_disc_from_torch_picks_the_configured_critic(temporal):
    cfg = ModelConfig(**SMALL, use_temporal_disc=temporal)
    sd = reference_state_dicts(cfg)["temporal_disc" if temporal else "mlp_disc"]
    _assert_trees_equal(tw.disc_from_torch(sd, cfg),
                        jax_tw.disc_from_torch(sd, JaxModelConfig(**SMALL,
                                                                  use_temporal_disc=temporal)))


def test_trainer_state_from_torch_matches_jax():
    """A reference trainer checkpoint → the port's train state: the JAX
    converter's weights and u vectors, fresh Adam moments, epoch 0; the
    port's own init tree shapes, so the state trains and checkpoints as any."""
    cfg = ModelConfig(**SMALL)
    sds = reference_state_dicts(cfg, seed=1)
    ckpt = {"generator": sds["generator"], "encoder": sds["encoder"],
            "discriminator_1": sds["temporal_disc"],
            "discriminator_2": reference_state_dicts(cfg, seed=2)["temporal_disc"]}
    state = tw.trainer_state_from_torch(ckpt, cfg, seed=5, device="cpu")
    want = jax.device_get(jax_tw.trainer_state_from_torch(ckpt, JaxModelConfig(**SMALL),
                                                          JaxTrainingConfig(), 0))
    fresh = init_gan_state(0, cfg, "cpu")
    for m in ("g", "e", "d1", "d2"):
        _assert_trees_equal(state[m]["params"], want[m]["params"])
        assert [t.shape for t in tree_leaves(state[m]["params"])] == \
            [t.shape for t in tree_leaves(fresh[m]["params"])]
        assert all(float(t.abs().max()) == 0 for t in tree_leaves(state[m]["opt"]["mu"]))
        assert state[m]["opt"]["count"] == 0
    for m in ("d1", "d2"):
        _assert_trees_equal(state[m]["sn"], want[m]["sn"])
    assert state["epoch"] == 0
    assert torch.equal(state["rng"], prng.PRNGKey(5))


def test_generator_on_converted_weights_matches_jax():
    cfg = ModelConfig(**SMALL)
    sd = reference_state_dicts(cfg, seed=3)["generator"]
    rng = np.random.default_rng(4)
    proto = rng.uniform(-1, 1, (5, cfg.seq_length, 3)).astype(np.float32)
    z = rng.normal(size=(5, cfg.latent_dim)).astype(np.float32)
    got = generator_apply(tw.generator_from_torch(sd, cfg), torch.from_numpy(proto),
                          torch.from_numpy(z), cfg)
    want = jax_generator_apply(jax_tw.generator_from_torch(sd, JaxModelConfig(**SMALL)),
                               jnp.asarray(proto), jnp.asarray(z), JaxModelConfig(**SMALL))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


# -- the public API -------------------------------------------------------------------------

# Names of the JAX package the port leaves out: XLA's epoch scan, the
# parallel helpers that are XLA transfers or sharding annotations, and
# ``StepTimer``, which nothing in the port read (the port names its host work
# with ``utils/profiling.span``).
LEFT_OUT = {"train": {"gan_train_epoch"},
            "parallel": {"packed_replicate", "batch_sharding", "replicated"},
            "utils": {"StepTimer"}}
SUBPACKAGES = ("", "data", "train", "metrics", "eval", "models", "ops", "interop", "utils",
               "parallel")


# The JAX package's lazy top-level names (its ``__getattr__`` table).
LAZY = {"load_dataset_from_zip", "create_train_test_split", "create_data_loaders",
        "GestureDataset", "infer_key_positions", "create_contrastive_datasets", "train_gan",
        "generate_gestures", "train_contrastive", "init_gan_state", "evaluate_all_metrics",
        "evaluate_gan_and_minjerk", "plot_gestures_on_keyboard", "create_comparison_figure",
        "create_overlay_figure"}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_public_api_covers_the_jax_packages(sub):
    jax_mod = importlib.import_module("wordgesture_gan_tpu" + (f".{sub}" if sub else ""))
    port_mod = importlib.import_module("wordgesture_gan_tpu_torch" + (f".{sub}" if sub else ""))
    want = {n for n in dir(jax_mod) if not n.startswith("_")
            and not isinstance(getattr(jax_mod, n), types.ModuleType)
            and getattr(getattr(jax_mod, n), "__module__", "").startswith("wordgesture_gan_tpu")}
    if not sub:
        want |= LAZY | {"__version__"}
        assert all(getattr(jax_pkg, n) is not None for n in LAZY)
    want -= LEFT_OUT.get(sub, set())
    missing = sorted(n for n in want if not hasattr(port_mod, n))
    assert not missing, f"{port_mod.__name__} lacks {missing}"
    if not sub:
        assert port_pkg.train_gan.__module__ == "wordgesture_gan_tpu_torch.train.gan_loop"
