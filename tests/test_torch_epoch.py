"""The port's scanned epoch (``gan_train_epoch``, ``gan_train_epoch_masked``,
``RuntimeConfig.scan_epoch``) against the JAX package's ``lax.scan`` epochs
and against the port's own eager steps, on the CPU.

Small sizes: a 2-layer BiLSTM generator with H=16, L=16, B=8, 3 batches an
epoch (the masked epoch: the transformer at d_model 16, L=16). Weights and
the train state are JAX's, carried over by ``interop.from_jax``; each step's
noise is re-derived from the JAX state's key by repeating the step's splits.
Tolerances, float32, as in ``tests/test_torch_train_step.py``: losses 1e-4
relative to max(1, |loss|); parameters within 2·lr per Adam step taken (a
last-ulp difference in a near-zero gradient flips the sign Adam's update
maps it to). The epoch against a loop of eager steps, ``apply_update``'s two
forms of learning rate and step count, and ``train_gan`` with and without
``scan_epoch`` are bit-equal: the same float32 operations in the same order.
On a CUDA device the epoch is a captured CUDA graph; ``tests/test_torch_cuda.py``
holds it against the eager epoch there.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch_threads  # noqa: F401  one torch thread per test worker

from wordgesture_gan_tpu.configs import ModelConfig as JaxModelConfig
from wordgesture_gan_tpu.configs import TrainingConfig as JaxTrainingConfig
from wordgesture_gan_tpu.train import gan_train_epoch as jax_gan_train_epoch
from wordgesture_gan_tpu.train import masked_step as jax_masked_step
from wordgesture_gan_tpu.train.state import init_gan_state as jax_init_gan_state
from wordgesture_gan_tpu_torch.configs import ModelConfig, RuntimeConfig, TrainingConfig
from wordgesture_gan_tpu_torch.data import variable_length as vl
from wordgesture_gan_tpu_torch.data.pipeline import GestureArrays
from wordgesture_gan_tpu_torch.interop.from_jax import adam_moments, train_state_from_jax
from wordgesture_gan_tpu_torch.parallel.mesh import Mesh, require_capturable
from wordgesture_gan_tpu_torch.train import gan_train_epoch
from wordgesture_gan_tpu_torch.train.gan_loop import train_gan
from wordgesture_gan_tpu_torch.train.gan_step import METRIC_KEYS, gan_train_step
from wordgesture_gan_tpu_torch.train.masked_step import (gan_train_epoch_masked,
                                                         gan_train_step_masked)
from wordgesture_gan_tpu_torch.train.state import (MODELS, _inverse_correction_table,
                                                   apply_update, init_gan_state,
                                                   inverse_bias_corrections)
from wordgesture_gan_tpu_torch.train.variable_loop import train_variable_gan
from wordgesture_gan_tpu_torch.utils.tree import tree_leaves

N_BATCHES, B, L, Z, LR = 3, 8, 16, 4, 2e-4
MODEL = dict(seq_length=L, gen_hidden_dim=16, gen_num_layers=2, latent_dim=Z,
             enc_hidden_dims=(24, 16), time_head="monotone")
MASKED_MODEL = dict(seq_length=L, latent_dim=Z, tfm_d_model=16, tfm_num_heads=2,
                    tfm_num_layers=2, enc_hidden_dims=(24, 16), generator_type="transformer",
                    time_head="monotone")
# The reference recipe, and the flagship one (λ_speed 2, λ_div 0.3, λ_dtc 4).
RECIPES = {"reference": dict(batch_size=B, n_critic=2),
           "flagship": dict(batch_size=B, n_critic=2, lambda_speed=2.0, lambda_div=0.3,
                            lambda_dtc=4.0, div_margin=0.25)}
MASKED_RECIPE = dict(batch_size=B, n_critic=2, lambda_dt=1.0, lambda_speed=2.0, lambda_dtc=4.0)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _paths(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree) for p, v in _paths(x, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _epoch_batches(seed, masked=False):
    """(N_BATCHES, B, L, ...) gestures with a monotone clock, prototypes and,
    for the masked epoch, masks of varied lengths."""
    rng = np.random.default_rng(seed)
    gesture = rng.uniform(-1, 1, (N_BATCHES, B, L, 3)).astype(np.float32)
    gesture[..., 2] = np.sort(rng.uniform(0, 1, (N_BATCHES, B, L)), axis=-1)
    batches = {"gesture": gesture,
               "prototype": rng.uniform(-1, 1, (N_BATCHES, B, L, 3)).astype(np.float32)}
    if masked:
        lengths = rng.integers(6, L + 1, (N_BATCHES, B))
        lengths[:, 0] = L
        batches["mask"] = np.stack([vl.length_mask(n, L) for n in lengths])
    return batches


def _jax_epoch_draws(key, n_critic, diversity):
    """Each step's draws, stacked over the epoch, as the JAX steps of a
    ``lax.scan`` epoch take them from the state's key: per critic iteration
    split(rng, 3), then split(rng, 4), then split(rng) for the second prior
    draw when a diversity term is on; the key that is left goes on."""
    draws = []
    for _ in range(N_BATCHES):
        zkeys, ekeys = [], []
        for _ in range(n_critic):
            key, kz, ke = jax.random.split(key, 3)
            zkeys.append(kz)
            ekeys.append(ke)
        key, kz1, ke1, ke2 = jax.random.split(key, 4)

        def normal(k):
            return np.array(jax.random.normal(k, (B, Z)), np.float32)

        step = {"z_rand": np.stack([normal(k) for k in zkeys]),
                "eps_enc": np.stack([normal(k) for k in ekeys]),
                "z1": normal(kz1), "eps_rec": normal(ke1), "eps2": normal(ke2)}
        if diversity:
            key, kz_ms = jax.random.split(key)
            step["z_ms"] = normal(kz_ms)
        draws.append(step)
    return {k: torch.from_numpy(np.stack([d[k] for d in draws])) for k in draws[0]}


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _check_against_jax(start, ref_state, ref_traces, state, traces, tcfg, want_shapes):
    """Trace keys, shapes and losses (1e-4 relative), the epoch, Adam's step
    counts and the parameters (2·lr per Adam step) against JAX's epoch."""
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want_shapes.items()} == {
        k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in traces.items()}
    assert tuple(traces) == tuple(k for k in traces if k in want_shapes)
    for k, v in traces.items():
        want = np.asarray(ref_traces[k])
        err = np.abs(v.numpy() - want) / np.maximum(1.0, np.abs(want))
        assert err.max() <= 1e-4, (k, v.numpy(), want)
    assert state["epoch"] == int(ref_state["epoch"]) == int(start["epoch"]) + 1
    for m in MODELS:
        adam_steps = N_BATCHES * (tcfg["n_critic"] if m in ("d1", "d2") else 1)
        assert state[m]["opt"]["count"] == adam_moments(ref_state[m]["opt"])["count"] == adam_steps
        ref, got = _paths(ref_state[m]["params"]), _paths(state[m]["params"])
        assert set(ref) == set(got)
        for path, leaf in got.items():
            np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(ref[path]), rtol=0,
                                       atol=2 * LR * adam_steps, err_msg=f"{m}{path}")


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_epoch_matches_jax_scan(recipe):
    """``gan_train_epoch`` against JAX's ``lax.scan`` epoch from one state, on
    the same batches and the draws JAX's steps take from its key."""
    tcfg = RECIPES[recipe]
    jcfg, jtcfg = JaxModelConfig(**MODEL), JaxTrainingConfig(**tcfg)
    start = jax.device_get(jax_init_gan_state(0, jcfg, jtcfg))
    batches = _epoch_batches(1)
    jax_epoch = jax.jit(lambda s, eb: jax_gan_train_epoch(s, eb, jnp.float32(LR), jcfg, jtcfg))
    jax_batches = jax.tree.map(jnp.asarray, batches)
    ref_state, ref_traces = jax.device_get(jax_epoch(start, jax_batches))
    want_shapes = jax.eval_shape(jax_epoch, start, jax_batches)[1]
    diversity = bool(tcfg.get("lambda_div"))
    noise = _jax_epoch_draws(start["rng"], tcfg["n_critic"], diversity)
    state = train_state_from_jax(start, device="cpu")
    state, traces = gan_train_epoch(state, _torch(batches), LR, ModelConfig(**MODEL),
                                    TrainingConfig(**tcfg), noise=noise)
    assert tuple(traces) == METRIC_KEYS
    _check_against_jax(start, ref_state, ref_traces, state, traces, tcfg, want_shapes)


def test_masked_epoch_matches_jax_scan():
    """``gan_train_epoch_masked`` against JAX's masked ``lax.scan`` epoch."""
    jcfg, jtcfg = JaxModelConfig(**MASKED_MODEL), JaxTrainingConfig(**MASKED_RECIPE)
    start = jax.device_get(jax_init_gan_state(0, jcfg, jtcfg))
    batches = _epoch_batches(2, masked=True)
    jax_epoch = jax.jit(lambda s, eb: jax_masked_step.gan_train_epoch_masked(
        s, eb, jnp.float32(LR), jcfg, jtcfg))
    jax_batches = jax.tree.map(jnp.asarray, batches)
    ref_state, ref_traces = jax.device_get(jax_epoch(start, jax_batches))
    want_shapes = jax.eval_shape(jax_epoch, start, jax_batches)[1]
    noise = _jax_epoch_draws(start["rng"], MASKED_RECIPE["n_critic"], False)
    state = train_state_from_jax(start, device="cpu")
    state, traces = gan_train_epoch_masked(state, _torch(batches), LR,
                                           ModelConfig(**MASKED_MODEL),
                                           TrainingConfig(**MASKED_RECIPE), noise=noise)
    _check_against_jax(start, ref_state, ref_traces, state, traces, MASKED_RECIPE, want_shapes)


def _everything(state):
    """Every tensor of a train state, the counts, the epoch and the key, in
    a fixed order."""
    return ([t.detach().clone() for m in MODELS for t in tree_leaves(state[m])
             if torch.is_tensor(t)],
            [state[m]["opt"]["count"] for m in MODELS], state["epoch"],
            state["rng"].clone())


def _assert_bit_equal(a, b):
    (ta, ca, ea, ra), (tb, cb, eb, rb) = a, b
    assert len(ta) == len(tb) and all(torch.equal(x, y) for x, y in zip(ta, tb))
    assert ca == cb and ea == eb and torch.equal(ra, rb)


@pytest.mark.parametrize("masked", [False, True], ids=["fixed", "masked"])
def test_epoch_equals_a_loop_of_eager_steps(masked):
    """Drawing its own noise from ``state["rng"]``, the epoch on the CPU is
    the eager loop: traces, parameters, moments, u vectors, step counts and
    the key bit-equal."""
    mcfg = ModelConfig(**(MASKED_MODEL if masked else MODEL))
    tcfg = TrainingConfig(**(MASKED_RECIPE if masked else RECIPES["flagship"]))
    epoch, step = ((gan_train_epoch_masked, gan_train_step_masked) if masked
                   else (gan_train_epoch, gan_train_step))
    batches = _torch(_epoch_batches(3, masked))
    scanned, looped = init_gan_state(4, mcfg, "cpu"), init_gan_state(4, mcfg, "cpu")
    _, traces = epoch(scanned, batches, LR, mcfg, tcfg)
    rows = [step(looped, {k: v[i] for k, v in batches.items()}, LR, mcfg, tcfg)[1]
            for i in range(N_BATCHES)]
    looped["epoch"] += 1
    for k, v in traces.items():
        assert v.shape == (N_BATCHES,)
        assert torch.equal(v, torch.stack([r[k] for r in rows])), k
    _assert_bit_equal(_everything(scanned), _everything(looped))


@pytest.mark.parametrize("masked", [False, True], ids=["fixed", "masked"])
def test_step_keeps_every_state_tensor_at_its_address(masked):
    """A replayed CUDA graph reads the addresses its capture saw: after each
    step every tensor of the state (parameters, Adam moments, the critics'
    u vectors) is the same storage, and the u vectors have moved."""
    mcfg = ModelConfig(**(MASKED_MODEL if masked else MODEL))
    tcfg = TrainingConfig(**(MASKED_RECIPE if masked else RECIPES["flagship"]))
    step = gan_train_step_masked if masked else gan_train_step
    batches = _torch(_epoch_batches(5, masked))
    state = init_gan_state(0, mcfg, "cpu")
    tensors = [t for m in MODELS for t in tree_leaves(state[m]) if torch.is_tensor(t)]
    addresses = [t.data_ptr() for t in tensors]
    for i in range(2):
        u = [t.clone() for t in tree_leaves(state["d1"]["sn"])]
        step(state, {k: v[i] for k, v in batches.items()}, LR, mcfg, tcfg)
        after = [t for m in MODELS for t in tree_leaves(state[m]) if torch.is_tensor(t)]
        assert [t.data_ptr() for t in after] == addresses
        assert all(a is b for a, b in zip(after, tensors))
        assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(state["d1"]["sn"]), u))


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_apply_update_with_device_lr_and_count_is_bit_equal(clip):
    """``apply_update`` with a 0-d tensor learning rate and a 0-d int64 step
    count (the captured step's form) against a Python float and int, over
    five updates; the tensor count advances in place."""
    rng = np.random.default_rng(0)
    shapes = [(7, 5), (5,), (3, 2, 4)]
    params = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in shapes]
    a = [p.clone() for p in params], {"mu": [torch.zeros(s) for s in shapes],
                                      "nu": [torch.zeros(s) for s in shapes], "count": 0}
    count = torch.zeros((), dtype=torch.int64)
    b = [p.clone() for p in params], {"mu": [torch.zeros(s) for s in shapes],
                                      "nu": [torch.zeros(s) for s in shapes], "count": count}
    lr = 3e-4
    for _ in range(5):
        grads = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in shapes]
        apply_update(a[0], grads, a[1], lr, clip)
        apply_update(b[0], grads, b[1], torch.tensor(lr, dtype=torch.float32), clip)
        assert b[1]["count"] is count and int(count) == a[1]["count"]
        for x, y in zip(a[0] + a[1]["mu"] + a[1]["nu"], b[0] + b[1]["mu"] + b[1]["nu"]):
            assert torch.equal(x, y)


# The β2 table's last row (the first count whose correction rounds to 1.0)
# and the counts around it.
TABLE_END = _inverse_correction_table(0.999, torch.device("cpu")).shape[0]


@pytest.mark.parametrize("count", [1, 2, 25, 26, 1000, TABLE_END - 1, TABLE_END, 40000])
def test_bias_corrections_on_the_device_equal_the_host_numbers(count):
    """The table a captured step reads holds 1 / (1 - β^count) rounded to
    float32, and 1.0 past its end, as a kernel rounds the Python numbers."""
    for b1, b2 in ((0.5, 0.999), (0.9, 0.999)):
        host = inverse_bias_corrections(count, b1, b2)
        device = inverse_bias_corrections(torch.tensor(count), b1, b2)
        for h, d in zip(host, device):
            assert d.dtype == torch.float32 and d.dim() == 0
            assert d.item() == float(np.float32(h))
    assert _inverse_correction_table(0.999, torch.device("cpu"))[-1].item() == 1.0
    assert _inverse_correction_table(0.999, torch.device("cpu"))[-2].item() > 1.0


def _dataset(n=28, seed=5):
    rng = np.random.default_rng(seed)
    g = rng.uniform(-1, 1, (n, L, 3)).astype(np.float32)
    g[..., 2] = np.sort(rng.uniform(0, 1, (n, L)), axis=1)
    return GestureArrays(g, rng.uniform(-1, 1, (n, L, 3)).astype(np.float32),
                         [f"w{i % 6}" for i in range(n)])


def _train(tmp_path, name, scan, epochs, masked=False):
    ckpt = tmp_path / name
    runtime = RuntimeConfig(scan_epoch=scan)
    if masked:
        ds = vl.VariableGestureArrays(*_variable_arrays())
        return train_variable_gan(ds, ModelConfig(**MASKED_MODEL),
                                  TrainingConfig(**MASKED_RECIPE, save_every=1), runtime,
                                  num_epochs=epochs, checkpoint_dir=str(ckpt), device="cpu",
                                  verbose=False), ckpt
    tcfg = TrainingConfig(**dict(RECIPES["flagship"], div_margin=None), save_every=1)
    return train_gan(_dataset(), ModelConfig(**MODEL), tcfg, runtime, num_epochs=epochs,
                     checkpoint_dir=str(ckpt), device="cpu", verbose=False), ckpt


def _variable_arrays(n=20, seed=6):
    rng = np.random.default_rng(seed)
    g = rng.uniform(-1, 1, (n, L, 3)).astype(np.float32)
    g[..., 2] = np.sort(rng.uniform(0, 1, (n, L)), axis=1)
    lengths = rng.integers(6, L + 1, n)
    return (g, rng.uniform(-1, 1, (n, L, 3)).astype(np.float32), lengths,
            [f"w{i % 5}" for i in range(n)])


@pytest.mark.parametrize("masked", [False, True], ids=["train_gan", "train_variable_gan"])
def test_scan_epoch_trains_like_the_eager_loop(tmp_path, masked):
    """``RuntimeConfig.scan_epoch`` on the CPU: the history, every checkpoint
    and a resumed epoch equal the eager loop's, bit for bit."""
    runs = {}
    for scan in (True, False):
        first, ckpt = _train(tmp_path, f"scan{scan}", scan, 2, masked)
        resumed, _ = _train(tmp_path, f"scan{scan}", scan, 3, masked)
        runs[scan] = first, resumed, ckpt
    (f1, r1, c1), (f0, r0, c0) = runs[True], runs[False]
    assert len(f1.history) == 2 and len(r1.history) == 1
    assert f1.history == f0.history and r1.history == r0.history
    _assert_bit_equal(_everything(r1.state), _everything(r0.state))
    for epoch in (1, 2, 3):
        a = torch.load(c1 / f"epoch_{epoch}.pt", weights_only=False)
        b = torch.load(c0 / f"epoch_{epoch}.pt", weights_only=False)
        pa, pb = _paths({k: a[k] for k in MODELS}), _paths({k: b[k] for k in MODELS})
        assert set(pa) == set(pb)
        for path, v in pa.items():
            assert (torch.equal(v, pb[path]) if torch.is_tensor(v) else v == pb[path]), path
            assert not torch.is_tensor(v) or v.device.type == "cpu"
        assert torch.equal(a["rng"], b["rng"]) and a["epoch"] == b["epoch"] == epoch
        assert all(isinstance(a[m]["opt"]["count"], int) for m in MODELS)
    lines = [json.loads(x) for x in (c1 / "history.jsonl").read_text().splitlines()]
    assert lines == [json.loads(x) for x in (c0 / "history.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("scan", [False, True], ids=["eager", "scan_epoch"])
def test_a_resumed_run_continues_the_key_chain(tmp_path, scan):
    """Two epochs, then a third resumed from the checkpoint, equal three
    epochs in one call: the checkpoint carries the key, and the resumed
    run draws on from it (and reshuffles by its epoch), bit for bit. The
    learning rate is held constant, so that the two calls' schedules (2 and
    3 epochs long) agree."""
    tcfg = TrainingConfig(**dict(RECIPES["flagship"], div_margin=None), save_every=1,
                          lr_scheduler_eta_min=TrainingConfig().learning_rate)

    def run(name, epochs):
        return train_gan(_dataset(), ModelConfig(**MODEL), tcfg, RuntimeConfig(scan_epoch=scan),
                         num_epochs=epochs, checkpoint_dir=str(tmp_path / name), device="cpu",
                         verbose=False)

    run("resumed", 2)
    resumed, whole = run("resumed", 3), run("whole", 3)
    assert len(resumed.history) == 1 and resumed.history == whole.history[2:]
    _assert_bit_equal(_everything(resumed.state), _everything(whole.state))


def test_scan_epoch_keeps_the_zero_batch_epoch():
    """Fewer gestures than a batch: no step, every loss 0.0, as the loop."""
    tcfg = TrainingConfig(**dict(RECIPES["reference"], batch_size=64))
    for scan in (True, False):
        result = train_gan(_dataset(), ModelConfig(**MODEL), tcfg, RuntimeConfig(scan_epoch=scan),
                           num_epochs=1, device="cpu", verbose=False)
        assert result.history == [{**dict.fromkeys(METRIC_KEYS, 0.0), "lr": tcfg.learning_rate}]
        assert result.state["epoch"] == 1


def test_scan_epoch_refuses_a_gloo_group(tmp_path):
    """A step's gloo collectives run on the host and cannot join a CUDA
    graph: the check every graphed epoch makes first raises, naming the
    backend. Without a process group there is nothing to refuse."""
    require_capturable(None)
    require_capturable(Mesh())
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        mesh = Mesh(world_size=1, rank=0, group=dist.group.WORLD)
        with pytest.raises(ValueError, match="'gloo'"):
            require_capturable(mesh)
    finally:
        dist.destroy_process_group()


def test_runtime_config_defaults_to_the_eager_loop_like_jax():
    from wordgesture_gan_tpu.configs import RuntimeConfig as JaxRuntimeConfig

    assert RuntimeConfig().scan_epoch is JaxRuntimeConfig().scan_epoch is False
    fields = {f.name for f in dataclasses.fields(RuntimeConfig)}
    assert "scan_epoch" in fields and "donate_state" not in fields
