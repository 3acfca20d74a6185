"""The port's two-cycle train step, train-state interop and training loop
against the JAX package, on the CPU.

One JAX ``init_gan_state`` is converted to the port (``train_state_from_jax``,
Adam moments included) and both packages take one ``gan_train_step`` on the
same batch with the same injected noise. The second prior draw ``z_ms``,
which the JAX step draws itself, is recomputed from the JAX state's key by
repeating its splits. Tolerances, float32, each stated at its test: losses
1e-4 relative to max(1, |loss|); gradients (Adam's moments after a step at
lr=0) 1e-5 relative, 1e-3 with the flagship auxiliaries on; parameters
within 2·lr (Adam's first step maps a near-zero gradient's sign to ±lr, so a
last-ulp difference in such a gradient moves a weight by up to 2·lr);
spectral-norm u's 1e-5. The same step with each package drawing its own
noise from ``init_gan_state(42)`` is held to these tolerances too.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test worker

from wordgesture_gan_tpu.configs import ModelConfig as JaxModelConfig
from wordgesture_gan_tpu.configs import TrainingConfig as JaxTrainingConfig
from wordgesture_gan_tpu.train import gan_train_step as jax_gan_train_step
from wordgesture_gan_tpu.train import init_gan_state as jax_init_gan_state
from wordgesture_gan_tpu_torch.configs import ModelConfig, TrainingConfig
from wordgesture_gan_tpu_torch.data.pipeline import GestureArrays
from wordgesture_gan_tpu_torch.interop.from_jax import adam_moments, train_state_from_jax
from wordgesture_gan_tpu_torch.ops.bilstm_fused import fused_bilstm_fwd
from wordgesture_gan_tpu_torch.ops.bilstm_train import bilstm_train_bwd, bilstm_train_fwd
from wordgesture_gan_tpu_torch.train import checkpoint
from wordgesture_gan_tpu_torch.train.gan_loop import generate_gestures, train_gan
from wordgesture_gan_tpu_torch.train.gan_step import gan_train_step, make_epoch_batches
from wordgesture_gan_tpu_torch.train.state import MODELS, init_gan_state
from wordgesture_gan_tpu_torch.utils.tree import tree_leaves
from wordgesture_gan_tpu_torch.utils import prng

REPO = Path(__file__).resolve().parent.parent
MODEL = dict(seq_length=16, gen_hidden_dim=8, gen_num_layers=4, latent_dim=4,
             enc_hidden_dims=(24, 16), time_head="monotone")
FLAGSHIP = dict(batch_size=8, n_critic=2, lambda_speed=2.0, lambda_div=0.3, lambda_dtc=4.0,
                div_margin=0.25)
B, L, Z, LR = 8, 16, 4, 2e-4


def _paths(tree, prefix=""):
    """{path: leaf} of a nested dict/list tree (JAX and port trees alike)."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _paths(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree) for p, v in _paths(x, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _batch_and_noise(seed):
    rng = np.random.default_rng(seed)
    gesture = rng.uniform(-1, 1, (B, L, 3)).astype(np.float32)
    gesture[..., 2] = np.sort(rng.uniform(0, 1, (B, L)), axis=1)
    batch = {"gesture": gesture, "prototype": rng.uniform(-1, 1, (B, L, 3)).astype(np.float32)}
    noise = {"z_rand": rng.normal(size=(2, B, Z)), "eps_enc": rng.normal(size=(2, B, Z)),
             "z1": rng.normal(size=(B, Z)), "eps_rec": rng.normal(size=(B, Z)),
             "eps2": rng.normal(size=(B, Z))}
    return batch, {k: v.astype(np.float32) for k, v in noise.items()}


def _jax_z_ms(key, n_critic):
    """The JAX step's second prior draw, by repeating its key splits."""
    for _ in range(n_critic):
        key, _, _ = jax.random.split(key, 3)
    key, _, _, _ = jax.random.split(key, 4)
    _, kz_ms = jax.random.split(key)
    return np.array(jax.random.normal(kz_ms, (B, Z)), np.float32)


@pytest.fixture(scope="module")
def jax_start():
    state = jax_init_gan_state(0, JaxModelConfig(**MODEL), JaxTrainingConfig(**FLAGSHIP))
    return jax.device_get(state)


VARIANTS = {"reference": (dict(batch_size=8, n_critic=2), 1e-5),
            "flagship": (FLAGSHIP, 1e-3),
            "flagship_fused_forward": (dict(FLAGSHIP, fused_critic_forward=True), 1e-3)}


@pytest.fixture(scope="module", params=list(VARIANTS))
def stepped(request, jax_start):
    """One step from one state in both packages, at lr=0 (so Adam's moments
    hold the first gradients, with no update to amplify) and at lr=2e-4:
    {lr: (JAX state, JAX metrics, port state, port metrics)}, and the
    gradient tolerance of the variant."""
    tcfg, grad_tol = VARIANTS[request.param]
    jcfg, jtcfg = JaxModelConfig(**MODEL), JaxTrainingConfig(**tcfg)
    batch, noise = _batch_and_noise(1)
    jax_step = jax.jit(lambda s, b, n, lr: jax_gan_train_step(s, b, lr, jcfg, jtcfg, noise=n))
    port_noise = {k: torch.from_numpy(v) for k, v in noise.items()}
    port_noise["z_ms"] = torch.from_numpy(_jax_z_ms(jax_start["rng"], jtcfg.n_critic))
    runs = {}
    for lr in (0.0, LR):
        ref_state, ref_metrics = jax_step(jax_start, jax.tree.map(jnp.asarray, batch),
                                          jax.tree.map(jnp.asarray, noise), jnp.float32(lr))
        state = train_state_from_jax(jax_start, device="cpu")
        launches = fused_bilstm_fwd.launches
        new_state, metrics = gan_train_step(
            state, {k: torch.from_numpy(v) for k, v in batch.items()}, lr, ModelConfig(**MODEL),
            TrainingConfig(**tcfg), noise=port_noise)
        assert fused_bilstm_fwd.launches == launches   # CPU tensors: plain versions only
        runs[lr] = (jax.device_get(ref_state), jax.device_get(ref_metrics), new_state, metrics)
    return runs, grad_tol


@pytest.mark.parametrize("lr", [0.0, LR])
def test_step_losses_match_jax(stepped, lr):
    """1e-4 relative to max(1, |loss|): the critic losses are differences of
    near-equal means, and at lr > 0 the second critic iteration already sees
    weights that Adam's first step moved by ±lr where a gradient is ~0."""
    _, ref_metrics, _, metrics = stepped[0][lr]
    assert set(metrics) == set(ref_metrics)
    for k, v in metrics.items():
        assert v.dtype == torch.float32 and v.dim() == 0
        want = float(ref_metrics[k])
        assert abs(v.item() - want) <= 1e-4 * max(1.0, abs(want)), (k, v.item(), want)


@pytest.mark.parametrize("model", MODELS)
def test_step_gradients_match_jax(stepped, model):
    """At lr=0 Adam's moments are the clipped gradients (mu = (1-β1)·g,
    nu = (1-β2)·g², the critics' after two iterations): relative to each
    leaf's largest, 1e-5 for the reference recipe; 1e-3 with the flagship
    auxiliaries on, whose speed-profile and Pearson terms amplify float32
    rounding in G's and E's gradients (measured 6.5e-4 at this size)."""
    (ref_state, _, state, _), tol = stepped[0][0.0], stepped[1]
    ref = adam_moments(ref_state[model]["opt"])
    opt = state[model]["opt"]
    assert opt["count"] == int(ref["count"]) == (2 if model in ("d1", "d2") else 1)
    for part in ("mu", "nu"):
        want, got = _paths(ref[part]), _paths(opt[part])
        assert set(want) == set(got)
        for path, leaf in got.items():
            w = np.asarray(want[path])
            np.testing.assert_allclose(_np(leaf), w, atol=tol * max(np.abs(w).max(), 1e-30),
                                       err_msg=f"{part}{path}")


@pytest.mark.parametrize("model", MODELS)
def test_step_params_match_jax(stepped, jax_start, model):
    ref_state, _, state, _ = stepped[0][LR]
    ref, got, start = (_paths(s[model]["params"]) for s in (ref_state, state, jax_start))
    assert set(got) == set(ref)
    for path, leaf in got.items():
        assert leaf.requires_grad and leaf.grad is None
        np.testing.assert_allclose(_np(leaf), np.asarray(ref[path]), atol=2 * LR, err_msg=path)
        # A leaf moves where JAX's moves (the critics' score bias has a zero
        # WGAN gradient and stays put in both).
        assert (np.array_equal(_np(leaf), np.asarray(start[path]))
                == np.array_equal(np.asarray(ref[path]), np.asarray(start[path]))), path


OWN_DRAWS_MODEL = dict(MODEL, gen_num_layers=2)


@pytest.mark.parametrize("lr", [0.0, LR])
def test_flagship_step_with_each_packages_own_draws_matches_jax(lr):
    """Each package from its own ``init_gan_state(42)``, one flagship step
    with no injected noise: the port splits its keys and draws its noise as
    the JAX step does, so the step matches JAX's within the injected-noise
    tolerances above (losses 1e-4, gradients 1e-3 of a leaf's largest,
    parameters 2·lr), and both states end on the same key."""
    jcfg, jtcfg = JaxModelConfig(**OWN_DRAWS_MODEL), JaxTrainingConfig(**FLAGSHIP)
    batch, _ = _batch_and_noise(3)
    jax_step = jax.jit(lambda s, b: jax_gan_train_step(s, b, jnp.float32(lr), jcfg, jtcfg))
    ref_state, ref_metrics = jax.device_get(jax_step(jax_init_gan_state(42, jcfg, jtcfg),
                                                     jax.tree.map(jnp.asarray, batch)))
    state, metrics = gan_train_step(init_gan_state(42, ModelConfig(**OWN_DRAWS_MODEL), "cpu"),
                                    {k: torch.from_numpy(v) for k, v in batch.items()}, lr,
                                    ModelConfig(**OWN_DRAWS_MODEL), TrainingConfig(**FLAGSHIP))
    for k, v in metrics.items():
        want = float(ref_metrics[k])
        assert abs(v.item() - want) <= 1e-4 * max(1.0, abs(want)), (k, v.item(), want)
    np.testing.assert_array_equal(state["rng"].numpy(), np.asarray(ref_state["rng"]))
    for model in MODELS:
        if lr == 0.0:
            ref = adam_moments(ref_state[model]["opt"])
            for part in ("mu", "nu"):
                want, got = _paths(ref[part]), _paths(state[model]["opt"][part])
                for path, leaf in got.items():
                    w = np.asarray(want[path])
                    np.testing.assert_allclose(_np(leaf), w,
                                               atol=1e-3 * max(np.abs(w).max(), 1e-30),
                                               err_msg=f"{model}{part}{path}")
        else:
            ref, got = _paths(ref_state[model]["params"]), _paths(state[model]["params"])
            for path, leaf in got.items():
                np.testing.assert_allclose(_np(leaf), np.asarray(ref[path]), atol=2 * LR,
                                           err_msg=f"{model}{path}")


def test_step_spectral_state_matches_jax(stepped, jax_start):
    ref_state, _, state, _ = stepped[0][LR]
    for model in ("d1", "d2"):
        ref, got = _paths(ref_state[model]["sn"]), _paths(state[model]["sn"])
        start = _paths(jax_start[model]["sn"])
        for path, leaf in got.items():
            np.testing.assert_allclose(_np(leaf), np.asarray(ref[path]), atol=1e-5, err_msg=path)
            if leaf.numel() > 1:
                assert not np.allclose(_np(leaf), np.asarray(start[path]))


def test_train_state_from_jax(jax_start):
    state = train_state_from_jax(jax_start, device="cpu", seed=3)
    for model in MODELS:
        ref, got = _paths(jax_start[model]["params"]), _paths(state[model]["params"])
        assert set(ref) == set(got)
        for path, leaf in got.items():
            assert leaf.dtype == torch.float32 and leaf.requires_grad
            np.testing.assert_array_equal(_np(leaf), np.asarray(ref[path]))
        assert state[model]["opt"]["count"] == 0
    for model in ("d1", "d2"):
        for path, u in _paths(state[model]["sn"]).items():
            np.testing.assert_array_equal(_np(u), np.asarray(_paths(jax_start[model]["sn"])[path]))
    # The JAX state's key carries over: the port draws on from it as JAX does.
    assert state["epoch"] == 0
    np.testing.assert_array_equal(state["rng"].numpy(), np.asarray(jax_start["rng"]))


def test_joint_step_leaves_no_critic_gradient():
    """n_critic=0: the critics' parameters stay as they were and carry no
    ``.grad``; G and E move; the critics' u still advance (joint step)."""
    state = init_gan_state(0, ModelConfig(**MODEL), device="cpu")
    before = {m: [t.detach().clone() for t in tree_leaves(state[m]["params"])] for m in MODELS}
    sn_before = [u.clone() for u in tree_leaves(state["d1"]["sn"])]
    batch, _ = _batch_and_noise(2)
    _, metrics = gan_train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, LR,
                                ModelConfig(**MODEL), TrainingConfig(batch_size=B, n_critic=0))
    assert metrics["d1_loss"].item() == 0.0
    for m in MODELS:
        after = tree_leaves(state[m]["params"])
        assert all(t.grad is None for t in after)
        same = all(torch.equal(a, b) for a, b in zip(after, before[m]))
        assert same == (m in ("d1", "d2")), m
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(state["d1"]["sn"]), sn_before))


def test_make_epoch_batches_drops_the_last_partial_batch():
    g = torch.arange(10, dtype=torch.float32)[:, None, None].expand(10, 4, 3).contiguous()
    batches = make_epoch_batches(prng.PRNGKey(0), g, g + 100, 3)
    assert batches["gesture"].shape == (3, 3, 4, 3)
    ids = batches["gesture"][:, :, 0, 0].flatten()
    assert len(set(ids.tolist())) == 9
    assert torch.equal(batches["prototype"][:, :, 0, 0].flatten(), ids + 100)
    again = make_epoch_batches(prng.PRNGKey(0), g, g + 100, 3)
    assert torch.equal(again["gesture"], batches["gesture"])


def _dataset(n=40, seed=5):
    rng = np.random.default_rng(seed)
    g = rng.uniform(-1, 1, (n, L, 3)).astype(np.float32)
    g[..., 2] = np.sort(rng.uniform(0, 1, (n, L)), axis=1)
    return GestureArrays(g, rng.uniform(-1, 1, (n, L, 3)).astype(np.float32),
                         [f"w{i % 6}" for i in range(n)])


LOOP = dict(batch_size=8, n_critic=2, save_every=1, lambda_div=0.3, lambda_speed=2.0)


def test_train_loop_checkpoints_and_resumes(tmp_path):
    mcfg = ModelConfig(**MODEL, compute_dtype="bfloat16")
    tcfg = TrainingConfig(**LOOP)
    ds = _dataset()
    first = train_gan(ds, mcfg, tcfg, num_epochs=2, checkpoint_dir=str(tmp_path), device="cpu",
                      verbose=False)
    assert len(first.history) == 2 and len(first.epoch_seconds) == 2
    assert first.gestures_per_epoch == 40 and first.state["epoch"] == 2
    for losses in first.history:
        assert all(np.isfinite(v) for v in losses.values())
    assert checkpoint.latest_epoch(str(tmp_path)) == 2
    assert (tmp_path / "latest.pt").resolve().name == "epoch_2.pt"
    meta = json.loads((tmp_path / "run_meta.json").read_text())
    assert meta == {"generator_type": "bilstm", "time_head": "monotone", "gen_hidden_dim": 8}

    # The saved state restores into a fresh one exactly.
    fresh = init_gan_state(1, mcfg, device="cpu")
    checkpoint.restore_checkpoint(fresh, str(tmp_path))
    for m in MODELS:
        for a, b in zip(tree_leaves(fresh[m]["params"]), tree_leaves(first.state[m]["params"])):
            assert torch.equal(a, b)
        assert fresh[m]["opt"]["count"] == first.state[m]["opt"]["count"]
    assert fresh["epoch"] == 2

    # A record past the checkpoint (a crash after logging) is dropped on resume.
    with open(tmp_path / "history.jsonl", "a") as f:
        f.write(json.dumps({"epoch": 3, "stale": 1.0}) + "\n")
    resumed = train_gan(ds, mcfg, tcfg, num_epochs=3, checkpoint_dir=str(tmp_path),
                        device="cpu", verbose=False)
    assert len(resumed.history) == 1 and resumed.state["epoch"] == 3
    lines = [json.loads(x) for x in (tmp_path / "history.jsonl").read_text().splitlines()]
    assert [x["epoch"] for x in lines] == [1, 2, 3] and "stale" not in lines[-1]
    done = train_gan(ds, mcfg, tcfg, num_epochs=3, checkpoint_dir=str(tmp_path), device="cpu",
                     verbose=False)
    assert done.history == []

    # Serving reads the generator out of a train checkpoint.
    model = checkpoint.load_generator(str(tmp_path / "latest.pt"), mcfg, device="cpu")
    out = generate_gestures(model, ds.prototypes[:5], mcfg, batch=4, device="cpu")
    assert out.shape == (5, L, 3) and np.isfinite(out).all()


def test_train_loop_aborts_on_non_finite_losses(tmp_path):
    ds = _dataset()
    ds.gestures[3, 5, 0] = np.nan
    with pytest.raises(FloatingPointError, match="Non-finite"):
        train_gan(ds, ModelConfig(**MODEL), TrainingConfig(batch_size=40, n_critic=1),
                  num_epochs=2, checkpoint_dir=str(tmp_path), device="cpu", verbose=False)
    assert checkpoint.latest_epoch(str(tmp_path)) == 0
    assert not (tmp_path / "history.jsonl").exists()


def test_restore_refuses_another_configuration(tmp_path):
    state = init_gan_state(0, ModelConfig(**MODEL), device="cpu")
    checkpoint.save_checkpoint(state, str(tmp_path), 0)
    other = init_gan_state(0, ModelConfig(**dict(MODEL, gen_hidden_dim=6)), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        checkpoint.restore_checkpoint(other, str(tmp_path))
    assert checkpoint.restore_checkpoint(other, str(tmp_path / "none")) is None


def test_train_gan_defaults_to_the_gpu():
    import inspect

    assert inspect.signature(train_gan).parameters["device"].default == "cuda"
    assert inspect.signature(init_gan_state).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_gan(_dataset(8), ModelConfig(**MODEL), TrainingConfig(batch_size=8),
                      num_epochs=1, verbose=False)


def test_training_modules_run_with_jax_unimportable():
    code = ("import sys\n"
            "for m in ('jax', 'optax', 'wordgesture_gan_tpu'): sys.modules[m] = None\n"
            "import wordgesture_gan_tpu_torch.train.gan_loop, wordgesture_gan_tpu_torch.losses\n"
            "import wordgesture_gan_tpu_torch.interop.from_jax\n"
            "print('ok')\n")
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                            text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "ok"


def test_counters_count_only_cuda_launches():
    counters = (fused_bilstm_fwd, bilstm_train_fwd, bilstm_train_bwd)
    before = [c.launches for c in counters]
    state = init_gan_state(0, ModelConfig(**MODEL), device="cpu")
    batch, _ = _batch_and_noise(3)
    gan_train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, LR,
                   ModelConfig(**MODEL), TrainingConfig(**FLAGSHIP))
    assert [c.launches for c in counters] == before
