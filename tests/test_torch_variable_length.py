"""The port's variable-length path against the JAX package, on the CPU: the
masked losses, batched arc-length resampling and word prototypes, the
variable-length data pipeline, the masked train step, masked sampling, the
zero-batch epoch of both training loops, and ``train_cli``/``eval_cli
--variable-length`` end to end.

Small sizes: transformer d_model 16, 2 heads, 2 layers; L = 32; B = 8.
Inputs come from numpy seeds; weights and the train state are JAX's,
carried over by ``interop.from_jax``. Tolerances, each stated at its test:
losses and resampling 1e-6 abs (the same float32 operations, summed in
another order); the data pipeline exact; the masked step's losses 1e-4
relative to max(1, |loss|) and its gradients (Adam's moments after a step at
lr=0) 1e-3 of each leaf's largest; masked sampling 1e-5 abs.
"""

import json
import pickle
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test worker

from wordgesture_gan_tpu import keyboard as jax_keyboard
from wordgesture_gan_tpu import losses as jax_losses
from wordgesture_gan_tpu.configs import ModelConfig as JaxModelConfig
from wordgesture_gan_tpu.configs import RuntimeConfig as JaxRuntimeConfig
from wordgesture_gan_tpu.configs import TrainingConfig as JaxTrainingConfig
from wordgesture_gan_tpu.data import variable_length as jax_vl
from wordgesture_gan_tpu.data.pipeline import GestureArrays as JaxGestureArrays
from wordgesture_gan_tpu.models.gan import generator_init as jax_generator_init
from wordgesture_gan_tpu.models.generators import transformer_generator_apply
from wordgesture_gan_tpu.ops import resample as jax_resample
from wordgesture_gan_tpu.train import gan_loop as jax_gan_loop
from wordgesture_gan_tpu.train import masked_step as jax_masked_step
from wordgesture_gan_tpu.train import variable_loop as jax_variable_loop
from wordgesture_gan_tpu.train.state import init_gan_state as jax_init_gan_state
from wordgesture_gan_tpu_torch import eval_cli, keyboard, losses, train_cli
from wordgesture_gan_tpu_torch.configs import ModelConfig, TrainingConfig
from wordgesture_gan_tpu_torch.data import variable_length as vl
from wordgesture_gan_tpu_torch.data.parse import parse_log_file
from wordgesture_gan_tpu_torch.data.pipeline import GestureArrays
from wordgesture_gan_tpu_torch.data.preprocess import _resample_trace
from wordgesture_gan_tpu_torch.interop.from_jax import (adam_moments, generator_from_jax,
                                                        train_state_from_jax)
from wordgesture_gan_tpu_torch.models.gan import Generator
from wordgesture_gan_tpu_torch.ops.dtw import dtw_matrix
from wordgesture_gan_tpu_torch.ops.resample import (batched_arclength_resample,
                                                    batched_word_prototypes)
from wordgesture_gan_tpu_torch.train import masked_step
from wordgesture_gan_tpu_torch.train.checkpoint import find_checkpoint, load_run_metadata
from wordgesture_gan_tpu_torch.train.gan_loop import train_gan
from wordgesture_gan_tpu_torch.train.variable_loop import (generate_variable_gestures,
                                                           train_variable_gan)
from wordgesture_gan_tpu_torch.train.state import init_gan_state
from wordgesture_gan_tpu_torch.utils import prng

B, L, Z = 8, 32, 4
MODEL = dict(seq_length=L, latent_dim=Z, tfm_d_model=16, tfm_num_heads=2, tfm_num_layers=2,
             enc_hidden_dims=(24, 16), generator_type="transformer", time_head="monotone")
TRAINING = dict(batch_size=B, n_critic=2, lambda_dt=1.0, lambda_speed=2.0, lambda_dtc=4.0)


def _masked_batch(seed, batch=B, length=L):
    """Gestures with a monotone clock, prototypes, and a mask of varied true
    lengths (one full row) whose padding repeats the last valid point."""
    rng = np.random.default_rng(seed)
    gesture = rng.uniform(-1, 1, (batch, length, 3)).astype(np.float32)
    gesture[..., 2] = np.sort(rng.uniform(0, 1, (batch, length)), axis=1)
    proto = rng.uniform(-1, 1, (batch, length, 3)).astype(np.float32)
    lengths = rng.integers(8, length + 1, batch)
    lengths[0] = length
    mask = vl.length_mask(lengths, length)
    for arr in (gesture, proto):
        for i, n in enumerate(lengths):
            arr[i, n:] = arr[i, n - 1]
    return {"gesture": gesture, "prototype": proto, "mask": mask}, lengths


# -- masked losses ------------------------------------------------------------------------------

MASKED_LOSSES = ("masked_time_delta_loss", "masked_speed_profile_loss",
                 "masked_time_delta_corr_loss", "masked_reconstruction_loss", "_masked_pearson")


@pytest.mark.parametrize("name", MASKED_LOSSES)
def test_masked_losses_match_jax(name):
    """float32, 1e-6 abs."""
    batch, _ = _masked_batch(1)
    fake = _masked_batch(2)[0]["gesture"]
    real, mask = batch["gesture"], batch["mask"]
    if name == "_masked_pearson":
        rng = np.random.default_rng(3)
        a, b = rng.normal(size=(2, B, L - 1)).astype(np.float32)
        w = losses._segment_weights(torch.from_numpy(mask)).numpy()
        np.testing.assert_array_equal(w, np.asarray(jax_losses._segment_weights(jnp.asarray(mask))))
        got = losses._masked_pearson(*(torch.from_numpy(x) for x in (a, b, w)), 1e-8)
        want = jax_losses._masked_pearson(*(jnp.asarray(x) for x in (a, b, w)), 1e-8)
    else:
        ours = (getattr(masked_step, name) if name == "masked_reconstruction_loss"
                else getattr(losses, name))
        theirs = (getattr(jax_masked_step, name) if name == "masked_reconstruction_loss"
                  else getattr(jax_losses, name))
        got = ours(*(torch.from_numpy(x) for x in (real, fake, mask)))
        want = theirs(*(jnp.asarray(x) for x in (real, fake, mask)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_masked_losses_equal_the_fixed_ones_on_an_all_valid_batch():
    batch, _ = _masked_batch(4)
    real = torch.from_numpy(batch["gesture"])
    fake = torch.from_numpy(_masked_batch(5)[0]["gesture"])
    ones = torch.ones(B, L)
    pairs = ((losses.masked_time_delta_loss, losses.time_delta_loss),
             (losses.masked_speed_profile_loss, losses.speed_profile_loss),
             (losses.masked_time_delta_corr_loss, losses.time_delta_corr_loss),
             (masked_step.masked_reconstruction_loss, losses.reconstruction_loss))
    for masked, fixed in pairs:
        torch.testing.assert_close(masked(real, fake, ones), fixed(real, fake),
                                   atol=1e-5, rtol=1e-5)


# -- batched resampling and prototypes -----------------------------------------------------------


def _polylines(seed, batch=16, n=40):
    rng = np.random.default_rng(seed)
    pts = np.cumsum(rng.normal(size=(batch, n, 3)) * 0.05, axis=1).astype(np.float32)
    n_valid = rng.integers(2, n + 1, batch).astype(np.int32)
    n_valid[0], n_valid[1] = 2, n
    pts[2] = pts[2, 0]                      # zero-length trace: repeats point 0
    pts[3, 5:9, :2] = pts[3, 5, :2]         # degenerate segments inside a trace
    return pts, n_valid


@pytest.mark.parametrize("out_len", [128, 17])
def test_batched_arclength_resample_matches_jax_and_the_host(out_len):
    """Against JAX 1e-6 abs; against the host resampler (float64
    interpolation) on each valid segment 1e-5 abs."""
    pts, n_valid = _polylines(6)
    got = batched_arclength_resample(torch.from_numpy(pts), torch.from_numpy(n_valid),
                                     out_len).numpy()
    want = np.asarray(jax_resample.batched_arclength_resample(jnp.asarray(pts),
                                                              jnp.asarray(n_valid), out_len))
    assert got.shape == (len(pts), out_len, 3)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(got[2], np.repeat(pts[2, :1], out_len, axis=0))
    for i in (0, 1, 3, 4, 5):
        host = _resample_trace(pts[i, :n_valid[i]], out_len)
        np.testing.assert_allclose(got[i], host, atol=1e-5, err_msg=str(i))


def test_batched_word_prototypes_match_jax_and_the_keyboard():
    """Key centers are exact; prototypes 1e-6 abs against JAX and 1e-5 abs
    against ``QWERTYKeyboard.get_word_prototype``, one-key and empty words
    included."""
    centers = keyboard.key_center_array()
    np.testing.assert_array_equal(centers, jax_keyboard.key_center_array())
    words = ["hello", "a", "", "typing", "pop", "qwerty"]
    idx = [keyboard.word_to_key_indices(w) for w in words]
    K = max(len(i) for i in idx)
    key_pos = np.zeros((len(words), K, 2), np.float32)
    for r, i in enumerate(idx):
        key_pos[r, :len(i)] = centers[i]
    n_keys = np.array([len(i) for i in idx], np.int32)
    got = batched_word_prototypes(torch.from_numpy(key_pos), torch.from_numpy(n_keys), 64).numpy()
    want = np.asarray(jax_resample.batched_word_prototypes(jnp.asarray(key_pos),
                                                           jnp.asarray(n_keys), 64))
    np.testing.assert_allclose(got, want, atol=1e-6)
    kb = keyboard.QWERTYKeyboard()
    for r, w in enumerate(words):
        if w:
            np.testing.assert_allclose(got[r], kb.get_word_prototype(w, 64), atol=1e-5,
                                       err_msg=w)


# -- the variable-length data pipeline ----------------------------------------------------------


def _raw_gestures(zip_path):
    with zipfile.ZipFile(zip_path) as zf:
        for member in [m for m in zf.namelist() if m.endswith(".log")][:3]:
            for raws in parse_log_file(zf.read(member).decode("utf-8", "ignore")).values():
                yield from raws


@pytest.mark.parametrize("arc_step", [0.02, 0.5])
def test_normalize_gesture_variable_matches_jax(synthetic_zip, arc_step):
    """Bit-equal, over the raw traces of a synthetic zip."""
    count = 0
    for raw in _raw_gestures(synthetic_zip):
        got, n = vl.normalize_gesture_variable(raw, 64, arc_step)
        want, m = jax_vl.normalize_gesture_variable(raw, 64, arc_step)
        assert n == m
        np.testing.assert_array_equal(got, want)
        count += 1
    assert count > 10


def test_length_mask():
    np.testing.assert_array_equal(vl.length_mask(np.array([0, 2, 3]), 3),
                                  [[0, 0, 0], [1, 1, 0], [1, 1, 1]])


@pytest.fixture(scope="module")
def by_word(synthetic_zip, tmp_path_factory):
    """Both loaders on one copy of the zip (with ``max_files`` set, so
    neither writes a cache), and the split of each."""
    kb, jkb = keyboard.QWERTYKeyboard(), jax_keyboard.QWERTYKeyboard()
    ours, _ = vl.load_variable_dataset_from_zip(synthetic_zip, kb, max_len=L, max_files=100,
                                                verbose=False)
    theirs, _ = jax_vl.load_variable_dataset_from_zip(synthetic_zip, jkb, max_len=L,
                                                      max_files=100, verbose=False)
    return ours, theirs


def test_load_variable_dataset_matches_jax(by_word):
    ours, theirs = by_word
    assert list(ours) == list(theirs) and len(ours) > 5
    for word in ours:
        assert [n for _, n in ours[word]] == [n for _, n in theirs[word]]
        for (a, _), (b, _) in zip(ours[word], theirs[word]):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_variable_cache_is_the_jax_file_format(synthetic_zip, tmp_path):
    """The cache one package writes, the other reads: a pickle of by_word
    under the same name."""
    import shutil

    zip_path = tmp_path / "swipelogs.zip"
    shutil.copy(synthetic_zip, zip_path)
    ours, _ = vl.load_variable_dataset_from_zip(str(zip_path), keyboard.QWERTYKeyboard(),
                                                max_len=L, verbose=False)
    caches = list(tmp_path.glob(".cache_swipelogs_*.pkl"))
    assert len(caches) == 1
    with open(caches[0], "rb") as f:
        assert pickle.load(f).keys() == ours.keys()
    theirs, _ = jax_vl.load_variable_dataset_from_zip(str(zip_path),
                                                      jax_keyboard.QWERTYKeyboard(), max_len=L,
                                                      verbose=False)
    assert list(tmp_path.glob(".cache_swipelogs_*.pkl")) == caches      # read, not rewritten
    for word in ours:
        np.testing.assert_array_equal(ours[word][0][0], theirs[word][0][0])


def test_create_variable_split_matches_jax(by_word):
    ours, theirs = by_word
    a = vl.create_variable_split(ours, keyboard.QWERTYKeyboard(), max_len=L, verbose=False)
    b = jax_vl.create_variable_split(theirs, jax_keyboard.QWERTYKeyboard(), max_len=L,
                                     verbose=False)
    for got, want in zip(a, b):
        assert len(got) == len(want) > 0 and got.words == want.words
        for name in ("gestures", "prototypes", "lengths"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
        np.testing.assert_array_equal(got.masks(), want.masks())


# -- the masked step ----------------------------------------------------------------------------


def _jax_draws(key, n_critic):
    """The JAX step's own draws, re-derived from its state key by repeating
    its splits: per critic iteration split(rng, 3), then split(rng, 4)."""
    zkeys, ekeys = [], []
    for _ in range(n_critic):
        key, kz, ke = jax.random.split(key, 3)
        zkeys.append(kz)
        ekeys.append(ke)
    key, kz1, ke1, ke2 = jax.random.split(key, 4)

    def normal(k):
        return np.array(jax.random.normal(k, (B, Z)), np.float32)

    return {"z_rand": np.stack([normal(k) for k in zkeys]),
            "eps_enc": np.stack([normal(k) for k in ekeys]),
            "z1": normal(kz1), "eps_rec": normal(ke1), "eps2": normal(ke2)}


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _paths(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree) for p, v in _paths(x, f"{prefix}/{i}").items()}
    return {prefix: tree}


def test_masked_step_matches_jax():
    """One ``gan_train_step_masked`` at lr=0 from one JAX state, with the
    draws the JAX step makes from its key: losses 1e-4 relative to
    max(1, |loss|), Adam's moments 1e-3 of each leaf's largest."""
    jcfg, jtcfg = JaxModelConfig(**MODEL), JaxTrainingConfig(**TRAINING)
    start = jax.device_get(jax_init_gan_state(0, jcfg, jtcfg))
    batch, _ = _masked_batch(7)
    ref_state, ref_metrics = jax.jit(lambda s, b: jax_masked_step.gan_train_step_masked(
        s, b, jnp.float32(0.0), jcfg, jtcfg))(start, jax.tree.map(jnp.asarray, batch))
    ref_state = jax.device_get(ref_state)
    state = train_state_from_jax(start, device="cpu")
    noise = {k: torch.from_numpy(v) for k, v in _jax_draws(start["rng"], 2).items()}
    _, metrics = masked_step.gan_train_step_masked(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, 0.0, ModelConfig(**MODEL),
        TrainingConfig(**TRAINING), noise=noise)
    assert tuple(metrics) == masked_step.METRIC_KEYS and set(metrics) == set(ref_metrics)
    for k, v in metrics.items():
        want = float(ref_metrics[k])
        assert abs(v.item() - want) <= 1e-4 * max(1.0, abs(want)), (k, v.item(), want)
    for model in ("g", "e", "d1", "d2"):
        ref = adam_moments(ref_state[model]["opt"])
        assert state[model]["opt"]["count"] == int(ref["count"])
        for part in ("mu", "nu"):
            want, got = _paths(ref[part]), _paths(state[model]["opt"][part])
            assert set(want) == set(got)
            for path, leaf in got.items():
                w = np.asarray(want[path])
                np.testing.assert_allclose(leaf.numpy(), w, atol=1e-3 * max(np.abs(w).max(), 1e-30),
                                           err_msg=f"{model} {part}{path}")


def test_masked_step_with_each_packages_own_draws_matches_jax():
    """Each package from its own ``init_gan_state(42)``, one masked step at
    lr=0 with no injected noise: the port draws from its key as the JAX
    step does, and holds ``test_masked_step_matches_jax``'s tolerances; both
    states end on the same key."""
    jcfg, jtcfg = JaxModelConfig(**MODEL), JaxTrainingConfig(**TRAINING)
    batch, _ = _masked_batch(9)
    jax_step = jax.jit(lambda s, b: jax_masked_step.gan_train_step_masked(
        s, b, jnp.float32(0.0), jcfg, jtcfg))
    ref_state, ref_metrics = jax.device_get(jax_step(jax_init_gan_state(42, jcfg, jtcfg),
                                                     jax.tree.map(jnp.asarray, batch)))
    state, metrics = masked_step.gan_train_step_masked(
        init_gan_state(42, ModelConfig(**MODEL), "cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()}, 0.0, ModelConfig(**MODEL),
        TrainingConfig(**TRAINING))
    for k, v in metrics.items():
        want = float(ref_metrics[k])
        assert abs(v.item() - want) <= 1e-4 * max(1.0, abs(want)), (k, v.item(), want)
    np.testing.assert_array_equal(state["rng"].numpy(), np.asarray(ref_state["rng"]))
    for model in ("g", "e", "d1", "d2"):
        ref = adam_moments(ref_state[model]["opt"])
        for part in ("mu", "nu"):
            want, got = _paths(ref[part]), _paths(state[model]["opt"][part])
            for path, leaf in got.items():
                w = np.asarray(want[path])
                np.testing.assert_allclose(leaf.numpy(), w, atol=1e-3 * max(np.abs(w).max(), 1e-30),
                                           err_msg=f"{model} {part}{path}")


def test_masked_step_refuses_other_families():
    with pytest.raises(ValueError, match="transformer"):
        masked_step.gan_train_step_masked({"rng": None, "g": None, "e": None, "d1": None,
                                           "d2": None}, {}, 0.0, ModelConfig(), TrainingConfig())


def test_make_epoch_batches_masked_keeps_rows_together():
    batch, lengths = _masked_batch(8, batch=11)
    out = masked_step.make_epoch_batches_masked(prng.PRNGKey(0), *(torch.from_numpy(batch[k]) for k in
                                                       ("gesture", "prototype", "mask")), 4)
    assert out["gesture"].shape == (2, 4, L, 3) and out["mask"].shape == (2, 4, L)
    for g, m in zip(out["gesture"].reshape(8, L, 3), out["mask"].reshape(8, L)):
        row = int(np.flatnonzero((batch["gesture"] == g.numpy()).all(axis=(1, 2)))[0])
        np.testing.assert_array_equal(m.numpy(), batch["mask"][row])


def test_generate_variable_gestures_matches_jax():
    """Injected z over 11 rows in chunks of 8 (the padding rows get an
    all-zero mask): each row == JAX's masked transformer on the same z,
    zeroed on the padding, 1e-5 abs."""
    jcfg = JaxModelConfig(**MODEL)
    params = jax.device_get(jax_generator_init(jax.random.PRNGKey(3), jcfg))
    model = Generator(ModelConfig(**MODEL))
    model.load_state_dict(generator_from_jax(params))
    batch, _ = _masked_batch(9, batch=11)
    z = np.random.default_rng(10).normal(size=(11, Z)).astype(np.float32)
    got = generate_variable_gestures(model, batch["prototype"], batch["mask"], ModelConfig(**MODEL),
                                     truncation=0.5, batch=8, device="cpu", z=z)
    want = transformer_generator_apply(params, jnp.asarray(batch["prototype"]),
                                       jnp.asarray(z * 0.5), jcfg,
                                       pad_mask=jnp.asarray(batch["mask"]))
    want = np.asarray(want) * batch["mask"][:, :, None]
    np.testing.assert_allclose(got, want, atol=1e-5)
    with pytest.raises(ValueError, match="transformer"):
        generate_variable_gestures(model, batch["prototype"], batch["mask"], ModelConfig(),
                                   device="cpu")


# -- the zero-batch epoch ----------------------------------------------------------------------


def _history_keys(checkpoint_dir):
    lines = (checkpoint_dir / "history.jsonl").read_text().splitlines()
    return [json.loads(line) for line in lines]


@pytest.mark.parametrize("loop", ["fixed", "masked"])
def test_zero_batch_epoch_writes_every_loss_like_jax(loop, tmp_path):
    """Fewer samples than the batch: the port's loop records every loss key
    of its step at 0.0, the keys the JAX loop records (exact)."""
    batch, lengths = _masked_batch(11, batch=5)
    mcfg = dict(MODEL, generator_type="transformer" if loop == "masked" else "bilstm",
                gen_hidden_dim=8)
    tcfg = dict(batch_size=16, n_critic=1)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    runtime = JaxRuntimeConfig(data_axis_size=1)
    if loop == "fixed":
        jax_gan_loop.train_gan(JaxGestureArrays(batch["gesture"], batch["prototype"], ["w"] * 5),
                               JaxModelConfig(**mcfg), JaxTrainingConfig(**tcfg), runtime,
                               num_epochs=1, checkpoint_dir=str(jax_dir), verbose=False)
        result = train_gan(GestureArrays(batch["gesture"], batch["prototype"], ["w"] * 5),
                           ModelConfig(**mcfg), TrainingConfig(**tcfg), num_epochs=1,
                           checkpoint_dir=str(port_dir), verbose=False, device="cpu")
    else:
        jax_variable_loop.train_variable_gan(
            jax_vl.VariableGestureArrays(batch["gesture"], batch["prototype"], lengths),
            JaxModelConfig(**mcfg), JaxTrainingConfig(**tcfg), runtime, num_epochs=1,
            checkpoint_dir=str(jax_dir), verbose=False)
        result = train_variable_gan(
            vl.VariableGestureArrays(batch["gesture"], batch["prototype"], lengths),
            ModelConfig(**mcfg), TrainingConfig(**tcfg), num_epochs=1,
            checkpoint_dir=str(port_dir), verbose=False, device="cpu")
    want, got = _history_keys(jax_dir), _history_keys(port_dir)
    assert len(want) == len(got) == 1 and set(got[0]) == set(want[0])
    assert got[0] == {**want[0], "lr": got[0]["lr"]}
    assert all(v == 0.0 for k, v in got[0].items() if k not in ("epoch", "lr"))
    assert result.history == [{k: v for k, v in got[0].items() if k != "epoch"}]


# -- the CLIs, end to end ----------------------------------------------------------------------


def test_train_and_eval_cli_variable_length(tmp_path, capsys):
    """2 epochs of ``train_cli --variable-length`` on a 4-user synthetic
    corpus, then ``eval_cli --variable-length`` with DTW on."""
    data = ["--synthetic", "--synthetic-users", "4", "--data", str(tmp_path / "swipelogs.zip"),
            "--checkpoint-dir", str(tmp_path / "ckpt"), "--device", "cpu"]
    result = train_cli.main(["--variable-length", "--epochs", "2", "--batch-size", "32",
                             "--precision", "float32", *data])
    assert len(result.history) == 2
    assert set(result.history[0]) == set(masked_step.METRIC_KEYS) | {"lr"}
    assert all(np.isfinite(v) for h in result.history for v in h.values())
    assert load_run_metadata(str(tmp_path / "ckpt"))["generator_type"] == "transformer"
    assert find_checkpoint(str(tmp_path / "ckpt")).name == "latest.pt"
    printed = capsys.readouterr().out
    assert "(variable-length)" in printed and "Rec:" in printed

    launches = dtw_matrix.launches
    out = eval_cli.main(["--variable-length", "--n-samples", "16", "--fid-epochs", "1", *data])
    printed = capsys.readouterr().out
    assert "GAN (variable-length) Results" in printed and "Loaded checkpoint from epoch 2" in printed
    assert out["n"] == 16 and out["minjerk"] is None
    results = out["gan"]
    assert all(np.isfinite(results[k]) for k in ("l2_wasserstein", "dtw_wasserstein", "fid",
                                                 "precision", "recall", "velocity_corr"))
    assert 0.0 <= results["precision"] <= 1.0 and 0.0 <= results["recall"] <= 1.0
    assert results["dtw_wasserstein"] > 0.0
    assert {"load", "generate", "resample", "gan"} <= set(out["stage_seconds"])
    assert dtw_matrix.launches == launches          # CPU tensors: the plain version only
