"""The PyTorch port's contrastive encoder slice against the JAX package's, on
the CPU: the strided conv and BatchNorm, the encoder, the SupCon loss, the
clip-plus-Adam step and the epoch, the data functions, embedding and the
recall metrics, the checkpoint kinds, the JAX state converter, and the two
CLIs (``train_contrastive_cli``, ``eval_contrastive_cli``) end to end on a
small synthetic corpus with ``--device cpu``.

Weights move with ``contrastive_state_from_jax``; the epoch's index rows are
drawn once (stdlib ``random``, the same in both packages) and handed to
both. Tolerances: the stride-2 conv and the encoder's forward in train and
eval mode 1e-5; BatchNorm's running statistics 1e-6; the SupCon loss and its
gradient 1e-5; one clip-plus-Adam step 1e-5 in the gradients (relative to
the tree's largest) and in the parameters, where a parameter whose gradient
is ~0 (the conv biases in front of BatchNorm) may move by up to 2·lr both
ways (Adam's first step maps a near-zero gradient's sign to ±lr); three
steps of the epoch 1e-4 in the losses; the data functions bit-equal (the
word-label mapping follows a set's order, so up to relabelling); embedding,
centroid recall, retrieval recall and the centroid table 1e-6.
"""

import ast
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test worker

from wordgesture_gan_tpu.configs import ContrastiveConfig as JaxContrastiveConfig
from wordgesture_gan_tpu.data import contrastive as jax_data
from wordgesture_gan_tpu.eval import contrastive_eval as jax_eval
from wordgesture_gan_tpu.keyboard import QWERTYKeyboard as JaxQWERTYKeyboard
from wordgesture_gan_tpu.losses import supervised_contrastive_loss as jax_supcon
from wordgesture_gan_tpu.models import contrastive as jax_model
from wordgesture_gan_tpu.models import layers as jax_layers
from wordgesture_gan_tpu.train import contrastive_loop as jax_loop
from wordgesture_gan_tpu.train.state import apply_update as jax_apply_update
from wordgesture_gan_tpu_torch import eval_contrastive_cli, train_contrastive_cli
from wordgesture_gan_tpu_torch.configs import ContrastiveConfig, ModelConfig, TrainingConfig
from wordgesture_gan_tpu_torch.data import contrastive as data
from wordgesture_gan_tpu_torch.data.pipeline import load_dataset_from_zip
from wordgesture_gan_tpu_torch.eval import contrastive_eval
from wordgesture_gan_tpu_torch.interop.from_jax import contrastive_state_from_jax, flatten_tree
from wordgesture_gan_tpu_torch.keyboard import QWERTYKeyboard
from wordgesture_gan_tpu_torch.losses import supervised_contrastive_loss
from wordgesture_gan_tpu_torch.models import contrastive as model
from wordgesture_gan_tpu_torch.models import layers
from wordgesture_gan_tpu_torch.train import checkpoint
from wordgesture_gan_tpu_torch.train import contrastive_loop as loop
from wordgesture_gan_tpu_torch.train.state import init_gan_state
from wordgesture_gan_tpu_torch.utils.tree import tree_leaves
from wordgesture_gan_tpu_torch.utils import prng

WORDS = ["hello", "world", "water", "thing", "sound", "point", "house", "light", "mother",
         "earth", "round", "paper", "quick", "brown", "jumps", "lazy"]
SEQ = 32
CONFIG = ContrastiveConfig(batch_words=8, gestures_per_word=2, num_epochs=3)
JAX_CONFIG = JaxContrastiveConfig(batch_words=8, gestures_per_word=2, num_epochs=3)
LR = 1e-3


def by_word(seed: int = 0, seq: int = SEQ, per_word=(2, 5)) -> dict:
    """Noisy minimum-jerk gestures per word, 2-4 each, one singleton word."""
    kb = QWERTYKeyboard()
    rng = np.random.default_rng(seed)
    out = {}
    for w in WORDS:
        base = kb.get_minimum_jerk_trajectory(w, seq)
        out[w] = [(base + rng.normal(0, 0.02, base.shape)).astype(np.float32)
                  for _ in range(int(rng.integers(*per_word)))]
    out["alone"] = [kb.get_minimum_jerk_trajectory("alone", seq)]
    return out


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


jax_apply = jax.jit(jax_model.contrastive_encoder_apply,
                    static_argnames=("train", "normalize", "axis_name"))


def jax_state(seed: int = 0):
    return jax.device_get(jax_loop.init_contrastive_state(seed, JAX_CONFIG))


# -- layers, encoder, loss ----------------------------------------------------------------------


def test_strided_conv1d_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 37, 5)).astype(np.float32)
    p = jax_layers.conv1d_init(jax.random.PRNGKey(0), 5, 7, 5)
    for stride, pad in ((2, 2), (2, 0), (1, 1), (3, 4)):
        want = np.asarray(jax_layers.conv1d(p, jnp.asarray(x), stride=stride, padding=pad))
        got = layers.conv1d({k: t_(v) for k, v in p.items()}, t_(x), stride=stride,
                            padding=pad).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_jax(train):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(4, 9, 6)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 2, 6).astype(np.float32),
         "bias": rng.normal(size=6).astype(np.float32)}
    s = {"mean": rng.normal(size=6).astype(np.float32),
         "var": rng.uniform(0.5, 2, 6).astype(np.float32)}
    want, want_s = jax_layers.batchnorm(p, s, jnp.asarray(x), train=train)
    got, got_s = layers.batchnorm({k: t_(v) for k, v in p.items()},
                                  {k: t_(v) for k, v in s.items()}, t_(x), train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_s[k].numpy(), np.asarray(want_s[k]), atol=1e-6)
    assert not got_s["mean"].requires_grad


def test_encoder_init_has_the_jax_trees():
    params, bn = model.contrastive_encoder_init(CONFIG, prng.PRNGKey(0))
    jp, jbn = jax_model.contrastive_encoder_init(jax.random.PRNGKey(0), JAX_CONFIG)
    for own, ref in ((params, jp), (bn, jbn)):
        assert ({k: tuple(v.shape) for k, v in flatten_tree(own).items()}
                == {k: tuple(v.shape) for k, v in flatten_tree(jax.device_get(ref)).items()})


@pytest.mark.parametrize("train", [True, False])
def test_encoder_forward_matches_jax(train):
    js = jax_state(1)
    js["bn"] = jax.tree.map(lambda a: a + 0.1, js["bn"])        # non-trivial running stats
    state = contrastive_state_from_jax(js, "cpu")
    x = np.stack([g for gs in by_word(3).values() for g in gs])
    want, want_bn = jax_apply(js["params"], js["bn"], jnp.asarray(x), train=train)
    got, got_bn = model.contrastive_encoder_apply(state["params"], state["bn"], t_(x), train=train)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got.detach().numpy(), axis=1), 1.0, atol=1e-6)
    for a, b in zip(tree_leaves(got_bn), jax.tree.leaves(want_bn)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_supcon_loss_and_gradient_match_jax():
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(9, 16)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    labels = np.array([0, 0, 1, 1, 1, 2, 2, 3, 4])              # two rows without positives
    want, want_g = jax.value_and_grad(lambda e: jax_supcon(e, jnp.asarray(labels), 0.07))(
        jnp.asarray(emb))
    e = t_(emb).requires_grad_(True)
    got = supervised_contrastive_loss(e, t_(labels), 0.07)
    (grad,) = torch.autograd.grad(got, e)
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_g), atol=1e-5)


# -- the step and the epoch ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def train_arrays():
    train, _ = data.create_contrastive_datasets(by_word(5), seed=3, verbose=False)
    rows = data.sample_epoch_batches(train, CONFIG.batch_words, CONFIG.gestures_per_word,
                                     random.Random(11))
    rows = np.concatenate([rows, rows[::-1], rows])[:3]
    assert rows.shape == (3, 16)
    return train, rows


def test_one_clip_adam_step_matches_jax(train_arrays):
    train, rows = train_arrays
    js = jax_state(2)
    batch, labels = train.gestures[rows[0]], train.labels[rows[0]]

    @jax.jit
    def jax_step(params, opt):
        def loss_fn(p):
            emb, new_bn = jax_model.contrastive_encoder_apply(p, js["bn"], jnp.asarray(batch),
                                                              train=True)
            return jax_supcon(emb, jnp.asarray(labels), 0.07), new_bn

        (loss, new_bn), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        new_p, _ = jax_apply_update(params, g, opt, jax_loop.make_contrastive_optimizer(), LR)
        return loss, new_bn, g, new_p

    want_loss, want_bn, want_g, want_p = jax.device_get(jax_step(js["params"], js["opt"]))

    state = contrastive_state_from_jax(js, "cpu")
    grads = torch.autograd.grad(
        supervised_contrastive_loss(model.contrastive_encoder_apply(
            state["params"], state["bn"], t_(batch), train=True)[0], t_(labels).long()),
        tree_leaves(state["params"]))
    g_scale = max(float(np.abs(g).max()) for g in jax.tree.leaves(want_g))
    for a, b in zip(grads, jax.tree.leaves(want_g)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5 * g_scale)

    loss = loop.contrastive_train_step(state, t_(batch), t_(labels).long(), LR, CONFIG)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    assert state["step"] == 1 and state["opt"]["count"] == 1
    for a, b, g in zip(tree_leaves(state["params"]), jax.tree.leaves(want_p),
                       jax.tree.leaves(want_g)):
        near_zero = np.abs(np.asarray(g)) < 1e-4 * g_scale
        err = np.abs(a.detach().numpy() - np.asarray(b))
        assert (err <= 1e-5 + 2 * LR * near_zero).all()
    for a, b in zip(tree_leaves(state["bn"]), jax.tree.leaves(want_bn)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_three_epoch_steps_match_jax(train_arrays):
    """Three steps of ``contrastive_train_epoch`` on the same index rows,
    with the cosine learning rate on the global step (total 3 steps)."""
    train, rows = train_arrays
    js = jax_state(3)
    schedule = (CONFIG.learning_rate, CONFIG.eta_min, 3)
    epoch = jax.jit(lambda s, g, l, bi: jax_loop.contrastive_train_epoch(s, g, l, bi, schedule,
                                                                         JAX_CONFIG))
    want_state, want_losses = jax.device_get(epoch(js, jnp.asarray(train.gestures),
                                                   jnp.asarray(train.labels), jnp.asarray(rows)))
    state, losses = loop.contrastive_train_epoch(
        contrastive_state_from_jax(js, "cpu"), t_(train.gestures), t_(train.labels).long(), rows,
        schedule, CONFIG)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses), rtol=1e-4)
    assert (state["epoch"], state["step"]) == (int(want_state["epoch"]), int(want_state["step"]))
    assert state["opt"]["count"] == 3
    # The conv biases in front of BatchNorm get ~0 gradients, so Adam may
    # move them by ±lr per step in either package: parameters within 2·lr
    # per step, and the running means (which see those biases, at momentum
    # 0.1) within 0.1·2·lr per step; the running variances do not see them.
    for a, b in zip(tree_leaves(state["params"]), jax.tree.leaves(want_state["params"])):
        assert np.abs(a.detach().numpy() - np.asarray(b)).max() <= 1e-4 + 2 * 3 * LR
    for got_bn, want_bn in zip(state["bn"]["bns"], want_state["bn"]["bns"]):
        assert np.abs(got_bn["mean"].numpy() - want_bn["mean"]).max() <= 1e-5 + 0.1 * 2 * 3 * LR
        np.testing.assert_allclose(got_bn["var"].numpy(), want_bn["var"], rtol=1e-4)


# -- data -----------------------------------------------------------------------------------------


def test_keyboard_leftovers_match_jax():
    kb, jkb = QWERTYKeyboard(), JaxQWERTYKeyboard()
    for w in ("hello", "a", "", "zz", "keyboard"):
        np.testing.assert_array_equal(kb.get_key_indices(w, 64), jkb.get_key_indices(w, 64))
        for std in (0.0, 0.03):
            np.testing.assert_array_equal(
                kb.get_minimum_jerk_trajectory(w, 48, offset_std=std,
                                               rng=np.random.default_rng(1)),
                jkb.get_minimum_jerk_trajectory(w, 48, offset_std=std,
                                                rng=np.random.default_rng(1)))


def _arrays_equal(a, b):
    np.testing.assert_array_equal(a.gestures, b.gestures)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.words == b.words and a.unique_words == b.unique_words
    assert a.word_to_indices == b.word_to_indices


def test_data_functions_are_bit_equal():
    g = by_word(6)
    aug = data.augment_with_minimum_jerk(g, QWERTYKeyboard(), 2, 0.02, SEQ,
                                         rng=np.random.default_rng(0))
    jaug = jax_data.augment_with_minimum_jerk(g, JaxQWERTYKeyboard(), 2, 0.02, SEQ,
                                              rng=np.random.default_rng(0))
    assert list(aug) == list(jaug)
    for w in aug:
        np.testing.assert_array_equal(np.stack(aug[w]), np.stack(jaug[w]))

    arrays = data.ContrastiveArrays.from_gestures_by_word(g, 2, verbose=False)
    jarrays = jax_data.ContrastiveArrays.from_gestures_by_word(g, 2, verbose=False)
    _arrays_equal(arrays, jarrays)
    assert "alone" not in arrays.unique_words

    np.testing.assert_array_equal(data.sample_epoch_batches(arrays, 4, 2, random.Random(9)),
                                  jax_data.sample_epoch_batches(jarrays, 4, 2, random.Random(9)))
    sampler = data.ContrastiveBatchSampler(arrays, 4, 2, seed=5)
    jsampler = jax_data.ContrastiveBatchSampler(jarrays, 4, 2, seed=5)
    assert len(sampler) == len(jsampler) == len(arrays.unique_words) // 4
    for _ in range(2):
        np.testing.assert_array_equal(np.stack(list(sampler)), np.stack(list(jsampler)))
    with pytest.raises(ValueError, match="Not enough words"):
        data.sample_epoch_batches(arrays, 40, 2)

    for augment in (False, True):
        kw = dict(seed=8, augment_min_jerk=augment, min_jerk_augmentations=1, verbose=False)
        got = data.create_contrastive_datasets(g, keyboard=QWERTYKeyboard(), **kw)
        want = jax_data.create_contrastive_datasets(g, keyboard=JaxQWERTYKeyboard(), **kw)
        for a, b in zip(got, want):
            _arrays_equal(a, b)


def test_word_labels_up_to_relabelling():
    words = ["b", "a", "c", "a", "b", "d", "a"]
    got, want = data.word_labels_to_array(words), jax_data.word_labels_to_array(words)
    assert got.dtype == np.int32 and sorted(set(got)) == [0, 1, 2, 3]
    # One label per word and one word per label, in both: the two mappings
    # differ by a relabelling at most.
    for labels in (got, want):
        assert len({(w, int(x)) for w, x in zip(words, labels)}) == len(set(words))
        assert len({int(x) for x in labels}) == len(set(words))
    assert len({(int(a), int(b)) for a, b in zip(got, want)}) == len(set(words))


# -- embedding and the metrics --------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained_pair():
    """One JAX state after a step, and the port's copy of it."""
    js = jax_state(4)
    js["bn"] = jax.tree.map(lambda a: a * 1.5 + 0.05, js["bn"])
    js["epoch"], js["step"], js["best_recall"] = np.int32(3), np.int32(12), np.float32(0.25)
    return js, contrastive_state_from_jax(js, "cpu")


def test_embed_gestures_matches_jax(trained_pair):
    js, state = trained_pair
    g = np.stack([x for xs in by_word(7).values() for x in xs])           # not a power of two
    want = jax_loop.embed_gestures(js, g, JAX_CONFIG, batch=16)
    got = loop.embed_gestures(state, g, CONFIG, batch=16)
    assert got.shape == (len(g), 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert loop.embed_gestures(state, g[:0], CONFIG).shape == (0, 64)


def test_recall_metrics_match_jax(trained_pair):
    js, state = trained_pair
    g = by_word(8)
    arrays = data.ContrastiveArrays.from_gestures_by_word(g, 2, verbose=False)
    emb = loop.embed_gestures(state, arrays.gestures, CONFIG)
    want = jax_loop.centroid_recall(emb, arrays.words)
    got = loop.centroid_recall(emb, arrays.words)
    assert list(got) == list(want)
    assert all(abs(got[k] - want[k]) <= 1e-6 for k in want)

    want = jax_eval.evaluate_recall(emb, arrays.labels)
    got = contrastive_eval.evaluate_recall(emb, arrays.labels, device="cpu")
    assert list(got) == list(want)
    assert all(abs(got[k] - want[k]) <= 1e-6 for k in want)

    hits = contrastive_eval.similarity_search(emb[3], emb, arrays.words, top_k=5)
    assert hits == jax_eval.similarity_search(emb[3], emb, arrays.words, top_k=5)
    assert hits[0]["index"] == 3


def test_evaluate_centroids_matches_jax(trained_pair):
    js, state = trained_pair
    g = by_word(9, seq=128)
    kw = dict(sample_counts=(2, 5), seed=3, verbose=False)
    want = jax_eval.evaluate_centroids(js, g, JaxQWERTYKeyboard(), JAX_CONFIG, **kw)
    got = contrastive_eval.evaluate_centroids(state, g, QWERTYKeyboard(), CONFIG, **kw)
    assert list(got) == list(want)
    assert all(abs(got[k] - want[k]) <= 1e-6 for k in want)


def test_contrastive_state_from_jax_round_trip():
    """A JAX state after one epoch (Adam moments, counters) → the port's:
    every leaf and counter carried exactly."""
    train, _ = data.create_contrastive_datasets(by_word(10), seed=3, verbose=False)
    rows = data.sample_epoch_batches(train, 8, 2, random.Random(0))[:1]
    js, _ = jax.device_get(jax_loop.contrastive_train_epoch(
        jax_state(5), jnp.asarray(train.gestures), jnp.asarray(train.labels), jnp.asarray(rows),
        (1e-3, 1e-5, 10), JAX_CONFIG))
    js["best_recall"] = np.float32(0.5)
    state = contrastive_state_from_jax(js, "cpu")
    for a, b in zip(tree_leaves(state["params"]), jax.tree.leaves(js["params"])):
        assert a.requires_grad and np.array_equal(a.detach().numpy(), np.asarray(b))
    adam = js["opt"][1]
    for part in ("mu", "nu"):
        for a, b in zip(tree_leaves(state["opt"][part]), jax.tree.leaves(getattr(adam, part))):
            assert np.array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tree_leaves(state["bn"]), jax.tree.leaves(js["bn"])):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert (state["epoch"], state["step"], state["opt"]["count"]) == (1, 1, 1)
    assert state["best_recall"] == 0.5
    fresh = contrastive_state_from_jax({"params": js["params"], "bn": js["bn"]}, "cpu")
    assert fresh["opt"]["count"] == 0 and fresh["epoch"] == 0
    assert all(not t.any() for t in tree_leaves(fresh["opt"]["mu"]))


# -- the loop and its checkpoints -----------------------------------------------------------------


def test_train_contrastive_checkpoints_and_resumes(tmp_path):
    g = by_word(11)
    train, test = data.create_contrastive_datasets(g, seed=2, verbose=False)
    cfg = ContrastiveConfig(batch_words=4, gestures_per_word=2)
    state, history = loop.train_contrastive(train, test, cfg, num_epochs=2, seed=1,
                                            checkpoint_dir=str(tmp_path), eval_every=1,
                                            verbose=False, device="cpu")
    steps = len(train.unique_words) // 4
    assert (state["epoch"], state["step"]) == (2, 2 * steps)
    assert len(history["train_loss"]) == len(history["epoch_seconds"]) == 2
    assert np.isfinite(history["train_loss"]).all() and len(history["test_recall@1"]) == 2
    assert (tmp_path / "contrastive_latest.pt").exists() and not (tmp_path / "latest.pt").exists()
    assert checkpoint.latest_epoch(str(tmp_path)) >= 1           # a best-recall snapshot

    resumed, more = loop.train_contrastive(train, test, cfg, num_epochs=3, seed=1,
                                           checkpoint_dir=str(tmp_path), eval_every=1,
                                           verbose=False, device="cpu")
    assert (resumed["epoch"], resumed["step"]) == (3, 3 * steps)
    assert len(more["train_loss"]) == 1
    assert resumed["best_recall"] == max(history["test_recall@1"] + more["test_recall@1"])
    lines = (tmp_path / "history.jsonl").read_text().splitlines()
    assert len(lines) == 3

    # A missing named snapshot falls back to the newest epoch_N.pt.
    (tmp_path / "contrastive_latest.pt").unlink()
    again = checkpoint.restore_checkpoint(loop.init_contrastive_state(0, cfg, "cpu"),
                                          str(tmp_path), "contrastive_latest.pt")
    assert again["epoch"] == checkpoint.latest_epoch(str(tmp_path))


def test_contrastive_snapshot_replaces_a_gan_snapshot_of_its_epoch(tmp_path):
    """A reference behaviour kept: both trainers write ``epoch_{N}`` into one
    checkpoint directory. Resuming, the contrastive run falls back from its
    missing named snapshot to the GAN's ``epoch_1`` and refuses it; without
    resuming it replaces the GAN's ``epoch_1`` (which the GAN's ``latest``
    points at), and restoring the GAN from there refuses the contrastive
    state."""
    mcfg = ModelConfig(gen_hidden_dim=8, latent_dim=4, seq_length=16, enc_hidden_dims=(8,),
                       disc_hidden_dims=(8,))
    checkpoint.save_checkpoint(init_gan_state(0, mcfg, "cpu"), str(tmp_path), 0)
    train, test = data.create_contrastive_datasets(by_word(12), seed=2, verbose=False)
    kw = dict(num_epochs=1, checkpoint_dir=str(tmp_path), eval_every=1, verbose=False,
              device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        loop.train_contrastive(train, test, ContrastiveConfig(batch_words=4), **kw)
    loop.train_contrastive(train, test, ContrastiveConfig(batch_words=4), resume=False, **kw)
    assert (tmp_path / "latest.pt").resolve().name == "epoch_1.pt"
    with pytest.raises(ValueError, match="does not match"):
        checkpoint.restore_checkpoint(init_gan_state(0, mcfg, "cpu"), str(tmp_path))


def test_train_contrastive_defaults_to_the_gpu():
    import inspect

    assert inspect.signature(loop.train_contrastive).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            loop.train_contrastive(None, None)


# -- the CLIs, end to end -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """``train_contrastive_cli`` for 2 epochs, then a resumed third, on a
    24-user synthetic corpus (120 words with two gestures or more)."""
    base = tmp_path_factory.mktemp("contrastive")
    flags = ["--synthetic", "--synthetic-users", "24", "--data", str(base / "swipelogs.zip"),
             "--checkpoint-dir", str(base / "ckpt"), "--device", "cpu"]
    first = train_contrastive_cli.main(["--epochs", "2", "--augment-min-jerk", *flags])
    second = train_contrastive_cli.main(["--epochs", "3", "--augment-min-jerk", *flags])
    return base, flags, first, second


def test_train_contrastive_cli_trains_and_resumes(cli_run):
    base, _, (state, history), (resumed, more) = cli_run
    steps = state["step"] // 2
    assert steps >= 2 and state["epoch"] == 2 and len(history["train_loss"]) == 2
    assert (resumed["epoch"], resumed["step"]) == (3, 3 * steps)
    assert len(more["train_loss"]) == 1 and np.isfinite(more["train_loss"]).all()
    assert (base / "ckpt" / "contrastive_latest.pt").exists()


def test_eval_contrastive_cli_scores_the_checkpoint(cli_run, capsys):
    base, flags, _, (resumed, _) = cli_run
    g, _ = load_dataset_from_zip(str(base / "synthetic_swipelogs_24.zip"), QWERTYKeyboard(),
                                 ModelConfig(), TrainingConfig(), verbose=False)
    _, test = data.create_contrastive_datasets(g, 0.8, seed=42, verbose=False)
    word = test.words[0]
    out = eval_contrastive_cli.main(["--centroids", "--tsne", "--query", word, "--output-dir",
                                     str(base / "eval"), *flags])
    printed = capsys.readouterr().out
    assert "Retrieval metrics (test set)" in printed and f"Top matches for '{word}'" in printed
    assert "Centroid Quality: Real vs Min Jerk" in printed
    assert out["epoch"] == resumed["epoch"] and out["best_recall"] == resumed["best_recall"]
    assert set(out["recall"]) == {"recall@1", "recall@5", "recall@10", "recall@20", "mAP"}
    assert all(0.0 <= v <= 1.0 for v in [*out["recall"].values(), *out["centroids"].values()])
    assert out["query"][0]["word"] == word and out["query"][0]["similarity"] == pytest.approx(1.0)
    assert set(out["centroids"]) == {"real_recall@1", *(f"minjerk_{n}_recall@1"
                                                        for n in (5, 10, 20, 50))}
    assert (base / "eval" / "tsne.png").exists()
    # The port's embeddings of the same checkpoint give the same recall.
    emb = loop.embed_gestures(resumed, test.gestures, ContrastiveConfig())
    assert out["recall"] == contrastive_eval.evaluate_recall(emb, test.labels, device="cpu")


def test_eval_contrastive_cli_without_a_checkpoint(cli_run, tmp_path):
    _, flags, _, _ = cli_run
    flags = [str(tmp_path) if a.endswith("ckpt") else a for a in flags]
    with pytest.raises(SystemExit) as exit_info:
        eval_contrastive_cli.main(flags)
    assert exit_info.value.code == 1


@pytest.mark.parametrize("cli", [train_contrastive_cli, eval_contrastive_cli])
def test_contrastive_clis_default_to_the_card_and_refuse_without_one(cli, capsys):
    assert cli.build_parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit) as exit_info:
        cli.main([])
    assert exit_info.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_tsne_needs_sklearn_and_matplotlib(monkeypatch, capsys):
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "sklearn" else real(name, *a))
    with pytest.raises(SystemExit) as exit_info:
        eval_contrastive_cli.main(["--tsne", "--device", "cpu"])
    assert exit_info.value.code == 2
    assert "scikit-learn" in capsys.readouterr().err


def test_contrastive_cli_flags_are_the_jax_clis_flags():
    """Same flags and defaults as ``train_contrastive.py`` /
    ``eval_contrastive.py``, read from their sources."""

    def flags_of(source: str) -> dict:
        found = {}
        for node in ast.walk(ast.parse(source)):
            if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
                    and node.args and isinstance(node.args[0], ast.Constant)):
                found[node.args[0].value] = next((ast.literal_eval(k.value) for k in node.keywords
                                                  if k.arg == "default"), None)
        return found

    root = Path(train_contrastive_cli.__file__).resolve().parent.parent
    data_flags = {"--data", "--synthetic", "--synthetic-users", "--max-files", "--time64",
                  "--seed"}
    for cli, script, dropped in ((train_contrastive_cli, "train_contrastive.py", set()),
                                 (eval_contrastive_cli, "eval_contrastive.py", set())):
        want = flags_of((root / script).read_text())
        got = {a.option_strings[0]: a.default for a in cli.build_parser()._actions
               if a.option_strings and a.option_strings[0] != "-h"}
        assert set(want) - set(got) == dropped
        assert set(got) - set(want) - data_flags == {"--device"}
        assert all(got[k] == v for k, v in want.items() if k in got and v is not None)
