"""The PyTorch port's host-side copies — swipelog parsing, preprocessing, the
synthetic corpus writer, the dataset pipeline and the minimum-jerk baseline —
against the JAX package's modules of the same names, on the CPU.

These are numpy modules copied into the port, so everything is held
bit-equal (no tolerance): the same seed must give the same bytes and the
same arrays. Files are written under ``tmp_path`` only.
"""

import argparse
import dataclasses
import pickle
import random
import zipfile

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test worker

from wordgesture_gan_tpu import cli_common as jax_cli_common
from wordgesture_gan_tpu import configs as jax_configs
from wordgesture_gan_tpu import keyboard as jax_keyboard
from wordgesture_gan_tpu.data import parse as jax_parse
from wordgesture_gan_tpu.data import pipeline as jax_pipeline
from wordgesture_gan_tpu.data import preprocess as jax_preprocess
from wordgesture_gan_tpu.data import synthetic as jax_synthetic
from wordgesture_gan_tpu_torch import cli_common, configs, keyboard, viz
from wordgesture_gan_tpu_torch.data import native, parse, pipeline, preprocess, synthetic
from wordgesture_gan_tpu_torch.utils.logging import seed_everything

WRITER = dict(n_users=5, seed=3, n_sentences=4, words_per_sentence=4, max_vocab=60)
MALFORMED = "\n".join([
    "header row",
    "s0 1000 1080 360 touchstart 10.0 20.0 1 1 0 hello 0",
    "s0 1010 1080 360 touchmove 11.0 21.0 1 1 0 hello 0",
    "s0 1020 1080 360 touchend 12.0 22.0 1 1 0 hello 0",
    "s0 1030 1080 360 touchstart 10.0 20.0 1 1 0 world 1",        # error-flagged
    "s0 1040 1080 360 touchstart 10.0 20.0 1 1 0 a 0",            # single letter
    "s0 1050 1080 360 touchstart abc 20.0 1 1 0 water 0",         # malformed x
    "s0 10.5 1080 360 touchstart 10.0 20.0 1 1 0 water 0",        # non-integer time
    "s0 1060 1080 360 touchstart 10.0 20.0 water 0",              # too few columns
    "s0 1070 1080 360 touchstart 10.0 20.0 1 1 0 thing 0",        # only 2 points
    "s0 1080 1080 360 touchend 11.0 21.0 1 1 0 thing 0",
    "s0 1090 1080 360 touchstart 1.0 2.0 1 1 0 Sound 0",
    "s0 1100 xx 360 touchmove 2.0 3.0 1 1 0 sound 0",             # bad width: line dropped
    "s0 1110 1080 360 touchmove 3.0 4.0 1 1 0 sound 0",
    "s0 1120 1080 360 touchend 4.0 5.0 1 1 0 sound 0",
])


@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    """The same corpus written by the port's writer and by the JAX package's."""
    base = tmp_path_factory.mktemp("corpus")
    port = synthetic.write_synthetic_swipelogs_zip(str(base / "port" / "swipelogs.zip"), **WRITER)
    ref = jax_synthetic.write_synthetic_swipelogs_zip(str(base / "jax" / "swipelogs.zip"),
                                                      **WRITER)
    return port, ref


def members(path):
    with zipfile.ZipFile(path) as zf:
        return {name: zf.read(name) for name in zf.namelist()}


def assert_same_parse(a, b):
    assert list(a) == list(b)
    for word in a:
        assert len(a[word]) == len(b[word]), word
        for ga, gb in zip(a[word], b[word]):
            np.testing.assert_array_equal(np.asarray(ga.points), np.asarray(gb.points))
            assert (ga.keyb_width, ga.keyb_height) == (gb.keyb_width, gb.keyb_height)


def assert_same_by_word(a, b):
    assert list(a) == list(b)
    for word in a:
        if isinstance(a[word], np.ndarray):
            np.testing.assert_array_equal(a[word], b[word])
        else:
            assert len(a[word]) == len(b[word])
            for ga, gb in zip(a[word], b[word]):
                assert ga.dtype == gb.dtype
                np.testing.assert_array_equal(ga, gb)


# -- configuration and small utilities -------------------------------------------------------


@pytest.mark.parametrize("name", ["EvaluationConfig", "PathsConfig", "ModelConfig",
                                  "TrainingConfig", "KeyboardConfig"])
def test_config_dataclasses_have_the_jax_package_s_fields_and_defaults(name):
    assert configs.asdict(getattr(configs, name)()) == jax_configs.asdict(
        getattr(jax_configs, name)())


def test_seed_everything_seeds_random_numpy_and_torch():
    seed_everything(5)
    first = (random.random(), np.random.rand(), torch.rand(1).item())
    seed_everything(5)
    assert (random.random(), np.random.rand(), torch.rand(1).item()) == first


# -- synthetic corpus, parsing, preprocessing ------------------------------------------------


def test_synthetic_writer_gives_the_same_members_byte_for_byte(zips):
    # (A zip's own bytes also hold each member's time of writing, so the
    # archives are compared member by member.)
    port, ref = members(zips[0]), members(zips[1])
    assert list(port) == list(ref) and len(port) == WRITER["n_users"]
    assert port == ref


def test_word_list_and_frequencies_from_the_repo_s_table():
    table = str(cli_common.Path(cli_common.__file__).resolve().parent.parent
                / "dataset" / "wordfreq.txt")
    words = synthetic.load_word_list(table, max_words=300)
    assert words == jax_synthetic.load_word_list(table, max_words=300) and len(words) == 300
    np.testing.assert_array_equal(synthetic.word_frequencies(table, words),
                                  jax_synthetic.word_frequencies(table, words))
    assert synthetic.load_word_list(None) == jax_synthetic.load_word_list(None)


def test_python_parser_matches_jax_package(zips):
    for name, raw in members(zips[0]).items():
        content = raw.decode()
        assert_same_parse(parse.parse_log_file(content), jax_parse.parse_log_file(content))
    assert_same_parse(parse.parse_log_file(MALFORMED), jax_parse.parse_log_file(MALFORMED))
    assert list(parse.parse_log_file(MALFORMED)) == ["hello", "sound"]


def test_native_parser_matches_python_parser(zips):
    if not native.native_parser_available():
        pytest.skip("no g++ here: the Python parser is the route")
    for raw in members(zips[0]).values():
        content = raw.decode()
        assert_same_parse(parse.parse_log_file(content), native.parse_log_file_native(content))
    assert_same_parse(parse.parse_log_file(MALFORMED), native.parse_log_file_native(MALFORMED))
    assert native.parse_log_file_native("header only") == {}


@pytest.mark.parametrize("time64", [False, True])
def test_normalize_gesture_bit_equal(zips, time64):
    content = next(iter(members(zips[0]).values())).decode()
    raws = [g for gs in parse.parse_log_file(content).values() for g in gs]
    raws.append(parse.RawGesture(np.array([[5.0, 5.0, 0.0]] * 4), 1080.0, 360.0))   # no motion
    raws.append(parse.RawGesture(np.array([[5.0, 5.0, 0.0]]), 1080.0, 360.0))       # one point
    for raw in raws:
        got = preprocess.normalize_gesture(raw, 64, time64=time64)
        want = jax_preprocess.normalize_gesture(jax_parse.RawGesture(*raw), 64, time64=time64)
        assert got.dtype == np.float32 and got.shape == (64, 3)
        np.testing.assert_array_equal(got, want)


def test_canonical_transform_bit_equal(zips):
    by_word, _ = pipeline.load_dataset_from_zip(zips[0], keyboard.QWERTYKeyboard(),
                                                use_cache=False, verbose=False)
    inferred = preprocess.infer_key_positions(by_word, min_samples=2)
    assert inferred == jax_preprocess.infer_key_positions(by_word, min_samples=2)
    got = preprocess.compute_canonical_transform(inferred, keyboard.QWERTYKeyboard())
    assert got == jax_preprocess.compute_canonical_transform(inferred,
                                                             jax_keyboard.QWERTYKeyboard())
    g = next(iter(by_word.values()))[0]
    np.testing.assert_array_equal(preprocess.apply_canonical_transform(g, got),
                                  jax_preprocess.apply_canonical_transform(g, got))
    with pytest.raises(ValueError, match="too small"):
        preprocess.compute_canonical_transform({"a": (0.0, 0.0)}, keyboard.QWERTYKeyboard())


# -- the pipeline ---------------------------------------------------------------------------


def load_both(zips, **kwargs):
    random.seed(11)
    got = pipeline.load_dataset_from_zip(zips[0], keyboard.QWERTYKeyboard(), configs.ModelConfig(),
                                         configs.TrainingConfig(max_samples_per_word=2),
                                         verbose=False, **kwargs)
    random.seed(11)
    want = jax_pipeline.load_dataset_from_zip(
        zips[1], jax_keyboard.QWERTYKeyboard(), jax_configs.ModelConfig(),
        jax_configs.TrainingConfig(max_samples_per_word=2), verbose=False, **kwargs)
    return got, want


@pytest.mark.parametrize("kwargs", [dict(use_cache=False), dict(use_cache=False, time64=True),
                                    dict(use_cache=False, max_files=4)])
def test_load_dataset_from_zip_bit_equal(zips, kwargs):
    (g, p), (jg, jp) = load_both(zips, **kwargs)
    assert len(g) > 10
    assert_same_by_word(g, jg)
    assert_same_by_word(p, jp)


def test_preprocessing_cache_has_the_jax_package_s_format(zips):
    (g, p), (jg, jp) = load_both(zips)                      # both write their cache
    mcfg, tcfg = configs.ModelConfig(), configs.TrainingConfig(max_samples_per_word=2)
    port_cache = pipeline._cache_path(zips[0], mcfg, tcfg)
    assert port_cache.name == jax_pipeline._cache_path(zips[0], mcfg, tcfg).name
    assert port_cache.exists() and port_cache.parent == cli_common.Path(zips[0]).parent
    with open(port_cache, "rb") as f:
        cached = pickle.load(f)
    assert set(cached) == {"gestures_by_word", "prototypes_by_word"}
    # Either package reads the file the other wrote.
    rg, rp = jax_pipeline.load_dataset_from_zip(zips[0], jax_keyboard.QWERTYKeyboard(),
                                                jax_configs.ModelConfig(),
                                                jax_configs.TrainingConfig(max_samples_per_word=2),
                                                verbose=False)
    assert_same_by_word(rg, g)
    assert_same_by_word(rp, p)
    again, _ = pipeline.load_dataset_from_zip(zips[0], keyboard.QWERTYKeyboard(), mcfg, tcfg,
                                              verbose=False)
    assert_same_by_word(again, g)


def test_create_train_test_split_bit_equal(zips):
    (g, p), (jg, jp) = load_both(zips, use_cache=False)
    for seed in (42, 7):
        got = pipeline.create_train_test_split(g, p, 0.8, seed=seed, verbose=False)
        want = jax_pipeline.create_train_test_split(jg, jp, 0.8, seed=seed, verbose=False)
        for a, b in zip(got, want):
            assert a.words == b.words and a.gestures.dtype == np.float32
            np.testing.assert_array_equal(a.gestures, b.gestures)
            np.testing.assert_array_equal(a.prototypes, b.prototypes)
            np.testing.assert_array_equal(a.word_ids, b.word_ids)
        assert not set(got[0].words) & set(got[1].words)
    empty_train, _ = pipeline.create_train_test_split({}, {}, verbose=False)
    assert empty_train.gestures.shape == (0, 128, 3)


def test_cli_dataset_resolution(tmp_path):
    parser = argparse.ArgumentParser()
    cli_common.add_data_args(parser)
    jax_parser = argparse.ArgumentParser()
    jax_cli_common.add_data_args(jax_parser)
    assert vars(parser.parse_args([])) == vars(jax_parser.parse_args([]))
    args = parser.parse_args(["--data", str(tmp_path / "swipelogs.zip")])
    with pytest.raises(FileNotFoundError, match="--synthetic"):
        cli_common.resolve_dataset_zip(args)
    args = parser.parse_args(["--data", str(tmp_path / "swipelogs.zip"), "--synthetic",
                              "--synthetic-users", "2"])
    path = cli_common.resolve_dataset_zip(args)
    assert path == str(tmp_path / "synthetic_swipelogs_2.zip")
    assert cli_common.resolve_dataset_zip(args) == path                 # reused, not rewritten
    assert len(members(path)) == 2
    assert cli_common.maybe_wandb(False) is None


# -- the minimum-jerk baseline ---------------------------------------------------------------


def test_minimum_jerk_primitives_bit_equal():
    t = np.linspace(0, 1, 17)
    np.testing.assert_array_equal(keyboard.minimum_jerk_quintic(t),
                                  jax_keyboard.minimum_jerk_quintic(t))
    for a, b in zip(keyboard.quintic_hermite_bases(t), jax_keyboard.quintic_hermite_bases(t)):
        np.testing.assert_array_equal(a, b)
    p = np.array([[0.0, 0.0], [1.0, 0.5]])
    args = (p[0], p[1], p[1] - p[0], p[0] - p[1], p[0], p[1], t)
    np.testing.assert_array_equal(keyboard.quintic_hermite_segment(*args),
                                  jax_keyboard.quintic_hermite_segment(*args))
    kb, jkb = keyboard.QWERTYKeyboard(), jax_keyboard.QWERTYKeyboard()
    for word in ("hello", "a", "", "x-ray"):
        np.testing.assert_array_equal(kb.get_key_centers_for_word(word),
                                      jkb.get_key_centers_for_word(word))


@pytest.mark.parametrize("word", ["hello", "it", "q", "", "aaa", "keyboard"])
@pytest.mark.parametrize("offset_std,midpoints", [(0.0, True), (0.03, True), (0.03, False)])
def test_minimum_jerk_trajectories_bit_equal(word, offset_std, midpoints):
    via = keyboard.QWERTYKeyboard().get_key_centers_for_word(word)
    got = keyboard.generate_minimum_jerk_trajectory(via, 64, midpoints, offset_std,
                                                    rng=np.random.default_rng(1))
    want = jax_keyboard.generate_minimum_jerk_trajectory(via, 64, midpoints, offset_std,
                                                         rng=np.random.default_rng(1))
    assert got.dtype == np.float32 and got.shape == (64, 3)
    np.testing.assert_array_equal(got, want)
    got = keyboard.generate_minimum_jerk_trajectory_fitted(
        via, 64, midpoints, (0.01, -0.01), (0.02, 0.03), 0.01, 0.1, rng=np.random.default_rng(2))
    want = jax_keyboard.generate_minimum_jerk_trajectory_fitted(
        via, 64, midpoints, (0.01, -0.01), (0.02, 0.03), 0.01, 0.1, rng=np.random.default_rng(2))
    np.testing.assert_array_equal(got, want)


def test_minimum_jerk_model_fit_and_sampling_bit_equal(zips, capsys):
    (g, _), _ = load_both(zips, use_cache=False)
    model = keyboard.MinimumJerkModel(keyboard.QWERTYKeyboard()).fit(g, verbose=True)
    ref = jax_keyboard.MinimumJerkModel(jax_keyboard.QWERTYKeyboard()).fit(g, verbose=False)
    assert "MinimumJerkModel fitted" in capsys.readouterr().out
    assert model.distributions.is_fitted()
    assert dataclasses.asdict(model.distributions) == dataclasses.asdict(ref.distributions)
    rng, jrng = np.random.default_rng(4), np.random.default_rng(4)
    for word in ("hello", "world", "a", "", "gesture"):
        np.testing.assert_array_equal(model.generate_trajectory(word, 64, rng=rng),
                                      ref.generate_trajectory(word, 64, rng=jrng))
    assert not keyboard.MinimumJerkModel(keyboard.QWERTYKeyboard()).distributions.is_fitted()


# -- figures ---------------------------------------------------------------------------------


def test_figures_render(tmp_path):
    import matplotlib.pyplot as plt

    kb = keyboard.QWERTYKeyboard()
    real = np.stack([kb.get_word_prototype(w, 32) for w in ("hello", "world")])
    fig = viz.create_comparison_figure(real, real[::-1], ["hello", "world"])
    fig.savefig(tmp_path / "comparison.png", dpi=50)
    plt.close(fig)
    fig = viz.create_overlay_figure(real, real, "hello")
    fig.savefig(tmp_path / "overlay.png", dpi=50)
    plt.close(fig)
    assert (tmp_path / "comparison.png").stat().st_size > 0
    assert (tmp_path / "overlay.png").stat().st_size > 0
