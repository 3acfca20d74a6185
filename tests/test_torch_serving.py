"""The PyTorch port's serving slice against the JAX package, on the CPU:
words → keyboard prototypes (bit-identical) → chunked generation with
injected noise (== JAX ``generator_apply`` on the same z, float32, 1e-5 abs)
→ the CLI's ``.npz``; sampling at a seed draws JAX's noise; plus weight
interchange, run metadata, and a check that
no module of the port imports JAX or the JAX package.
"""

import ast
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

from wordgesture_gan_tpu import keyboard as jax_keyboard
from wordgesture_gan_tpu.configs import ModelConfig as JaxModelConfig
from wordgesture_gan_tpu.models.gan import generator_apply, generator_init
from wordgesture_gan_tpu.utils import chunking as jax_chunking
from wordgesture_gan_tpu_torch import generate, keyboard
from wordgesture_gan_tpu_torch.configs import ModelConfig
from wordgesture_gan_tpu_torch.interop.from_jax import (flatten_tree, generator_from_jax,
                                                        generator_from_npz, read_generator_npz,
                                                        unflatten_tree, write_generator_npz)
from wordgesture_gan_tpu_torch.models.gan import Generator
from wordgesture_gan_tpu_torch.train.checkpoint import (load_generator, load_generator_weights,
                                                        load_run_metadata)
from wordgesture_gan_tpu_torch.train.gan_loop import generate_gestures
from wordgesture_gan_tpu_torch.train.sample_graph import chunk_keys
from wordgesture_gan_tpu_torch.utils import chunking
from wordgesture_gan_tpu_torch.utils import prng

REPO = Path(__file__).resolve().parent.parent
WORDS = ["hello", "world", "the", "a", "aa", "", "Don't", "qwerty", "zzz", "typing",
         "abcdefghijklmnopqrstuvwxyz", "pop", "mississippi"]
SMALL = dict(seq_length=32, gen_hidden_dim=16, gen_num_layers=2, latent_dim=8)


def _jax_params(seed=0, **fields):
    return jax.device_get(generator_init(jax.random.PRNGKey(seed), JaxModelConfig(**fields)))


# -- keyboard and chunking ----------------------------------------------------


@pytest.mark.parametrize("num_points", [128, 37])
def test_word_prototypes_bit_identical(num_points):
    ours, theirs = keyboard.QWERTYKeyboard(), jax_keyboard.QWERTYKeyboard()
    for word in WORDS:
        a = ours.get_word_prototype(word, num_points)
        b = theirs.get_word_prototype(word, num_points)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=word)


def test_key_geometry_identical():
    assert keyboard.compute_key_centers() == jax_keyboard.compute_key_centers()
    for word in WORDS:
        np.testing.assert_array_equal(keyboard.word_to_key_indices(word),
                                      jax_keyboard.word_to_key_indices(word))
    rng = np.random.default_rng(0)
    for dtype in (np.float32, np.float64):
        points = rng.uniform(-1, 1, (6, 2)).astype(dtype)
        points[3] = points[2]   # a zero-length segment
        np.testing.assert_array_equal(keyboard.resample_polyline_by_arclength(points, 50),
                                      jax_keyboard.resample_polyline_by_arclength(points, 50))


def test_chunk_layout_parity():
    for n in range(1, 70):
        for batch in (1, 4, 7, 16, 512):
            assert chunking.chunk_layout(n, batch) == jax_chunking.chunk_layout(n, batch)
    a = np.arange(15, dtype=np.float64).reshape(5, 3)
    np.testing.assert_array_equal(chunking.pad_to_chunks(a, 4, 2),
                                  jax_chunking.pad_to_chunks(a, 4, 2))


# -- generation ----------------------------------------------------------------


@pytest.mark.parametrize("time_head", ["tanh", "monotone"])
def test_generate_gestures_matches_jax(time_head):
    """The whole slice: words → prototypes → chunked generation == JAX
    generator_apply on the same z (n=7 at batch 4: two chunks, one padded)."""
    fields = dict(SMALL, time_head=time_head)
    params = _jax_params(1, **fields)
    model = Generator(ModelConfig(**fields))
    model.load_state_dict(generator_from_jax(params))
    words = ["hello", "world", "a", "gesture", "keyboard", "zzz", "swipe"]
    kb = keyboard.QWERTYKeyboard()
    protos = np.stack([kb.get_word_prototype(w, SMALL["seq_length"]) for w in words])
    z = np.random.default_rng(2).normal(size=(len(words), SMALL["latent_dim"])).astype(np.float32)
    out = generate_gestures(model, protos, model.config, truncation=0.7, batch=4,
                            device="cpu", z=z)
    ref = generator_apply(params, jnp.asarray(protos), jnp.asarray(z * np.float32(0.7)),
                          JaxModelConfig(**fields), inference=True)
    assert out.shape == (len(words), SMALL["seq_length"], 3) and out.dtype == np.float32
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)


def test_generate_gestures_seeded_noise():
    model = Generator(ModelConfig(**SMALL), prng.PRNGKey(0))
    protos = np.random.default_rng(3).uniform(-1, 1, (9, SMALL["seq_length"], 3))
    a = generate_gestures(model, protos, model.config, seed=5, batch=4, device="cpu")
    b = generate_gestures(model, protos, model.config, seed=5, batch=4, device="cpu")
    c = generate_gestures(model, protos, model.config, seed=6, batch=4, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c)
    assert np.isfinite(a).all() and a.shape == (9, SMALL["seq_length"], 3)
    empty = generate_gestures(model, protos[:0], model.config, device="cpu")
    assert empty.shape == (0, SMALL["seq_length"], 3)


@pytest.mark.parametrize("n", [1, 4, 9])
def test_generate_gestures_returns_an_array_of_its_own(n):
    """Exactly n rows (the last chunk's padding cropped) in a new array that
    owns its memory, whatever the chunks: no view of a padded buffer."""
    model = Generator(ModelConfig(**SMALL), prng.PRNGKey(0))
    protos = np.random.default_rng(4).uniform(-1, 1, (n, SMALL["seq_length"], 3))
    out = generate_gestures(model, protos, model.config, seed=5, batch=4, device="cpu")
    assert out.shape == (n, SMALL["seq_length"], 3) and out.dtype == np.float32
    assert out.flags.owndata and out.base is None and out.flags.c_contiguous


@pytest.mark.parametrize("seed", [0, 42])
def test_generate_gestures_at_a_seed_draws_jaxs_noise(seed):
    """Without injected z both packages draw chunk c's noise as
    ``normal(fold_in(PRNGKey(seed), c), (chunk, Z))``: n=7 at batch 4 (two
    chunks, one padded), truncation 0.7, equal within the forward
    tolerance."""
    from wordgesture_gan_tpu.train.gan_loop import generate_gestures as jax_generate_gestures

    fields = dict(SMALL, time_head="monotone")
    params = _jax_params(4, **fields)
    model = Generator(ModelConfig(**fields))
    model.load_state_dict(generator_from_jax(params))
    kb = keyboard.QWERTYKeyboard()
    protos = np.stack([kb.get_word_prototype(w, SMALL["seq_length"]) for w in WORDS[:7]])
    got = generate_gestures(model, protos, model.config, truncation=0.7, seed=seed, batch=4,
                            device="cpu")
    want = jax_generate_gestures({"g": {"params": params}}, protos, JaxModelConfig(**fields),
                                 truncation=0.7, seed=seed, batch=4)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 2**33 + 5])
def test_chunk_keys_are_each_chunks_fold_in(seed):
    """A call's key stack, made before its chunk loop: row c is
    ``fold_in(PRNGKey(seed), c)``, the port's and JAX's."""
    keys = chunk_keys(seed, 33)
    assert keys.shape == (33, 2) and keys.dtype == torch.int64
    for c in range(33):
        assert torch.equal(keys[c], prng.fold_in(prng.PRNGKey(seed), c))
    want = jax.random.key_data(jax.vmap(jax.random.fold_in, (None, 0))(
        jax.random.PRNGKey(seed & 0xFFFFFFFF), jnp.arange(33)))
    np.testing.assert_array_equal(keys.numpy(), np.asarray(want).astype(np.int64))


def test_generate_gestures_rejects_bad_arguments():
    model = Generator(ModelConfig(**SMALL))
    protos = np.zeros((3, SMALL["seq_length"], 3), np.float32)
    with pytest.raises(ValueError, match="z must be"):
        generate_gestures(model, protos, model.config, device="cpu", z=np.zeros((2, 8)))
    with pytest.raises(ValueError, match="configuration"):
        generate_gestures(model, protos, ModelConfig(), device="cpu")


# -- weights and metadata -------------------------------------------------------


def test_npz_round_trip(tmp_path):
    params = _jax_params(4, **SMALL)
    path = tmp_path / "generator.npz"
    write_generator_npz(params, str(path))
    with np.load(path) as data:
        assert "lstm/1/bwd/w_ih" in data.files and "out/w" in data.files
    tree = read_generator_npz(str(path))
    assert len(tree["lstm"]) == SMALL["gen_num_layers"]
    for key, value in flatten_tree(params).items():
        np.testing.assert_array_equal(flatten_tree(tree)[key], value)
    from_npz, from_tree = generator_from_npz(str(path)), generator_from_jax(params)
    assert set(from_npz) == set(from_tree)
    assert all(torch.equal(from_npz[k], from_tree[k]) for k in from_tree)

    pt = tmp_path / "generator.pt"
    torch.save(from_tree, pt)
    from_pt = load_generator_weights(str(pt))
    assert all(torch.equal(from_pt[k], from_tree[k]) for k in from_tree)
    assert all(torch.equal(load_generator_weights(str(path))[k], from_tree[k]) for k in from_tree)


def test_unflatten_tree_rebuilds_lists():
    flat = {"a/0/x": np.zeros(1), "a/1/x": np.ones(1), "b": np.ones(2)}
    tree = unflatten_tree(flat)
    assert isinstance(tree["a"], list) and len(tree["a"]) == 2
    assert set(flatten_tree(tree)) == set(flat)


def test_load_generator_holds_weights_to_the_config(tmp_path):
    params = _jax_params(5, **SMALL)
    path = tmp_path / "g.npz"
    write_generator_npz(params, str(path))
    model = load_generator(str(path), ModelConfig(**SMALL, time_head="monotone"), device="cpu")
    assert model.config.time_head == "monotone" and not model.training
    np.testing.assert_array_equal(model.out.w.detach().numpy(), params["out"]["w"])
    with pytest.raises(RuntimeError):
        load_generator(str(path), ModelConfig(**dict(SMALL, gen_hidden_dim=8)), device="cpu")


def test_load_run_metadata(tmp_path):
    assert load_run_metadata(str(tmp_path)) == {}
    (tmp_path / "run_meta.json").write_text("{not json")
    assert load_run_metadata(str(tmp_path)) == {}
    (tmp_path / "run_meta.json").write_text(json.dumps({"time_head": "monotone"}))
    assert load_run_metadata(str(tmp_path)) == {"time_head": "monotone"}


# -- the CLI ----------------------------------------------------------------------


def _checkpoint(tmp_path):
    """A JAX-layout npz at the CLI's defaults but H=16 (from run_meta.json)."""
    write_generator_npz(_jax_params(6, gen_hidden_dim=16), str(tmp_path / "g.npz"))
    (tmp_path / "run_meta.json").write_text(json.dumps({"gen_hidden_dim": 16,
                                                        "time_head": "monotone"}))
    return tmp_path / "g.npz"


def test_cli_writes_expected_npz(tmp_path):
    weights = _checkpoint(tmp_path)
    out = tmp_path / "gestures.npz"
    stats = generate.main(["--words", "hello,world,the", "--samples-per-word", "2",
                           "--batch", "4", "--weights", str(weights),
                           "--checkpoint-dir", str(tmp_path), "--out", str(out),
                           "--device", "cpu", "--precision", "float32"])
    assert stats["n"] == 6
    with np.load(out) as data:
        assert set(data.files) == {"gestures", "words", "prototypes"}
        g = data["gestures"]
        assert g.shape == (6, 128, 3) and np.isfinite(g).all()
        assert list(data["words"]) == ["hello", "hello", "world", "world", "the", "the"]
        assert data["prototypes"].shape == (6, 128, 3)
        t = g[..., 2]   # monotone head from run_meta.json
        assert np.all(t[:, 0] == 0) and np.all(np.diff(t, axis=1) >= 0)


@pytest.mark.parametrize("generator_type", ["mlp", "transformer"])
def test_cli_rejects_unported_generators(tmp_path, capsys, generator_type):
    """The CLI serves the other two families, at the default widths, from a
    JAX npz: the output equals JAX's ``generator_apply`` on the same z
    (float32, 1e-5 abs), and weights of another family are refused."""
    fields = dict(generator_type=generator_type, time_head="monotone")
    params = _jax_params(7, **fields)
    write_generator_npz(params, str(tmp_path / "g.npz"))
    out = tmp_path / "gestures.npz"
    generate.main(["--words", "hello,world", "--n", "5", "--generator", generator_type,
                   "--weights", str(tmp_path / "g.npz"), "--checkpoint-dir", str(tmp_path),
                   "--out", str(out), "--device", "cpu", "--precision", "float32",
                   "--time-head", "monotone"])
    with np.load(out) as data:
        gestures, protos = data["gestures"], data["prototypes"]
    assert gestures.shape == (5, 128, 3) and np.isfinite(gestures).all()
    model = load_generator(str(tmp_path / "g.npz"), ModelConfig(**fields), device="cpu")
    z = np.random.default_rng(3).normal(size=(5, 32)).astype(np.float32)
    got = generate_gestures(model, protos, model.config, device="cpu", z=z)
    want = generator_apply(params, jnp.asarray(protos), jnp.asarray(z), JaxModelConfig(**fields))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    other = "mlp" if generator_type == "transformer" else "transformer"
    with pytest.raises(RuntimeError):
        load_generator(str(tmp_path / "g.npz"), ModelConfig(**dict(fields, generator_type=other)),
                       device="cpu")


def test_cli_requires_words_and_weights(tmp_path):
    with pytest.raises(SystemExit):
        generate.main(["--checkpoint-dir", str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit):
        generate.main(["--words", "hi", "--checkpoint-dir", str(tmp_path), "--device", "cpu"])


# -- the port stands alone ----------------------------------------------------------

FORBIDDEN = {"jax", "jaxlib", "optax", "orbax", "flax", "wordgesture_gan_tpu"}


def _port_sources():
    files = sorted((REPO / "wordgesture_gan_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py", *sorted((REPO / "tools").glob("*.py"))]


def test_port_imports_no_jax():
    offending = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offending += [f"{path.relative_to(REPO)}:{node.lineno} {name}"
                          for name in names if name.split(".")[0] in FORBIDDEN]
    covered = {str(path.relative_to(REPO)) for path in _port_sources()}
    assert len(covered) > 40
    assert {f"wordgesture_gan_tpu_torch/{name}" for name in (
        "eval_cli.py", "train_cli.py", "cli_common.py", "viz.py", "ops/dtw.py", "ops/stats.py",
        "ops/savgol.py", "ops/sqrtm.py", "ops/assignment.py", "metrics/fid.py",
        "metrics/suite.py", "eval/gan_eval.py", "data/parse.py", "data/preprocess.py",
        "data/native.py", "data/synthetic.py", "utils/logging.py", "models/generators.py",
        "data/variable_length.py", "ops/resample.py", "train/masked_step.py",
        "train/variable_loop.py", "metrics/large_scale.py", "models/contrastive.py",
        "data/contrastive.py", "train/contrastive_loop.py", "eval/contrastive_eval.py",
        "train_contrastive_cli.py", "eval_contrastive_cli.py", "parallel/distributed.py",
        "parallel/mesh.py", "utils/profiling.py", "ops/fastdtw_approx.py", "data/realism.py",
        "interop/torch_weights.py", "ops/attention.py")} | {
            "chip_smoke.py", "tools/port_quality_runs.py", "tools/diag_first_epochs.py"} <= covered
    assert not offending, offending


def test_port_runs_with_jax_unimportable():
    code = ("import sys\n"
            "for m in ('jax', 'wordgesture_gan_tpu'): sys.modules[m] = None\n"
            "import wordgesture_gan_tpu_torch.generate, wordgesture_gan_tpu_torch.train.gan_loop\n"
            "import wordgesture_gan_tpu_torch.eval_cli, wordgesture_gan_tpu_torch.train_cli\n"
            "import wordgesture_gan_tpu_torch.viz, wordgesture_gan_tpu_torch.data.native\n"
            "import wordgesture_gan_tpu_torch.train.variable_loop\n"
            "import chip_smoke, tools.port_quality_runs\n"
            "print('ok')\n")
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                            text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "ok"


# -- one torch thread per test worker, set in one place ------------------------------

def test_port_tests_take_their_thread_count_from_one_module():
    """Every port test module and the two-rank worker import
    ``tests/torch_threads.py`` at module level, and none sets torch's thread
    count itself: a new test file cannot bring back a pool of threads per
    xdist worker. This test runs on the one thread that module sets."""
    files = sorted((REPO / "tests").glob("test_torch_*.py")) + [
        REPO / "tests" / "_torch_parallel_worker.py"]
    missing, setting = [], []
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        if not any(isinstance(node, ast.Import)
                   and any(alias.name == "torch_threads" for alias in node.names)
                   for node in tree.body):
            missing.append(path.name)
        setting += [f"{path.name}:{node.lineno}" for node in ast.walk(tree)
                    if isinstance(node, ast.Attribute) and node.attr == "set_num_threads"]
    assert len(files) > 25
    assert not missing, missing
    assert not setting, setting
    assert torch.get_num_threads() == 1
