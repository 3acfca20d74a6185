"""The PyTorch port's evaluation slice as a whole, on the CPU: the GAN +
minimum-jerk evaluation against the JAX package's on the same arrays,
the paper tables, and the two CLIs (``train_cli``, ``eval_cli``) end to end
on a tiny synthetic corpus with ``--device cpu``.

Tolerances: the minimum-jerk samples are bit-equal (numpy, same generator);
metrics that no autoencoder enters agree with the JAX package's to 1e-4
(float32 sums in another order); the FID scalars depend on autoencoders that
each package trains from its own random stream, so they are only held to be
finite and non-negative here (tests/test_torch_metrics.py holds them with the
weights carried across). Everything is written under ``tmp_path``.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test worker

from wordgesture_gan_tpu.configs import EvaluationConfig as JaxEvaluationConfig
from wordgesture_gan_tpu.configs import ModelConfig as JaxModelConfig
from wordgesture_gan_tpu.data.pipeline import GestureArrays as JaxGestureArrays
from wordgesture_gan_tpu.eval import gan_eval as jax_gan_eval
from wordgesture_gan_tpu.keyboard import QWERTYKeyboard as JaxQWERTYKeyboard
from wordgesture_gan_tpu_torch import eval_cli, generate, train_cli
from wordgesture_gan_tpu_torch.configs import EvaluationConfig, ModelConfig
from wordgesture_gan_tpu_torch.data.pipeline import GestureArrays
from wordgesture_gan_tpu_torch.eval import gan_eval
from wordgesture_gan_tpu_torch.keyboard import QWERTYKeyboard
from wordgesture_gan_tpu_torch.train.checkpoint import (find_checkpoint, generator_from_state,
                                                        load_generator, load_run_metadata)
from wordgesture_gan_tpu_torch.train.gan_loop import generate_gestures

NO_AUTOENCODER = ("l2_wasserstein", "dtw_wasserstein", "jerk_real", "jerk_fake", "velocity_corr",
                  "acceleration_corr", "speed_profile_corr", "time_delta_corr", "precision",
                  "recall")
WORDS = ["hello", "world", "gesture", "keyboard", "swipe", "typing", "people", "water"]
SEQ = 32


def dataset(seed: int, per_word: int, cls=GestureArrays):
    """Prototypes of WORDS displaced by a seeded smooth wobble, with a warped clock."""
    rng = np.random.default_rng(seed)
    kb = QWERTYKeyboard()
    words = [w for w in WORDS for _ in range(per_word)]
    protos = np.stack([kb.get_word_prototype(w, SEQ) for w in words]).astype(np.float32)
    u = np.linspace(0, 1, SEQ)[None, :, None]
    wobble = 0.05 * np.sin(2 * np.pi * rng.uniform(0.5, 2, (len(words), 1, 2)) * u
                           + rng.uniform(0, 6, (len(words), 1, 2)))
    g = protos.copy()
    g[..., :2] = np.clip(protos[..., :2] + wobble, -1, 1)
    clock = np.cumsum(rng.uniform(0.5, 1.5, (len(words), SEQ)), axis=1)
    g[..., 2] = (clock - clock[:, :1]) / (clock[:, -1:] - clock[:, :1])
    return cls(g.astype(np.float32), protos, words)


# -- evaluate_gan_and_minjerk ---------------------------------------------------------------


def test_minjerk_fit_and_samples_bit_equal():
    train, jtrain = dataset(0, 4), dataset(0, 4, JaxGestureArrays)
    model = gan_eval.fit_minjerk_from_dataset(train, QWERTYKeyboard(), verbose=False)
    ref = jax_gan_eval.fit_minjerk_from_dataset(jtrain, JaxQWERTYKeyboard(), verbose=False)
    assert dataclasses.asdict(model.distributions) == dataclasses.asdict(ref.distributions)
    np.testing.assert_array_equal(gan_eval.generate_minjerk_samples(model, WORDS * 2, SEQ),
                                  jax_gan_eval.generate_minjerk_samples(ref, WORDS * 2, SEQ))


@pytest.fixture(scope="module")
def both_runs():
    train, test = dataset(1, 5), dataset(2, 3)
    fake = dataset(3, 3).gestures
    ecfg = dict(fid_autoencoder_epochs=1)
    stages = {}
    got = gan_eval.evaluate_gan_and_minjerk(
        test.gestures, test.words, train, QWERTYKeyboard(), gan_fake=fake,
        model_config=ModelConfig(seq_length=SEQ), eval_config=EvaluationConfig(**ecfg),
        verbose=False, device="cpu", stage_seconds=stages)
    want = jax_gan_eval.evaluate_gan_and_minjerk(
        test.gestures, test.words, dataset(1, 5, JaxGestureArrays), JaxQWERTYKeyboard(),
        gan_fake=fake, model_config=JaxModelConfig(seq_length=SEQ),
        eval_config=JaxEvaluationConfig(**ecfg), verbose=False)
    return got, want, stages


@pytest.mark.parametrize("which", [0, 1], ids=["gan", "minjerk"])
@pytest.mark.parametrize("key", NO_AUTOENCODER)
def test_evaluate_gan_and_minjerk_matches_jax(both_runs, which, key):
    got, want, _ = both_runs
    assert got[which][key] == pytest.approx(want[which][key], rel=1e-4, abs=1e-6)


def test_evaluate_gan_and_minjerk_shares_the_real_side(both_runs):
    (gan, minjerk), _, stages = both_runs
    for results in (gan, minjerk):
        assert "_cached_real" not in results and "_stage_seconds" not in results
        assert all(np.isfinite(results[k]) and results[k] >= 0
                   for k in ("fid", "fid_paper", "fid_positional"))
    assert gan["ae_reconstruction_loss"] == minjerk["ae_reconstruction_loss"]
    assert gan["jerk_real"] == minjerk["jerk_real"]
    assert "fid_autoencoder_training" in stages["gan"]
    assert "fid_autoencoder_training" not in stages["minjerk"]
    assert stages["minjerk"]["fit_and_sample"] > 0
    only_mj = gan_eval.evaluate_gan_and_minjerk(
        dataset(2, 3).gestures, dataset(2, 3).words, dataset(1, 5), QWERTYKeyboard(),
        model_config=ModelConfig(seq_length=SEQ),
        eval_config=EvaluationConfig(fid_autoencoder_epochs=1), skip_dtw=True, verbose=False,
        device="cpu")
    assert only_mj[0] is None and only_mj[1]["dtw_wasserstein"] == -1.0


@pytest.mark.parametrize("table", ["comparison", "single", "single_one_fid", "skipped_dtw"])
def test_tables_print_what_the_jax_package_prints(both_runs, table, capsys):
    (gan, minjerk), _, _ = both_runs
    gan, minjerk = dict(gan), dict(minjerk)
    if table == "skipped_dtw":
        gan["dtw_wasserstein"] = minjerk["dtw_wasserstein"] = -1.0
    if table == "single_one_fid":
        for key in ("fid_paper", "fid_positional"):
            gan.pop(key)
    outputs = []
    for module in (gan_eval, jax_gan_eval):
        if table in ("comparison", "skipped_dtw"):
            module.print_comparison_table(gan, minjerk, 3)
        if table != "comparison":
            module.print_results_table(gan, "GAN", module.PAPER_GAN, 3)
        outputs.append(capsys.readouterr().out)
    assert outputs[0] == outputs[1] and "L2 Wasserstein" in outputs[0]
    assert gan_eval.PAPER_GAN == jax_gan_eval.PAPER_GAN
    assert gan_eval.PAPER_MINJERK == jax_gan_eval.PAPER_MINJERK


def test_attach_eval_to_wandb_logs_scalars_and_figures(both_runs):
    class Wandb:
        summary, logged = {}, []

        @staticmethod
        def log(entry):
            Wandb.logged.append(entry)

        @staticmethod
        def Image(fig):
            return "image"

    (gan, minjerk), _, _ = both_runs
    test = dataset(2, 3)
    gan_eval.attach_eval_to_wandb(Wandb, gan, minjerk, real_g=test.gestures,
                                  gan_fake=test.gestures, words=test.words)
    assert Wandb.summary["eval/l2_wasserstein"] == gan["l2_wasserstein"]
    assert Wandb.summary["eval_minjerk/recall"] == minjerk["recall"]
    assert [list(e) for e in Wandb.logged] == [["gestures/comparison"], ["gestures/overlay"]]


# -- the CLIs, end to end ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch through ``train_cli`` on a 4-user synthetic corpus."""
    base = tmp_path_factory.mktemp("run")
    data = ["--synthetic", "--synthetic-users", "4", "--data", str(base / "swipelogs.zip"),
            "--checkpoint-dir", str(base / "ckpt"), "--device", "cpu"]
    result = train_cli.main(["--epochs", "1", "--batch-size", "32", "--gen-hidden", "8",
                             "--precision", "float32", "--lambda-speed", "2.0", *data])
    return base, data, result


def test_train_cli_writes_metadata_and_checkpoint(trained):
    base, data, result = trained
    assert len(result.history) == 1 and np.isfinite(result.history[0]["d1_loss"])
    assert load_run_metadata(str(base / "ckpt")) == {
        "generator_type": "bilstm", "time_head": "monotone", "gen_hidden_dim": 8}
    assert find_checkpoint(str(base / "ckpt")).name == "latest.pt"
    assert (base / "synthetic_swipelogs_4.zip").exists()
    assert list(base.glob(".cache_synthetic_swipelogs_4_*.pkl"))       # next to the zip
    # A second call finds the run trained and does nothing.
    again = train_cli.main(["--epochs", "1", "--gen-hidden", "8", "--precision", "float32", *data])
    assert again.history == []


def test_generator_from_state_samples_like_the_checkpoint(trained):
    base, _, result = trained
    mcfg = ModelConfig(time_head="monotone", gen_hidden_dim=8)
    protos = np.repeat(dataset(5, 1).prototypes, 4, axis=1)             # (8, 128, 3)
    live = generator_from_state(result.state, mcfg, "cpu")
    saved = load_generator(str(find_checkpoint(str(base / "ckpt"))), mcfg, device="cpu")
    np.testing.assert_array_equal(generate_gestures(live, protos, mcfg, seed=1, device="cpu"),
                                  generate_gestures(saved, protos, mcfg, seed=1, device="cpu"))


def test_eval_cli_prints_the_side_by_side_table(trained, capsys):
    _, data, _ = trained
    out = eval_cli.main(["--model", "both", "--n-samples", "12", "--fid-epochs", "1", *data])
    printed = capsys.readouterr().out
    assert "Side-by-Side Comparison: GAN vs Minimum Jerk" in printed
    assert "Loaded checkpoint from epoch 1" in printed and "SKIP" not in printed
    assert out["n"] == 12
    for results in (out["gan"], out["minjerk"]):
        assert all(np.isfinite(results[k]) for k in NO_AUTOENCODER + ("fid", "ae_test_loss"))
        assert 0.0 <= results["precision"] <= 1.0 and 0.0 <= results["recall"] <= 1.0
        assert results["fid"] >= 0.0 and results["dtw_wasserstein"] > 0.0
    assert {"load", "generate", "gan", "minjerk"} <= set(out["stage_seconds"])


@pytest.mark.parametrize("model,title", [("gan", "GAN Results"), ("min-jerk", "Minimum Jerk Results")])
def test_eval_cli_single_model_tables_and_fast(trained, capsys, model, title, tmp_path):
    _, data, _ = trained
    out = eval_cli.main(["--model", model, "--n-samples", "8", "--fid-epochs", "1", "--fast",
                         "--fid-features", "paper", "--save-figures", str(tmp_path), *data])
    printed = capsys.readouterr().out
    assert title in printed and "SKIPPED" in printed
    results = out["gan"] if model == "gan" else out["minjerk"]
    assert results["dtw_wasserstein"] == -1.0 and results["fid_feature_mode"] == "paper"
    assert (out["minjerk"] is None) == (model == "gan")
    assert (tmp_path / "comparison.png").exists() == (model == "gan")


def test_eval_cli_without_a_checkpoint(trained, tmp_path, capsys):
    _, data, _ = trained
    data = [str(tmp_path / "none") if a.endswith("ckpt") else a for a in data]
    with pytest.raises(SystemExit) as exit_info:
        eval_cli.main(["--model", "gan", "--n-samples", "8", *data])
    assert exit_info.value.code == 1
    out = eval_cli.main(["--model", "both", "--n-samples", "8", "--fid-epochs", "1", "--fast",
                         *data])
    assert out["gan"] is None and out["minjerk"] is not None
    assert "Skipping GAN evaluation" in capsys.readouterr().out


def test_generate_serves_what_train_cli_wrote(trained, tmp_path):
    """``generate --checkpoint-dir D`` without ``--weights`` serves the newest
    checkpoint ``train_cli`` wrote (``latest.pt``): the same gestures as
    sampling that checkpoint directly (bit-equal, same seed and chunks)."""
    base, _, _ = trained
    ckpt, out = base / "ckpt", tmp_path / "gestures.npz"
    assert not (ckpt / "generator.pt").exists()
    generate.main(["--words", "hello,world,people", "--n", "6", "--checkpoint-dir", str(ckpt),
                   "--out", str(out), "--device", "cpu", "--precision", "float32"])
    mcfg = ModelConfig(time_head="monotone", gen_hidden_dim=8)
    saved = load_generator(str(find_checkpoint(str(ckpt))), mcfg, device="cpu")
    with np.load(out) as served:
        np.testing.assert_array_equal(served["gestures"],
                                      generate_gestures(saved, served["prototypes"], mcfg,
                                                        device="cpu"))


LARGE_SCALE_KEYS = ["sliced_w2", "energy_distance", "sinkhorn_matched_cost",
                    "sinkhorn_matched_cost_std", "sinkhorn_matched_cost_extrapolated",
                    "sinkhorn_matched_cost_extrapolated_stderr", "n_samples", "precision",
                    "recall", "fid"]


@pytest.mark.parametrize("cli,flags,message", [
    pytest.param(eval_cli, ["--large-scale", "512"], "Large-scale distribution metrics (N=512)",
                 id="wordgesture_gan_tpu_torch.eval_cli-flags0-scale-metrics slice"),
])
def test_clis_refuse_what_is_not_ported(cli, flags, message, trained, capsys):
    """Every flag of the JAX CLI runs: ``--large-scale N`` scores N gestures
    sampled from the trained checkpoint with the scale metrics and returns
    ``evaluate_large_scale``'s keys and the stage seconds."""
    _, data, _ = trained
    out = cli.main([*flags, "--fid-epochs", "1", *data])
    assert message in capsys.readouterr().out
    assert out["n"] == 512 and list(out["large_scale"]) == LARGE_SCALE_KEYS
    results = out["large_scale"]
    assert all(np.isfinite(v) for v in results.values()) and results["n_samples"] == 512
    assert 0.0 <= results["precision"] <= 1.0 and 0.0 <= results["recall"] <= 1.0
    assert results["fid"] >= 0.0 and results["sinkhorn_matched_cost"] > 0.0
    assert {"load", "generate", "fid_autoencoder", "sinkhorn", "sliced_w2_energy", "knn",
            "fid"} == set(out["stage_seconds"])


@pytest.fixture(scope="module")
def variable_trained(trained):
    """One epoch of ``train_cli --variable-length`` on the same corpus: a
    transformer checkpoint."""
    base, data, _ = trained
    data = [str(base / "vl") if a.endswith("ckpt") else a for a in data]
    train_cli.main(["--variable-length", "--epochs", "1", "--batch-size", "32",
                    "--precision", "float32", *data])
    return data


@pytest.mark.parametrize("cli,flags", [
    (eval_cli, ["--variable-length"]),
    (eval_cli, ["--generator", "transformer"]),
    (train_cli, ["--variable-length"]),
    (train_cli, ["--generator", "mlp"]),
])
def test_clis_run_what_was_refused(cli, flags, variable_trained, tmp_path):
    """The flags the port once refused run on the CPU: training one epoch,
    or scoring the variable-length (transformer) checkpoint."""
    if cli is train_cli:
        data = [str(tmp_path) if a.endswith("vl") else a for a in variable_trained]
        result = train_cli.main([*flags, "--epochs", "1", "--batch-size", "32",
                                 "--precision", "float32", *data])
        assert len(result.history) == 1 and all(np.isfinite(v) for v in result.history[0].values())
        family = "transformer" if "--variable-length" in flags else flags[-1]
        assert load_run_metadata(str(tmp_path))["generator_type"] == family
        return
    out = eval_cli.main([*flags, "--model", "gan", "--n-samples", "8", "--fid-epochs", "1",
                         "--fast", *variable_trained])
    assert out["n"] == 8
    assert all(np.isfinite(out["gan"][k]) for k in NO_AUTOENCODER)


@pytest.mark.parametrize("cli", [eval_cli, train_cli])
def test_clis_default_to_the_card_and_refuse_without_one(cli, capsys):
    assert cli.build_parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit):
        cli.main([])
    assert "no CUDA device" in capsys.readouterr().err


def test_cli_flags_are_the_jax_clis_flags():
    """Same flags and defaults as ``eval_gan.py`` / ``train_gan.py``, read
    from their sources (importing them would start JAX's runtime set-up)."""
    import ast
    from pathlib import Path

    def flags_of(source: str) -> dict:
        found = {}
        for node in ast.walk(ast.parse(source)):
            if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
                    and node.args and isinstance(node.args[0], ast.Constant)):
                default = next((ast.literal_eval(k.value) for k in node.keywords
                                if k.arg == "default"), None)
                found[node.args[0].value] = default
        return found

    root = Path(eval_cli.__file__).resolve().parent.parent
    want = flags_of((root / "eval_gan.py").read_text())
    got = {a.option_strings[0]: a.default for a in eval_cli.build_parser()._actions
           if a.option_strings and a.option_strings[0] != "-h"}
    assert set(want) <= set(got)
    assert all(got[k] == v for k, v in want.items() if v is not None)
    assert set(got) - set(want) - {"--data", "--synthetic", "--synthetic-users", "--max-files",
                                   "--time64", "--seed"} == {"--device", "--fid-epochs"}
    want = flags_of((root / "train_gan.py").read_text())
    got = {a.option_strings[0]: a.default for a in train_cli.build_parser()._actions
           if a.option_strings and a.option_strings[0] != "-h"}
    assert set(want) <= set(got)
    assert all(got[k] == v for k, v in want.items() if k in got and v is not None)
