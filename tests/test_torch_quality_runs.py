"""The port's quality runs (``tools/port_quality_runs.py``) on the CPU.

The runner's parser against the JAX package's committed logs (every number
their text shows) and against the tables the port's ``eval_cli`` prints;
``train_cli.main(..., scan_epoch=True)`` against the same call without it
(one epoch on a 4-user synthetic corpus: history and checkpoint bit-equal,
the same float32 operations in the same order); and the runner end to end
at a tiny size (one epoch, ``--fast`` evaluation, FID autoencoders one
epoch), whose report must carry both columns and the band flags. On the card
the full-size runs and ``chip_smoke.py`` phase 12 run it. Everything is
written under ``tmp_path``.

The quality runs' five GAN recipes (the flagship, the control, the
flagship's two auxiliary terms one at a time, the variable-length run): one
step of each at full width (the flagship BiLSTM at H=48, L=128, the default
transformer) on gesture-like data with the draws the JAX step makes from
its key, against the JAX step, in float32 and in bfloat16. float32: losses
1e-4 relative to max(1, |loss|); gradients (Adam's moments after a step at
lr=0) of each leaf's largest: 1e-3 for the variable-length recipe (measured
2e-5), 3e-3 for the recipes with lambda_speed (measured 7.3e-4 to 1.3e-3).
bfloat16: see the test. The monotone head's clock is a cumulative sum
whose increments the speed-profile and Pearson terms divide by; summed in
another order they differ by up to 2.5e-5 relative between the packages.
At full width with the flagship's terms that moves G's and E's gradients by
1.3e-3 to 2.0e-3 against JAX, and by 1.1e-3 between two runs of the port
itself on 1 and on 8 CPU threads (another summation order); with no
auxiliary term the gap to JAX is 1e-6. On identical inputs the two
packages' auxiliary losses agree in their gradients to 2e-7 of the largest.

Over several steps (``tests/jax_trajectory.py`` at H=8, with the flagship's
terms and with none, and the variable-length recipe on a small transformer;
float32 and bfloat16) the port trains from one JAX initial state as close to
JAX as the control, JAX from a nudged state; the full-width runs of that
script are in ``runs_torch/diagnostics/``.
"""

import importlib.util
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wordgesture_gan_tpu.configs import ModelConfig as JaxModelConfig
from wordgesture_gan_tpu.configs import TrainingConfig as JaxTrainingConfig
from wordgesture_gan_tpu.eval import gan_eval as jax_gan_eval
from wordgesture_gan_tpu.train import gan_train_step as jax_gan_train_step
from wordgesture_gan_tpu.train import init_gan_state as jax_init_gan_state
from wordgesture_gan_tpu.train.masked_step import gan_train_step_masked as jax_masked_step
from wordgesture_gan_tpu_torch import train_cli
from wordgesture_gan_tpu_torch.configs import ModelConfig, TrainingConfig
from wordgesture_gan_tpu_torch.eval import gan_eval
from wordgesture_gan_tpu_torch.interop.from_jax import adam_moments, train_state_from_jax
from wordgesture_gan_tpu_torch.keyboard import QWERTYKeyboard
from wordgesture_gan_tpu_torch.train.gan_step import gan_train_step
from wordgesture_gan_tpu_torch.train.masked_step import gan_train_step_masked
from wordgesture_gan_tpu_torch.train.state import MODELS, init_gan_state
from tests.jax_trajectory import jax_step_draws, nudge, trajectory

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("port_quality_runs",
                                               REPO / "tools" / "port_quality_runs.py")
runner = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(runner)

CORPUS = {"words": [7395, 1849], "samples": [20331, 5115]}
# What the committed logs' text shows (runs/r5_eval_base.log:33-44 and the rest).
LOGS = {
    "runs/r5_eval_flag.log": {
        "tables": {"gan": {
            "l2_wasserstein": 2.019, "dtw_wasserstein": 1.250, "jerk_fake": 0.00045,
            "jerk_real": 0.00052, "velocity_corr": 0.758, "acceleration_corr": 0.152,
            "speed_profile_corr": 0.173, "time_delta_corr": 0.149,
            "ae_reconstruction_loss": 0.0679, "ae_test_loss": 0.0719, "fid_paper": 0.0173,
            "fid_positional": 0.0229, "precision": 0.898, "recall": 0.905}},
        "counts": CORPUS},
    "runs/r5_eval_base.log": {
        "tables": {"gan": {
            "l2_wasserstein": 1.644, "dtw_wasserstein": 0.885, "jerk_fake": 0.00048,
            "velocity_corr": 0.818, "acceleration_corr": 0.190, "speed_profile_corr": 0.228,
            "time_delta_corr": 0.081, "fid_paper": 0.0132, "fid_positional": 0.0194,
            "precision": 0.981, "recall": 0.653},
            "minjerk": {
            "l2_wasserstein": 2.748, "dtw_wasserstein": 1.678, "jerk_fake": 0.00080,
            "velocity_corr": 0.723, "acceleration_corr": 0.124, "speed_profile_corr": 0.104,
            "time_delta_corr": 0.061, "fid_paper": 0.2234, "fid_positional": 0.1525,
            "precision": 0.666, "recall": 0.971}},
        "counts": CORPUS},
    "runs/r4_eval_sp2.log": {
        "tables": {"gan": {
            "l2_wasserstein": 1.611, "dtw_wasserstein": 0.858, "jerk_fake": 0.00048,
            "jerk_real": 0.00052, "velocity_corr": 0.826, "acceleration_corr": 0.199,
            "speed_profile_corr": 0.235, "time_delta_corr": 0.054,
            "ae_reconstruction_loss": 0.0675, "ae_test_loss": 0.0707, "fid_positional": 0.0349,
            "precision": 0.985, "recall": 0.646}},
        "counts": CORPUS},
    "runs/r5_eval_varlen2.log": {
        "tables": {"gan": {
            "l2_wasserstein": 2.590, "dtw_wasserstein": 1.204, "jerk_fake": 0.00072,
            "jerk_real": 0.00051, "velocity_corr": 0.190, "acceleration_corr": 0.003,
            "speed_profile_corr": 0.111, "time_delta_corr": 0.144,
            "ae_reconstruction_loss": 0.0860, "ae_test_loss": 0.0897, "fid_paper": 0.0669,
            "fid_positional": 0.0520, "precision": 0.782, "recall": 0.567}},
        "counts": CORPUS},
    "runs/r4_eval_contrastive.log": {
        "retrieval": {"recall@1": 0.9697, "recall@5": 0.9918, "recall@10": 0.9970,
                      "recall@20": 0.9994, "mAP": 0.9655},
        "centroids": {"real": 0.9922, "5": 0.9399, "10": 0.9529, "20": 0.9548, "50": 0.9550},
        "counts": {"contrastive_words": [5388, 1347],
                   "contrastive_arrays": [[18313, 5388], [4624, 1347]]}},
    "runs/r5_train_flag.log": {"margin": 0.0660, "counts": CORPUS},
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny models here gain nothing from torch's thread pool, and beside
    other test workers its threads only contend for the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("path", list(LOGS))
def test_parser_reads_the_jax_logs(path):
    got = runner.parse_log((REPO / path).read_text())
    for field, want in LOGS[path].items():
        assert got[field] == want, field


RESULTS = {"l2_wasserstein": 1.6439, "dtw_wasserstein": 0.88512, "jerk_fake": 0.000481,
           "jerk_real": 0.000523, "velocity_corr": 0.8183, "acceleration_corr": 0.1904,
           "speed_profile_corr": 0.2277, "time_delta_corr": 0.0811,
           "ae_reconstruction_loss": 0.06791, "ae_test_loss": 0.07188, "fid_paper": 0.01321,
           "fid_positional": 0.01942, "precision": 0.9812, "recall": 0.6531}


@pytest.mark.parametrize("table", ["comparison", "single", "single_one_fid", "skipped_dtw"])
def test_parser_reads_what_eval_cli_prints(table, capsys):
    """The port's tables (the JAX package's, character for character) parse
    into the keys the JAX logs parse into, each value as printed."""
    gan = dict(RESULTS)
    if table == "single_one_fid":
        gan.pop("fid_paper")
        gan["fid"] = gan.pop("fid_positional")
        gan["fid_feature_mode"] = "positional"
    if table == "skipped_dtw":
        gan["dtw_wasserstein"] = -1.0
    minjerk = {k: v * 1.5 if isinstance(v, float) else v for k, v in gan.items()}

    def print_tables(module):
        if table in ("comparison", "skipped_dtw"):
            module.print_comparison_table(gan, minjerk, 3)
        else:
            module.print_results_table(gan, "GAN (variable-length)", module.PAPER_GAN, 3)
        return capsys.readouterr().out

    port = print_tables(gan_eval)
    assert runner.parse_log(port) == runner.parse_log(print_tables(jax_gan_eval))
    tables = runner.parse_log(port)["tables"]
    assert set(tables) == ({"gan", "minjerk"} if table in ("comparison", "skipped_dtw")
                           else {"gan"})
    for key, value in tables["gan"].items():
        if key == "dtw_wasserstein" and table == "skipped_dtw":
            assert value is None
        else:
            assert value == pytest.approx(gan.get(key, gan.get("fid")), abs=6e-4, rel=1e-3)
    if table == "single":
        assert set(tables["gan"]) == set(RESULTS)


def _tiny_corpus(tmp: Path, ckpt: str) -> list:
    return ["--synthetic", "--synthetic-users", "4", "--data", str(tmp / "swipelogs.zip"),
            "--checkpoint-dir", str(tmp / ckpt), "--device", "cpu"]


def test_train_cli_scan_epoch_is_bit_equal_on_cpu(tmp_path):
    recipe = ["--epochs", "1", "--batch-size", "32", "--gen-hidden", "8", "--precision",
              "float32", "--lambda-speed", "2", "--lambda-div", "0.3", "--lambda-dtc", "4"]
    eager = train_cli.main([*recipe, *_tiny_corpus(tmp_path, "eager")])
    graphed = train_cli.main([*recipe, *_tiny_corpus(tmp_path, "graphed")], scan_epoch=True)
    assert eager.gestures_per_epoch >= 64 and graphed.history == eager.history
    assert ((tmp_path / "graphed" / "history.jsonl").read_text()
            == (tmp_path / "eager" / "history.jsonl").read_text())
    saved = [torch.load(tmp_path / run / "latest.pt", weights_only=True)
             for run in ("eager", "graphed")]
    assert saved[0].keys() == saved[1].keys()

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for item in tree for x in leaves(item)]
        return [tree]

    for a, b in zip(leaves(saved[0]), leaves(saved[1])):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b


def test_train_cli_scan_epoch_refuses_local_ranks(tmp_path, monkeypatch):
    """The ranks ``--data-axis-size`` would start are copies of the command
    line and cannot carry ``scan_epoch``: the call raises before any starts."""
    monkeypatch.delenv("WGG_DISTRIBUTED", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv = ["--epochs", "1", "--data-axis-size", "2", *_tiny_corpus(tmp_path, "ranks")]
    with pytest.raises(ValueError, match="scan_epoch"):
        train_cli.main(argv, scan_epoch=True)
    assert not (tmp_path / "ranks").exists()


def test_runner_end_to_end_on_cpu(tmp_path, capsys):
    argv = ["--device", "cpu", "--out", str(tmp_path / "out"), "--data",
            str(tmp_path / "swipelogs.zip"), "--epochs", "1", "--synthetic-users", "4",
            "--runs", "flag", "--train-args", "--gen-hidden 8 --batch-size 32 --precision float32",
            "--eval-args", "--fast --fid-epochs 1 --n-samples 24"]
    results = runner.main(argv)
    run_dir = tmp_path / "out" / "flag"
    for name in ("train.log", "eval.log", "history.jsonl", "run_meta.json", "latest.pt"):
        assert (run_dir / name).exists(), name
    saved = json.loads((tmp_path / "out" / "results.json").read_text())
    assert saved == json.loads(json.dumps(results))
    flag = saved["runs"]["flag"]
    assert flag["epochs"] == 1 and flag["source"] == "runs/r5_sweep4.sh:14-21"
    assert set(flag["counts"]) == {"words", "samples"}
    for table in ("metrics", "minjerk"):
        rows = flag[table]
        assert rows["l2_wasserstein"]["jax"] == (2.019 if table == "metrics" else 2.748)
        assert isinstance(rows["l2_wasserstein"]["port"], float)
        assert isinstance(rows["l2_wasserstein"]["outside"], bool)
        assert rows["dtw_wasserstein"]["port"] is None and rows["dtw_wasserstein"]["outside"] is None
    d = saved["band"]["d"]
    assert d["l2_wasserstein"] == pytest.approx(abs(1.611 - 1.644))
    assert d["fid_positional"] == runner.BAND_FLOOR and d["precision"] == runner.BAND_FLOOR
    lo, hi = flag["metrics"]["l2_wasserstein"]["lo"], flag["metrics"]["l2_wasserstein"]["hi"]
    assert (lo, hi) == pytest.approx((2.019 - 3 * d["l2_wasserstein"],
                                      2.019 + 3 * d["l2_wasserstein"]))
    for key in runner.NO_BAND:      # FID: shown, with no band and no flag
        assert flag["metrics"][key]["lo"] is None and flag["metrics"][key]["outside"] is None
    assert flag["wins_vs_own_minjerk"]["jax"] == 8
    assert saved["checks"]["counts_flag"]["ok"] is False          # 4 users, not 1338
    assert set(saved["checks"]["minjerk_flag"]["rows"]) == set(runner.MINJERK_EXACT)
    assert saved["checks"]["margin"]["jax"] == 0.066
    losses = flag["history"]["losses"]["d1_loss"]
    assert losses["port"][0] is not None and losses["port"][1:] == [None, None]
    assert len(losses["jax"]) == 3 and len(losses["pair_spread"]) == 3
    train_calls = flag["runner"]["train_calls"]
    assert len(train_calls) == 1 and train_calls[0]["epochs"] == [0, 1]
    assert "## flag" in (tmp_path / "out" / "results.md").read_text()
    assert flag["stream"] == runner.STREAM and flag["seed"] == 42
    first = flag["first_epochs"]["cycle2_rec"]
    assert len(first["port"]) == runner.FIRST_EPOCHS and first["port"][1:] == [None] * 9
    assert first["jax"][0] == pytest.approx(0.20973017811775208)
    assert first["lo"][0] <= first["jax"][0] <= first["hi"][0]
    assert "Epochs 1–10" in (tmp_path / "out" / "results.md").read_text()
    # Another seed draws other samples and is no JAX run: its metrics and its
    # min-jerk column are shown unflagged, beside the port's own seed range.
    shutil.copytree(run_dir, tmp_path / "out" / "flag_seed43")
    other = runner.report(tmp_path / "out")["runs"]["flag_seed43"]
    assert all(row["outside"] is None for row in other["minjerk"].values())
    assert other["metrics"]["l2_wasserstein"]["outside"] is None and other["seed"] == 43
    value = other["metrics"]["l2_wasserstein"]["port"]
    assert other["seed_range"]["seeds"] == [42, 43]
    assert other["seed_range"]["metrics"]["l2_wasserstein"] == [value, value]
    shutil.rmtree(tmp_path / "out" / "flag_seed43")
    # A trained and scored run is neither trained nor scored again.
    capsys.readouterr()
    again = runner.main(argv)["runs"]["flag"]["runner"]
    assert len(again["train_calls"]) == 1 and len(again["eval_calls"]) == 1


# -- the quality runs' recipes, one step at full width ----------------------------------------

STEP_B = 4
WORDS = ["the", "quick", "brown", "keyboard"]
RECIPES = {
    # runs/r5_sweep4.sh: the flagship, its margin as runs/r5_train_flag.log measured it
    "flag": (dict(), dict(lambda_speed=2.0, lambda_div=0.3, lambda_dtc=4.0, div_margin=0.066),
             3e-3),
    # runs/r5_sweep5.sh: the variable-length run
    "varlen2": (dict(generator_type="transformer"), dict(lambda_speed=2.0), 1e-3),
    # runs/r5_sweep.sh, r5_sweep3.sh, r5_sweep2.sh: the control and the
    # flagship's auxiliary terms one at a time, each beside lambda_speed=2
    "base": (dict(), dict(lambda_speed=2.0), 3e-3),
    "div03": (dict(), dict(lambda_speed=2.0, lambda_div=0.3, div_margin=0.066), 3e-3),
    "dtc4": (dict(), dict(lambda_speed=2.0, lambda_dtc=4.0), 3e-3),
}
# bfloat16 (every quality run but flag_fp32 trains in it): losses within
# BF16_LOSS_TOL of max(1, |loss|); each model's gradient (Adam's first
# moments, the relative L2 distance of the whole tree) within
# BF16_CONTROL_FACTOR times the distance of the control, the JAX step from
# the initial state nudged by one float32 rounding step, plus BF16_FLOOR.
BF16_LOSS_TOL = 2e-2
BF16_CONTROL_FACTOR, BF16_FLOOR = 2.0, 0.15
STEP_CASES = [pytest.param(run, "float32", id=run) for run in RECIPES] + [
    pytest.param(run, "bfloat16", id=f"{run}-bfloat16") for run in RECIPES]


def _gesture_batch(seq: int, masked: bool) -> dict:
    """Keyboard prototypes of WORDS, the gestures a smooth wobble off them
    with a warped monotone clock; masked: true lengths 128, 97, 64, 40, the
    padding repeating the last valid point."""
    rng = np.random.default_rng(11)
    kb = QWERTYKeyboard()
    protos = np.stack([kb.get_word_prototype(w, seq) for w in WORDS]).astype(np.float32)
    u = np.linspace(0, 1, seq)[None, :, None]
    g = protos.copy()
    g[..., :2] = np.clip(protos[..., :2] + 0.05 * np.sin(
        2 * np.pi * rng.uniform(0.5, 2, (STEP_B, 1, 2)) * u + rng.uniform(0, 6, (STEP_B, 1, 2))),
        -1, 1)
    clock = np.cumsum(rng.uniform(0.5, 1.5, (STEP_B, seq)), axis=1)
    g[..., 2] = (clock - clock[:, :1]) / (clock[:, -1:] - clock[:, :1])
    batch = {"gesture": g.astype(np.float32), "prototype": protos}
    if masked:
        lengths = np.array([seq, 97, 64, 40])
        batch["mask"] = (np.arange(seq)[None, :] < lengths[:, None]).astype(np.float32)
        for arr in (batch["gesture"], batch["prototype"]):
            for i, n in enumerate(lengths):
                arr[i, n:] = arr[i, n - 1]
    return batch


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _leaves(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree) for p, v in _leaves(x, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(np.sum((np.asarray(got[p], np.float64) - np.asarray(w, np.float64)) ** 2))
              for p, w in want.items())
    return (num / sum(float(np.sum(np.asarray(w, np.float64) ** 2)) for w in want.values())) ** 0.5


@pytest.mark.parametrize("run, dtype", STEP_CASES)
def test_the_recipe_step_at_full_width_matches_jax(run, dtype):
    """float32: as the module's docstring says. bfloat16: a rounding that
    flips on one side moves everything after it, and the JAX step itself
    moves as far from a one-ulp nudge of its initial state (G's gradient by
    15-46% relative L2), so each model is held to that control as
    BF16_CONTROL_FACTOR and BF16_FLOOR say. Measured, port / control: G
    0.18-0.62 / 0.15-0.46, E 0.09-0.59 / 0.09-0.36; the critics 0.02-0.10 /
    0.002-0.008, which the floor covers: among their differences are the
    bias gradients, which XLA's CPU backend sums in bfloat16 with a rounding
    after every add (in windows of 32) and the port in float32 with one
    rounding, as its kernels do (ROADMAP, Queue 3). Losses up to 5.7e-3 of
    max(1, |loss|)."""
    model, recipe, grad_tol = RECIPES[run]
    masked = model.get("generator_type") == "transformer"
    fields = dict(model, time_head="monotone", compute_dtype=dtype)
    tfields = dict(recipe, batch_size=STEP_B)
    jcfg, jtcfg = JaxModelConfig(**fields), JaxTrainingConfig(**tfields)
    start = jax.device_get(jax_init_gan_state(0, jcfg, jtcfg))
    batch = _gesture_batch(jcfg.seq_length, masked)
    jax_step = jax.jit(lambda s, b: (jax_masked_step if masked else jax_gan_train_step)(
        s, b, jnp.float32(0.0), jcfg, jtcfg))
    ref_state, ref_metrics = jax.device_get(jax_step(start, jax.tree.map(jnp.asarray, batch)))
    state = train_state_from_jax(start, device="cpu")
    noise = jax_step_draws(start["rng"], STEP_B, jtcfg.n_critic, jcfg.latent_dim,
                           bool(jtcfg.lambda_div) and not masked)
    step = gan_train_step_masked if masked else gan_train_step
    _, metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, 0.0,
                      ModelConfig(**fields), TrainingConfig(**tfields), noise=noise)
    assert set(metrics) == set(ref_metrics)
    loss_tol = 1e-4 if dtype == "float32" else BF16_LOSS_TOL
    for k, v in metrics.items():
        want = float(ref_metrics[k])
        assert abs(v.item() - want) <= loss_tol * max(1.0, abs(want)), (k, v.item(), want)
    if dtype == "bfloat16":
        ctl_state, _ = jax.device_get(jax_step(nudge(start, 1), jax.tree.map(jnp.asarray, batch)))
    for model_name in MODELS:
        want = _leaves(adam_moments(ref_state[model_name]["opt"])["mu"])
        got = _leaves(state[model_name]["opt"]["mu"])
        assert set(got) == set(want)
        if dtype == "bfloat16":
            port = _rel_l2({p: v.numpy() for p, v in got.items()}, want)
            ctl = _rel_l2(_leaves(adam_moments(ctl_state[model_name]["opt"])["mu"]), want)
            assert port <= BF16_CONTROL_FACTOR * ctl + BF16_FLOOR, (model_name, port, ctl)
            continue
        for path, leaf in got.items():
            w = np.asarray(want[path])
            np.testing.assert_allclose(leaf.numpy(), w,
                                       atol=grad_tol * max(np.abs(w).max(), 1e-30),
                                       err_msg=f"{model_name}{path}")


# -- several steps from one initial state ------------------------------------------------

TRAJECTORY_STEPS = 8


# The variable-length recipe on a small transformer (H=8 is the BiLSTM's).
SMALL_TRANSFORMER = dict(tfm_d_model=16, tfm_num_heads=2, tfm_num_layers=2)


@pytest.mark.parametrize("recipe", ["flag", "none", "varlen2", "varlen2-bfloat16"])
def test_the_recipe_tracks_jax_over_steps(recipe):
    """``tests/jax_trajectory.py`` at a small size (H=8, or a transformer of
    width 16 with two blocks for the variable-length recipe on its masked
    batch; four gestures, one batch repeated): the port and the JAX package
    train from one JAX initial state on the JAX step's own draws, with the
    flagship's auxiliary terms, with none, and with lambda_speed alone
    (varlen2). float32: over TRAJECTORY_STEPS steps G's and E's parameters
    stay within 1e-3 of JAX's (relative norm of the difference; measured up
    to 4.5e-4) and the reconstruction, latent and KLD losses within 1e-3
    relative (measured up to 5.4e-4, the KLD at the last step without
    auxiliary terms). The control, JAX from its initial state nudged by one
    float32 rounding step, must stay within the same bound on its parameters.
    bfloat16: with this few parameters a float32 nudge flips no bfloat16
    rounding, so the control is nudged by bfloat16's unit roundoff (2^-8,
    random sign); G's and E's distances from JAX must stay at or under the
    control's at every step (measured: G 0.8-1.3e-3 against 4.0-4.2e-3, E
    3.0-5.0e-3 against 5.3-6.3e-3) and cycle2_rec within 2e-3 relative
    (measured up to 1.4e-3)."""
    recipe, _, precision = recipe.partition("-")
    precision = precision or "float32"
    masked = recipe == "varlen2"
    batch = _gesture_batch(128, masked)
    arrays = (batch["gesture"], batch["prototype"]) + ((batch["mask"],) if masked else ())
    bf16 = precision == "bfloat16"
    records = list(trajectory([arrays] * TRAJECTORY_STEPS, recipe, hidden=8,
                              precision=precision, model=SMALL_TRANSFORMER if masked else None,
                              control_step=2.0 ** -8 if bf16 else 2.0 ** -24))
    assert len(records) == TRAJECTORY_STEPS
    names = ("cycle2_rec",) if masked else ("cycle2_rec", "cycle1_lat", "cycle2_kld")
    for rec in records:
        for model in ("g", "e"):
            if bf16:
                assert rec["port"][model] <= rec["control"][model], (rec["step"], model, rec)
                continue
            assert rec["port"][model] < 1e-3, (rec["step"], model, rec["port"])
            assert rec["control"][model] < 1e-3, (rec["step"], model, rec["control"])
        for name in names:
            want, got, _ = rec["losses"][name]
            tol = 2e-3 if bf16 else 1e-3
            assert abs(got - want) <= tol * max(1.0, abs(want)), (rec["step"], name, got, want)


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("family", ["bilstm", "mlp", "transformer"])
def test_initial_state_draws_like_jax(family):
    """The port's ``init_gan_state(42)`` is the JAX package's: every leaf of
    G, E, D1 and D2 (weights, biases, the output heads) within 1 ulp, the
    critics' u vectors within 2 ulp (their normal draws are bit-equal; the
    two packages sum the normalising norm in another order), and the same
    key, for each generator family at full width."""
    cfg = dict(time_head="monotone", generator_type=family)
    ref = jax.device_get(jax_init_gan_state(42, JaxModelConfig(**cfg), JaxTrainingConfig()))
    state = init_gan_state(42, ModelConfig(**cfg), "cpu")
    np.testing.assert_array_equal(state["rng"].numpy(), np.asarray(ref["rng"]))
    for model in MODELS:
        for part, tol in (("params", 1), ("sn", 2)):
            if part not in ref[model]:
                continue
            want = _leaves(ref[model][part])
            got = {k: v.detach().numpy() for k, v in _leaves(state[model][part]).items()}
            assert set(got) == set(want), (model, part)
            for path, w in want.items():
                assert got[path].shape == np.shape(w), (model, path)
                assert _ulps(got[path], w) <= tol, (model, part, path)