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
"""

import importlib.util
import json
import shutil
from pathlib import Path

import pytest
import torch
import torch_threads  # noqa: F401  one torch thread per test worker

from wordgesture_gan_tpu.eval import gan_eval as jax_gan_eval
from wordgesture_gan_tpu_torch import train_cli
from wordgesture_gan_tpu_torch.eval import gan_eval

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
    # A run kept from before a rerun is shown beside it, its metrics only.
    kept = tmp_path / "out" / runner.EARLIER / "flag" / "before"
    kept.mkdir(parents=True)
    shutil.copy(run_dir / "eval.log", kept / "eval.log")
    beside = runner.report(tmp_path / "out")["runs"]["flag"]["earlier"]
    assert beside["before"]["l2_wasserstein"] == flag["metrics"]["l2_wasserstein"]["port"]
    assert "| earlier: before |" in (tmp_path / "out" / "results.md").read_text()
    shutil.rmtree(tmp_path / "out" / runner.EARLIER)
    # A trained and scored run is neither trained nor scored again.
    capsys.readouterr()
    again = runner.main(argv)["runs"]["flag"]["runner"]
    assert len(again["train_calls"]) == 1 and len(again["eval_calls"]) == 1
