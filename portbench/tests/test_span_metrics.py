"""The readers of the program's spans (``train.boundary_ms``,
``gen.stage_ms_per_1k``, ``gen.dispatch_ms_per_1k``) against tables made up
here, with nothing to read, and against a program without spans; and a traced
sampling run on the CPU whose result line holds the two sampling metrics."""

import sys
import types

import pytest

from portbench import harness

SEED = 12345678901


def _table(**rows):
    """{name: {"count", "seconds", "items"}} from name=(count, seconds[, items])."""
    return {name.replace("_", ".", 1): {"count": r[0], "seconds": r[1],
                                        "items": r[2] if len(r) > 2 else 0}
            for name, r in rows.items()}


TRAIN = _table(epoch_shuffle=(2, 0.004), epoch_keys=(2, 0.030), epoch_steps=(2, 0.050),
               epoch_losses=(2, 2.4), epoch_record=(2, 0.0002), epoch_callback=(2, 9.0),
               epoch_checkpoint=(2, 0.0001), step_capture=(1, 3.0))
SAMPLE = _table(sample_call=(4, 0.9, 20_000), sample_pad=(4, 0.010), sample_copy_in=(4, 0.004),
                sample_chunk=(40, 0.300), sample_noise=(40, 0.020), sample_drain=(4, 0.5),
                sample_copy_out=(4, 0.006))


@pytest.fixture
def spans(monkeypatch):
    """Makes the program's ``span_totals`` return the table it is given."""
    from wordgesture_gan_tpu_torch.utils import profiling

    def use(table):
        monkeypatch.setattr(profiling, "span_totals", lambda: table)
    return use


@pytest.mark.parametrize("name, table, want", [
    # (4 + 30 + 0.2 + 0.1) ms over 2 epochs; losses, callback, capture out.
    ("train.boundary_ms", TRAIN, 34.3 / 2),
    # (10 + 4 + 6) ms over 20 thousand gestures.
    ("gen.stage_ms_per_1k", SAMPLE, 20.0 / 20),
    # 300 ms of chunks, the noise inside them, over 20 thousand gestures.
    ("gen.dispatch_ms_per_1k", SAMPLE, 300.0 / 20),
])
def test_reader_against_a_table(spans, name, table, want):
    spans(table)
    assert harness.reader(name)({}) == pytest.approx(want)
    spans({**TRAIN, **SAMPLE})
    assert harness.reader(name)({}) == pytest.approx(want)


@pytest.mark.parametrize("name", ["train.boundary_ms", "gen.stage_ms_per_1k",
                                  "gen.dispatch_ms_per_1k"])
def test_reader_finds_nothing(spans, monkeypatch, name):
    spans({})
    assert harness.reader(name)({}) is None
    # The other kind of cell's spans only.
    spans(SAMPLE if name.startswith("train") else TRAIN)
    assert harness.reader(name)({}) is None
    # A program without spans: its profiling module has no table.
    monkeypatch.setitem(sys.modules, "wordgesture_gan_tpu_torch.utils.profiling",
                        types.ModuleType("wordgesture_gan_tpu_torch.utils.profiling"))
    assert harness.reader(name)({}) is None


def test_cells_report_the_span_metrics():
    import json

    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    layer = {cell: {m["name"] for m in harness.metrics_of(bench, cell)["per_layer"]}
             for cell in ("flagship.train", "varlen_transformer.train",
                          "varlen_transformer.generate")}
    assert "train.boundary_ms" in layer["flagship.train"] & layer["varlen_transformer.train"]
    assert {"gen.stage_ms_per_1k", "gen.dispatch_ms_per_1k"} <= \
        layer["varlen_transformer.generate"]
    assert "train.boundary_ms" not in layer["varlen_transformer.generate"]


def test_traced_sampling_run_reports_the_span_metrics(cell_of, small):
    from wordgesture_gan_tpu_torch.utils.profiling import reset_spans

    cell = small(cell_of("varlen_transformer.generate"))
    reset_spans()
    try:
        out = harness.run(cell, SEED, 0.3, True, 0.0, device="cpu")["result"]
    finally:
        reset_spans()
    for name in ("gen.stage_ms_per_1k", "gen.dispatch_ms_per_1k"):
        assert out["metrics"][name]["value"] > 0
    assert out["correct"]
