"""The port's spans (``utils/profiling.span``) in the epoch loop and the
sampling loop, on the CPU at the tiny sizes of ``test_torch_train_step.py``:
nothing recorded without a profiler, each span once where it belongs under
one, and the same losses and gestures either way."""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  one torch thread per test worker
from tests.test_torch_train_step import LOOP, MODEL, _dataset
from wordgesture_gan_tpu_torch.configs import ModelConfig, RuntimeConfig, TrainingConfig
from wordgesture_gan_tpu_torch.models.gan import Generator
from wordgesture_gan_tpu_torch.train.gan_loop import generate_gestures, train_gan
from wordgesture_gan_tpu_torch.utils.profiling import reset_spans, span, span_totals

EPOCHS, N_SAMPLES, SAMPLE_BATCH = 2, 11, 4      # 11 rows: 3 chunks of 4
GESTURES = 16                                    # 2 steps an epoch
EPOCH_SPANS = ("epoch.shuffle", "epoch.steps", "epoch.losses", "epoch.record",
               "epoch.callback", "epoch.checkpoint")
# Off the card nothing waits for a device: no sample.drain.
SAMPLE_SPANS = ("sample.call", "sample.pad", "sample.copy_in", "sample.chunk", "sample.noise",
                "sample.copy_out")


def _event_names(prof) -> set:
    """The names on a stopped profiler's timeline, from its raw events:
    ``prof.events()`` builds a Python object for each of a CPU training
    run's hundreds of thousands of operations, which takes tens of seconds."""
    return {e.name() for e in prof.profiler.kineto_results.events()}


def _run(profiled: bool, scan: bool):
    """A 2-epoch ``train_gan`` (graphed epochs on the CPU: ``run_epoch``'s
    loop) and one sampling call; returns the losses, the gestures, the span
    table and the profiler's event names."""
    config = ModelConfig(**MODEL)
    ds = _dataset(GESTURES)
    reset_spans()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) \
        if profiled else None
    if prof is not None:
        prof.start()
    try:
        result = train_gan(ds, config, TrainingConfig(**LOOP), RuntimeConfig(scan_epoch=scan),
                           num_epochs=EPOCHS, seed=3, epoch_callback=lambda *_: None,
                           verbose=False, device="cpu")
        out = generate_gestures(Generator(config), ds.prototypes[:N_SAMPLES], config, seed=7,
                                batch=SAMPLE_BATCH, device="cpu")
    finally:
        if prof is not None:
            prof.stop()
    names = _event_names(prof) if prof is not None else set()
    return result.history, out, span_totals(), names


@pytest.fixture(scope="module", params=[False, True], ids=["eager", "scan_epoch"])
def runs(request):
    return request.param, _run(False, request.param), _run(True, request.param)


def test_no_profiler_no_spans(runs):
    assert span("a") is span("b", items=3)      # one shared object
    _, (_, _, totals, _), _ = runs
    assert totals == {}


def test_profiler_records_each_span_where_it_belongs(runs):
    scan, _, (_, _, totals, names) = runs
    epoch_spans = EPOCH_SPANS + (("epoch.keys",) if scan else ())
    assert {n: totals[n]["count"] for n in epoch_spans} == dict.fromkeys(epoch_spans, EPOCHS)
    chunks = -(-N_SAMPLES // SAMPLE_BATCH)
    assert {n: totals[n]["count"] for n in SAMPLE_SPANS} == dict(
        dict.fromkeys(SAMPLE_SPANS, 1), **{"sample.chunk": chunks, "sample.noise": chunks})
    assert totals["sample.call"]["items"] == N_SAMPLES
    assert sum(t["items"] for t in totals.values()) == N_SAMPLES
    assert all(t["seconds"] >= 0 for t in totals.values())
    # The CPU epoch captures nothing.
    assert set(totals) == set(epoch_spans + SAMPLE_SPANS)
    assert set(totals) <= names


def test_profiler_changes_no_loss_and_no_gesture(runs):
    _, (history, out, _, _), (history_p, out_p, _, _) = runs
    assert history == history_p
    np.testing.assert_array_equal(out, out_p)


class _Stop(Exception):
    pass


def test_span_left_after_the_profiler_stopped():
    """As the benchmark traces: a profiler started in one epoch's callback
    and stopped in a later one's, which then raises. The spans entered with
    the profiler on are kept, the last callback's too."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])

    def on_epoch(epoch, state, losses):
        if epoch == 0:
            prof.start()
        elif epoch == 1:
            prof.stop()
            raise _Stop

    reset_spans()
    with pytest.raises(_Stop):
        train_gan(_dataset(GESTURES), ModelConfig(**MODEL), TrainingConfig(**LOOP),
                  RuntimeConfig(scan_epoch=True), num_epochs=3, epoch_callback=on_epoch,
                  verbose=False, device="cpu")
    counts = {n: t["count"] for n, t in span_totals().items()}
    assert counts == {"epoch.checkpoint": 1, "epoch.shuffle": 1, "epoch.keys": 1,
                      "epoch.steps": 1, "epoch.losses": 1, "epoch.record": 1,
                      "epoch.callback": 1}
    assert set(counts) <= _event_names(prof)
    assert span("after") is span("stop")
    reset_spans()
    assert span_totals() == {}
