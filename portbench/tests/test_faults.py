"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven at a
small size on the CPU with the program in float32, against the committed
limits. The sound run passes; each fault the cell can have fails."""

import numpy as np
import pytest

from portbench import harness
from portbench.calibrate import STEPS, half_batch

SEED = 12345678901


def _run(cell, seconds=0.3):
    return harness.run(cell, SEED, seconds, False, 0.0, device="cpu")["result"]


def _no_update(*args, **kwargs):
    return None


def _plant_half_batch(sound_calls):
    """Half of each batch left out from the step's call ``sound_calls + 1``
    on: 0, every step; 1, every step after the eager warm-up, which on a
    card is the capture, so every replay of the graph."""
    def plant(mp):
        import importlib

        for module, name in STEPS:
            m = importlib.import_module(module)
            mp.setattr(m, name, half_batch(getattr(m, name), sound_calls))
    return plant


TRAIN_FAULTS = {
    "sound": lambda mp: None,
    "state_unchanged": lambda mp: [
        mp.setattr("wordgesture_gan_tpu_torch.train.gan_step.apply_update", _no_update),
        mp.setattr("wordgesture_gan_tpu_torch.train.masked_step.apply_update", _no_update)],
    "half_batch": _plant_half_batch(0),
    "half_batch_replays": _plant_half_batch(1),
}


def _sampling(fault):
    from wordgesture_gan_tpu_torch.train import gan_loop

    original = gan_loop.generate_gestures

    def broken(generator, prototypes, config, *args, seed=0, **kwargs):
        if fault == "answer_altered":     # every row drawn from another key
            return original(generator, prototypes, config, *args, seed=seed + 1, **kwargs)
        out = original(generator, prototypes, config, *args, seed=seed, **kwargs)
        if fault == "half_batch":          # the second half of each job never computed
            out[len(out) // 2:] = 0.0
        if fault == "state_unchanged":     # the prototypes handed back as they came
            out = np.array(prototypes, np.float32)
        return out
    return broken


GENERATE_FAULTS = ("sound", "answer_altered", "half_batch", "state_unchanged")


@pytest.mark.parametrize("fault", list(TRAIN_FAULTS))
@pytest.mark.parametrize("workload", ["flagship.train", "varlen_transformer.train"])
def test_training_faults(workload, fault, small, monkeypatch, cell_of):
    cell = small(cell_of(workload))
    TRAIN_FAULTS[fault](monkeypatch)
    assert _run(cell)["correct"] is (fault == "sound")


@pytest.mark.parametrize("fault", GENERATE_FAULTS)
@pytest.mark.parametrize("workload", ["flagship.generate", "varlen_transformer.generate"])
def test_sampling_faults(workload, fault, small, monkeypatch, cell_of):
    cell = small(cell_of(workload))
    if fault != "sound":
        broken = _sampling(fault)
        monkeypatch.setattr("wordgesture_gan_tpu_torch.train.gan_loop.generate_gestures", broken)
        monkeypatch.setattr("wordgesture_gan_tpu_torch.train.variable_loop.generate_gestures",
                            broken)
    assert _run(cell)["correct"] is (fault == "sound")
