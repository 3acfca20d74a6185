"""On the card, at each cell's own size: the control (the reference with
float8 products in the program's place) fails at least one of the cell's
limits on three seeds, where the program's own run passes them all; in a
training cell so does the program with half of each batch left out in the
graph's replays alone. Skips without a card. Run on the card with

    python3 -m pytest portbench/tests/test_on_card.py -q
"""

import pytest

from portbench.calibrate import generate_readings, train_readings

CELLS = ["flagship.train", "varlen_transformer.train", "flagship.generate",
         "varlen_transformer.generate"]
SEEDS = (2 ** 31 + 11, 2 ** 32 + 17, 2 ** 33 + 19)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_where_the_program_passes(workload, cuda_device, cell_of):
    cell = cell_of(workload)
    limits = {k: v["limit"] for k, v in cell["limits"].items()
              if isinstance(v, dict) and "limit" in v}
    for seed in SEEDS:
        if cell["traffic_spec"]["kind"] == "train":
            r = train_readings(cell, seed, True, cuda_device)
        else:
            r = generate_readings(cell, seed, True, cuda_device, 3.0)
        assert all(r["program"][k] <= limits[k] for k in limits), (seed, r["program"])
        assert any(r["control"][k] > limits[k] for k in limits), (seed, r["control"])
        if "half_batch_replays" in r:
            assert any(r["half_batch_replays"][k] > limits[k] for k in limits), \
                (seed, r["half_batch_replays"])
