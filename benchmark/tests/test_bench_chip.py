"""One short run of each cell on the card (marker gpu; skips where there
is no card): correct, with the device named and the metrics present."""
import os

import pytest

from bench_tiny import ROOT, load_json

M = load_json(os.path.join(ROOT, "BENCHMARK.json"))


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_cell_runs_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    import harness

    res, lines = harness.run_cell(cell, 2 ** 31 + 77, 1, 0)
    assert res["correct"], lines
    assert res["device"]["platform"] == "gpu"
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
