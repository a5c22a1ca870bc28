"""Each cell at its full size on the card: a one-job window is correct
against the reference. Skips where there is no card."""

import pytest
import torch

from benchmark.run import Cell, run_cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sd15_stylize", "sd3m_stylize"])
def test_cell_on_the_card(card, name):
    res = run_cell(Cell(name), 20260611, 1.0, False, card, log=lambda m: None)
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu" and res["attempted"] == 1
