"""The check on the card at each cell's own size: a sound run is correct and the
lower-precision control (the network served in int8) is not.

Needs an NVIDIA GPU; run from the checkout's root with
``python -m pytest -m cuda stereobench/tests/test_stereobench_card.py``.
"""

import time

import pytest
import torch

from stereobench import harness

CELLS = ["fast-bf16-offline-b32", "classic-bf16-offline-b32"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("control", [False, True])
def test_check_at_the_cells_own_size(card, name, control):
    cell = harness.find_cell(name)
    res = harness.run_cell(cell, 4242, 3.0, False, card,
                           control=cell.config["control"] if control else None,
                           t_start=time.monotonic())
    assert res["samples"] == cell.traffic["samples"]
    assert res["correct"] is not control, res["checks"]
