"""On the card: each cell's control (the plain reference at TF32 in the
program's place) fails the cell's limits, and the program on the same
inputs passes them, at the cell's own widths with a short window.

Run on a machine with an NVIDIA GPU:
    python -m pytest -q -m cuda benchmark/tests/test_benchmark_card.py
"""

import gc

import pytest
import torch

from benchmark.core.cell import load_cell
from benchmark.core.precision import set_precision
from benchmark.core.runner import Ctx

SEEDS = {"ffhq256.find_direction": 2 ** 32 + 101,
         "ffhq256.sweep4": 2 ** 32 + 102,
         "ffhq256.edit_open": 2 ** 32 + 103,
         "ffhq1024.photo_batch": 2 ** 32 + 104}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SEEDS))
def test_the_control_fails_and_the_program_passes(name, card):
    cell = load_cell(name)
    set_precision(cell.config)
    driver = cell.driver
    ctx = Ctx(cell, SEEDS[name], 3.0, False, card)
    state = driver.setup(ctx)
    record = driver.window(ctx, state)
    outputs = record.pop("outputs")
    inputs = driver.release(ctx, state)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    program = driver.check(ctx, inputs, outputs)
    control = driver.check(ctx, inputs, driver.control(ctx, inputs, outputs))
    limits = {k: v["limit"] for k, v in cell.limits.items()}
    assert all(program[k] <= limits[k] for k in limits), (program, limits)
    assert any(control[k] > limits[k] for k in limits), (control, limits)
