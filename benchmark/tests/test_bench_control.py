"""The control on the card: the TF32 reference put in the program's
place fails the comparison, while the program passes it, on three seeds
at 131,072 rows (the smallest corpus the scan kernels serve) and each
cell's own width, metric and batch. ``calibrate.py`` takes the
same readings at the cells' full size."""

import pytest
import torch

from benchmark import calibrate, spec

CELLS = ["cohere768.batch1k.k10", "gist960.batch1k.k10"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name, card, small_cell):
    cell = small_cell(name, rows=1 << 17, pool=4096)
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        program = calibrate.readings(cell, seed, "program", 1.0, card)
        control = calibrate.readings(cell, seed, "control", 1.0, card)
        assert program["within_limits"], program
        assert not control["within_limits"], control
