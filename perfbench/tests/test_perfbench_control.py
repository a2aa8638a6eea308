"""On the card, at a size a test run holds (batch 8 and a short window, the
configuration's full widths): the program passes its cell's limits, and
neither the control (the reference in TF32 in the program's place) nor the
fault of half the batch left out does. The full-size readings the limits
were set from come from perfbench/calibrate.py, which judges them the same
way (PERF.md). Skips without a card."""

import copy

import pytest
import torch

from perfbench.core import spec
from perfbench.reference.compare import judge

CELLS = ('bond.sample.b100', 'bond.train.b64', 'o2.sample.b100')


@pytest.mark.cuda
@pytest.mark.parametrize('cell', CELLS)
def test_control_fails_and_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from perfbench.calibrate import readings
    c = copy.deepcopy(spec.load_cell(cell))
    c.traffic['batch'] = 8        # the widths stay; a test run holds it
    rows = readings(c, [101, 102, 103], 1.0, torch.device('cuda', 0))
    for row in rows:
        assert judge(row['program'], c.limits)[0], row
        assert not judge(row['control'], c.limits)[0], row
        assert not judge(row['half_batch'], c.limits)[0], row
