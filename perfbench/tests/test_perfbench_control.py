"""On the card: the control (the reference with TF32 on, the precision below
the configuration's float32) and a planted fault (the loss's mean over half
the nodes), each in the program's place, fail a limit of the cell, while the
program itself passes them.  At the n = 3 level of a smaller corpus, so a
test run holds it; ``control.py`` reads the same at the cells' own size."""

import pytest

from perfbench import control
from perfbench.lib import check, manifest

BENCH = manifest.benchmark()
MIX = {"corpus": {"sequences": 2000, "min_length": 50, "max_length": 1000, "data_seed": 2024},
       "n": 3, "feat_dim": 64, "num_classes": 4}


@pytest.mark.chip
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_and_fault_fail_the_limits(cell, cuda_device, tmp_path):
    limits = manifest.limits(cell)
    w = manifest.workload(BENCH, cell)
    for line in control.readings(BENCH, w, [11, 2**33 + 12, 13], cuda_device, mix=MIX,
                                 cache_root=tmp_path):
        assert all(line["sound"][k] <= limits[k]["limit"] for k in check.NUMBERS), line
        for variant in ("control", "half_batch"):
            assert any(line[variant][k] > limits[k]["limit"] for k in check.NUMBERS), line
