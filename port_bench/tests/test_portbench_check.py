"""The check fails what it must: the control (the reference in fp8 in the
program's place) and a run with the timed path broken underneath by each
fault a cell can have, under the cell's own limits, at 48 px on the
CPU."""
import numpy as np
import pytest
import torch

from conftest import ROOT, run_small, small_cell
from port_bench import check, faults, harness, inputs

SPEC = harness.load_spec(ROOT)
CELLS = [w["name"] for w in SPEC["workloads"]]
# half of the batch left out is a fault only a cell of several pairs can have
CELL_FAULTS = [(cell, fault) for cell in CELLS for fault in faults.FAULTS
               if fault != "half_batch" or harness.load_cell(SPEC, cell)[
                   "traffic_file"]["pairs_per_request"] > 1]


@pytest.mark.parametrize("cell,fault", CELL_FAULTS)
def test_a_broken_step_is_not_correct(cell, fault):
    with faults.FAULTS[fault]():
        result = run_small(small_cell(cell))
    assert result["correct"] is False and result["failed"] == 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    c = small_cell(cell)
    traffic = c["traffic_file"]
    for seed in (21, 22, 23):
        gen = torch.Generator().manual_seed(seed)
        params = inputs.vgg_weights(c["config_file"]["vgg19_blocks"], gen,
                                    "cpu")
        pool = inputs.make_pairs(traffic, gen, "cpu")
        pairs = inputs.request_pairs(pool, traffic["pairs_per_request"], 0)
        control = check.reference(c["config_file"], params, pairs,
                                  traffic["stamp_every"], c["check_file"],
                                  "fp8", "cpu")
        numbers = harness.judge(c, params, pool, control, "cpu")
        assert not check.correct(numbers), numbers


def test_missing_rows_are_not_correct():
    c = small_cell("config3.batch8_512")
    contents = np.zeros((8, 4, 4, 3))
    ref = (np.ones((8, 3, 5)), np.ones((8, 4, 4, 3)))
    limits = c["check_file"]

    def judged(got):
        return check.correct(check.compare(got, ref, contents, limits))
    assert not judged(None)
    assert not judged((np.ones((8, 2, 5)), ref[1]))
    assert not judged((ref[0], np.ones((8, 4, 5, 3))))
    bad = ref[0].copy()
    bad[0, 0, 0] = np.nan
    assert not judged((bad, ref[1]))
    moved = ref[1].copy()
    moved[3] += 1.0
    assert not judged((ref[0], moved))
    assert judged((ref[0].copy(), ref[1].copy()))
