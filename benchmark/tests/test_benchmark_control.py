"""The control on the card: the reference computed with TF32 on, in the
program's place, has to come out not correct against each training cell's
limits, and the program itself correct, at a size a test run can hold
(the cell's widths, a smaller batch). ``benchmark/calibrate.py`` takes the
same readings at the cells' own sizes."""

from __future__ import annotations

import copy

import pytest
import torch

from benchmark import calibrate, harness

SEEDS = (101, 102, 103)


def small(workload: str, batch: int) -> harness.Cell:
    cell = copy.deepcopy(harness.resolve(workload, harness.load_manifest()))
    cell.traffic["batch"] = batch
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("workload,batch", [("rfn_mnist.train_b720", 16),
                                            ("srnn_mnist.train_b128", 16),
                                            ("rfn_mnist.serve_b64", 8)])
def test_control_fails_where_the_program_passes(workload, batch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    cell = small(workload, batch)
    rows = calibrate.main(["--workload", workload, "--seeds", *map(str, SEEDS),
                           "--control", str(len(SEEDS)), "--fault", "0"],
                          cell=cell, device=torch.device("cuda", 0))
    for row in rows:
        if row["kind"] == "lower":
            assert harness.check_numbers(row["numbers"], cell.limits)[0], row
        if row["kind"] == "control":
            assert not harness.check_numbers(row["numbers"], cell.limits)[0], row
