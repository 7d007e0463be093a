"""The control (the reference at one difference fewer than the
configuration's budget, put in the program's place) fails the cell's
limits; at a toy size here, at the cell's size on the card (``PERF.md``)."""

import json
import os

import pytest

from portbench import control, harness
from portbench.tests.toy import toy_root


@pytest.mark.parametrize("cell", ["chr21rep_se100.wgs", "chr21rep_pe150.wgs"])
def test_control_fails_a_limit(tmp_path, cell):
    root, _ = toy_root(str(tmp_path), sample=200 if "se" in cell else 96)
    spec = harness.Spec(cell, root)
    nums = control.control_numbers(spec, 2 ** 33 + 17,
                                   cache=str(tmp_path / "cache"))
    limits = spec.params["limits"]
    assert any(nums[k] > limits[k] for k in limits if k in nums), nums


@pytest.mark.parametrize("cell", ["chr21rep_se100.wgs", "chr21rep_pe150.wgs"])
def test_limits_are_the_cells(cell):
    with open(os.path.join(harness.HERE, "cells", cell + ".json")) as fh:
        lim = json.load(fh)["limits"]
    assert lim["missing"] == 0
    assert set(lim) <= {"missing", "status_diff", "line_diff"}
