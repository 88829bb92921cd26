"""The control of each cell's comparison, at a size a test run holds: the
plain reference with the dense sweep's product in TF32 (one precision below
the configurations' float32), judged as a run's output is, on the cell's
own scene, comes out off by more than the cell's limit; the float32
reference against itself is never off.  On the card, ``python3 -m
benchmark.control`` reads it at the cells' own sizes."""

import copy

import pytest
import torch

from benchmark import control, manifest


@pytest.mark.parametrize("cell_name,samples", [("atrium.progressive", 2),
                                               ("envfield.sweep", 2),
                                               ("atrium.rerender", 1),
                                               ("litbanner.progressive", 2)])
def test_bench_control_fails_the_limit(cell_name, samples):
    cell = copy.deepcopy(manifest.cell(cell_name))
    t = cell["traffic"]
    t.update(check_pixels=32, check_frames=2, check_renders=2, spp=samples)
    got = control.readings(cell, 2400000101, torch.device("cpu"), samples, frames=40)
    assert got["reference_vs_itself"] == 0.0
    assert got["control_pixels_off_share"] > cell["limits"]["pixels_off_share"]


def test_bench_tf32_rounding():
    from benchmark.reference.tracer import tf32_round

    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0000001, float("inf")])
    got = tf32_round(x)
    assert got[0] == 1.0 and got[1] == 1.0  # a tie rounds to even
    assert got[2] == 1.0 + 4 * 2 ** -11
    assert got[3] == -3.0 and torch.isinf(got[4])
