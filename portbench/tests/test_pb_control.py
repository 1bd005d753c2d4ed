"""The control of `correct`: the reference computed in TF32 in the
program's place must come out not correct.  On the CPU at a small size
(TF32 emulated by rounding the operands), and on the card at a cell's own
size."""
import pytest

from portbench import catalog, control, harness


@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_control_fails_on_the_cpu(seed, shrink, cpu_call):
    cell = harness.Cell(catalog.load_benchmark(), "3ctx-plant-hifi")
    got = control.readings(cell, seed, ["default"], device="cpu",
                           traffic=shrink(cell.traffic), overrides=cpu_call,
                           log=lambda s: None)
    assert not got["control"]["correct"]
    assert got["default"]["correct"]


@pytest.mark.chip
@pytest.mark.parametrize("name", ["3ctx-plant-hifi"])
def test_control_fails_on_the_card(name, cuda):
    cell = harness.Cell(catalog.load_benchmark(), name)
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        got = control.readings(cell, seed, ["default"], log=lambda s: None)
        assert not got["control"]["correct"], (seed, got)
        assert got["default"]["correct"], (seed, got)
