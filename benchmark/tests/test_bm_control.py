"""The control: the reference one precision step below the configuration
(int4 for int8, fp8 for bf16, bf16 for fp32) in the program's place has to
come out not correct, while the program comes out correct."""

import pytest
from conftest import tiny_cell

from benchmark import spec
from benchmark.loads.serve_closed import Load


def _passes(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)


def test_control_reads_far_above_the_program_on_cpu():
    """At the test size the readings are smaller than at the cells' sizes
    (the test's ArcFace has 4 blocks, not 49), so the cells' limits do not
    apply; the control still reads 3× the program or more on every
    number, and the program passes the cells' limits."""
    cell = tiny_cell()
    limits = cell["limits"]["limits"]
    d = Load(cell, 3000000321, "cpu")
    d.setup()
    for i in range(2):
        d.serve(i)
    d.release()
    sound = d.check(requests=[0, 1])
    control = d.check(control=True, requests=[0, 1])
    assert _passes(sound, limits), sound
    assert all(control[k] >= 3 * sound[k] for k in limits), (sound, control)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec.benchmark()["workloads"]])
def test_control_fails_on_card_at_the_cells_size(card, workload):
    from benchmark.calibrate import readings

    cell = spec.cell(workload)
    for seed in (4000000000, 4000104729, 4000209458):
        numbers = readings(cell, seed, card, control=True)
        assert not _passes(numbers, cell["limits"]["limits"]), numbers
