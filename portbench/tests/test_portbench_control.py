"""The control fails the comparison that decides `correct`, and the
program passes it, at the cells' own size on a card: on three seeds,
the program's numbers are within every limit of the cell, and the
control's (the reference in float32 with its contractions' operands
rounded to TF32, in the program's place) break one of them at least.
`readings.py` prints the same readings for any number of seeds.

The configuration decides the readings: `pool16.placed` stands for both
of pool16's cells, whose jobs make the same call on the same pool."""

import pytest

from portbench.harness.manifest import Manifest


@pytest.mark.card
@pytest.mark.parametrize("workload", ["pool16.placed", "ksweep16.placed"])
def test_the_control_fails_where_the_program_passes(card, workload):
    from portbench.readings import readings
    limits = Manifest().cell(workload)["limits"]
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        sides = dict(readings(workload, seed, ("tf32",), card,
                              log=lambda m: None))
        program, control = sides["program"], sides["tf32"]
        assert all(program[k] <= v for k, v in limits.items()), \
            (seed, program)
        assert any(control[k] > v for k, v in limits.items()
                   if k in control), (seed, control)
