"""Each fault a cell can have, planted underneath the timed path of a tiny
run on the CPU (past the look for a card), makes ``correct`` come out
false; the same run unbroken comes out true.  The faults: a step that hands
its state back unchanged, half of the batch left out, an answer altered
where it is produced.  (No cell runs across chips, so there is no exchange
to leave out.)"""

import pytest

from perfbench import harness
from perfbench.faults import FAULTS
from perfbench.tests.tiny import tiny_run

CELLS = ("maestro22k_bf16.restore_4seg", "maestro22k_bf16.train_b16",
         "maestro22k_bf16.generate_4x8s")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_fault_fails_the_check(cell, fault, monkeypatch):
    r = tiny_run(cell, seconds=1.0)
    if fault is not None:
        FAULTS[fault](monkeypatch, r.mix["kind"])
    harness.loop(r.mix["kind"]).run(r)
    assert r.checks
    assert r.correct is (fault is None), r.checks
