"""The control of each cell, the step below the precision its
configuration states, read at a tiny size on the CPU: it lands well above
the program's own readings on the same states.  On the card, at the
cells' own sizes, ``test_control_fails_the_limits`` reads it on three
seeds and holds it above the cell's limits (``perfbench/calibrate.py``
gives the readings the limits were set from)."""


import pytest
import torch

from perfbench import calibrate, harness
from perfbench.tests.tiny import tiny_run

KINDS = {"restore": calibrate.restore, "generate": calibrate.generate,
         "train": calibrate.train}


@pytest.mark.parametrize("cell,number", [
    ("maestro22k_bf16.restore_4seg", "den_err"),
    ("maestro22k_int8.restore_4seg", "den_err"),
    ("maestro22k_bf16.generate_4x8s", "den_err"),
    ("maestro22k_bf16.train_b16", "update_med")])
def test_control_reads_above_the_program(cell, number, monkeypatch):
    # the tiny network's stacks are 8 and 16 wide: its int8 path starts there
    monkeypatch.setenv("BABE_INT8_MINC", "8")
    r = tiny_run(cell)
    out = KINDS[r.mix["kind"]](r, control=True)
    assert out["control"][number] > 1.5 * out["program"][number], out


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.manifest()["workloads"]])
def test_control_fails_the_limits(cell, card):
    for seed in (101, 102, 103):
        r = calibrate.make_run(cell, seed, card)
        out = KINDS[r.mix["kind"]](r, control=True)
        assert any(v > r.limits[k] for k, v in out["control"].items()), out
        torch.cuda.empty_cache()
