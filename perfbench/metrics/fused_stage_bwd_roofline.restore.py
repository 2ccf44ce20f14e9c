"""fused_stage_bwd_roofline.restore: K2's backward to the input (its operand
pass included), least time over device time, %."""

from perfbench.readers import roofline


def read(run):
    return roofline(run, "fused_stage_bwd")
