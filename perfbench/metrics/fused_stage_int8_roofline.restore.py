"""fused_stage_int8_roofline.restore: K3 (csrc/fused_stage_int8.cu, its
operand pass included), least time at the int8 peak over device time, %."""

from perfbench.readers import roofline


def read(run):
    return roofline(run, "fused_stage_int8")
