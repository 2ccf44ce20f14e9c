"""fused_stage_dw_roofline.train: the stage weight gradient (csrc/conv_dw.cu,
its operand pass included), least time over device time, %."""

from perfbench.readers import roofline


def read(run):
    return roofline(run, "fused_stage_dw")
