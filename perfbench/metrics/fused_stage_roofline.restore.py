"""fused_stage_roofline.restore: K2 (csrc/fused_stage.cu), the least time of
its traced launches' work over their device time, %."""

from perfbench.readers import roofline


def read(run):
    return roofline(run, "fused_stage")
