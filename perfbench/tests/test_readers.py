"""The trace's reductions and the metric readers on hand-made traces: the
busy time is the union of device intervals, gaps are named by the host
span open over them, and a roofline is read only where every kernel name
matched one kernel per expected launch."""

import pytest

from perfbench import harness
from perfbench.counts import Conv, least_seconds
from perfbench.counts.kernels import fused_stage
from perfbench.trace import Trace


def _run(trace, convs, passes=None, int8=None):
    r = harness.Run(workload="w", seed=0, seconds=1.0, trace=True,
                    config={}, mix={}, limits={})
    r.trace_data = trace
    r.counts = {"convs": convs, "batch": 2,
                "passes": passes or {"forward": 1},
                "int8_min_channels": int8, "writes_conv": False}
    r.window_s, r.units = 2.0, 4
    return r


def test_busy_idle_and_gaps():
    t = Trace(window_s=10e-6, units=1,
              ops=[("a", 0.0, 4.0), ("b", 2.0, 5.0), ("c", 7.0, 9.0)],
              host=[("outer", 0.0, 10.0), ("inner", 5.5, 6.5)])
    assert t.busy_s() == pytest.approx(7e-6)
    assert t.idle_gaps() == [["inner", pytest.approx(2e-6)]]
    r = _run(t, [])
    assert harness.read_metric("idle_share.restore", r) == pytest.approx(30)
    assert harness.read_metric("launches_per_eval.restore", r) == 3


def test_roofline_reads_only_whole_launch_counts():
    stage = Conv("stage", 8, 16, 64, 64, 5, 3, 2, count=2)
    ops = [("babe::fwd::stage_h(bf16)", 0.0, 10.0),
           ("void babe::sm90::stage_sm90<128, 0>(P, A)", 10.0, 110.0)] * 2
    t = Trace(window_s=1.0, units=1, ops=ops)
    r = _run(t, [stage])
    want = 2 * least_seconds(*fused_stage(2, 8, 16, 64, writes_conv=False))
    assert harness.read_metric("fused_stage_roofline.generate", r) == (
        pytest.approx(100 * want / 220e-6))
    t.ops = ops[:3]  # one kernel short: the reader says nothing
    assert harness.read_metric("fused_stage_roofline.generate", r) is None
    r.trace_data = None
    assert harness.read_metric("fused_stage_roofline.generate", r) is None


def test_int8_stages_launch_k2_forward_only_under_a_gradient():
    stage = Conv("stage", 8, 16, 128, 128, 5, 3, 1)
    ops = [("babe::k3::stage_q(x)", 0.0, 1.0),
           ("void babe::sm90::stage_sm90<128, 2>(P, A)", 1.0, 2.0)]
    r = _run(Trace(window_s=1.0, units=1, ops=ops), [stage], int8=96)
    assert harness.read_metric("fused_stage_int8_roofline.restore", r)
    assert harness.read_metric("fused_stage_roofline.restore", r) is None
    r.counts["passes"] = {"forward": 1, "input_grad": 1}
    assert harness.read_metric("fused_stage_roofline.restore", r) is None
