"""Operations and bytes from shapes: hand-worked small cases, and the
network's count held to PyTorch's FLOP counter over the reference."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import counts
from perfbench.counts import kernels as K
from perfbench.counts.network import (model_least_seconds, network_convs,
                                      stage_shapes)
from perfbench.reference import network as rn
from perfbench.weights import seeded_tensors

TINY = {"Ns": [8, 8, 16], "num_dils": [1, 1, 2], "emb_dim": 32,
        "cqt": {"num_octs": 3, "bins_per_oct": 8, "beta": 1}}


def test_stage_kernels_by_hand():
    # B=1, F=2, T=3, C=4: 6 positions, 24 values a tensor, 15 taps of a
    # 4 x 4 product
    assert K.conv_ops(1, 2, 3, 4) == 2 * 6 * 16 * 15 == 2880
    # x in, y and c out (bf16: 3 x 24 x 2), the kernel (15 x 16 x 2), a and
    # s in and the two moments out (fp32, one a channel: 4 x 4 x 4)
    assert K.fused_stage(1, 2, 3, 4) == (2880, 144 + 480 + 64, "bf16")
    assert K.fused_stage(1, 2, 3, 4, writes_conv=False)[1] == 96 + 480 + 64
    # B=2: x, y, c, g_y in, dx out (5 x 48 x 2); a, s, g_mom in and da, ds
    # out (6 x 2 x 4 x 4)
    assert K.fused_stage_bwd(2, 2, 3, 4) == (5760, 480 + 480 + 192, "bf16")
    # x in, y out (2 x 24 x 2), the int8 kernel (240), the scales in
    # (4 x (2 x 4 + 1)) and three moments out (3 x 4 x 4)
    assert K.fused_stage_int8(1, 2, 3, 4) == (2880, 96 + 240 + 36 + 48,
                                              "int8")
    # x, y, g_y in (3 x 24 x 2), a, s, g_mom in (4 x 4 x 4), dW out in fp32
    assert K.fused_stage_dw(1, 2, 3, 4) == (2880, 144 + 64 + 960, "bf16")


def test_least_seconds_takes_the_longer_bound():
    assert counts.least_seconds(989e12, 0.0, "bf16") == pytest.approx(1.0)
    assert counts.least_seconds(1.0, 3.35e12, "bf16") == pytest.approx(1.0)
    assert counts.least_seconds(1979e12, 1.0, "int8") == pytest.approx(1.0)


def test_flagship_stage_shapes():
    """The flagship's 75 stages at its (F, T, C) levels (the shapes of the
    port's kernel table)."""
    net = {"Ns": [64, 96, 96, 128, 128, 256, 256],
           "num_dils": [2, 3, 4, 5, 6, 7, 7], "emb_dim": 256,
           "cqt": {"num_octs": 7, "bins_per_oct": 64, "beta": 1}}
    convs = network_convs(net, 184184, 22050.0)
    shapes = stage_shapes(convs)
    assert sum(shapes.values()) == 75
    assert shapes[(64, 2048, 64, 1)] == 2 and shapes[(448, 32, 256, 64)] == 3
    assert sum(c for (F, T, C, d), c in shapes.items() if C >= 96) == 68
    fwd = sum(c.ops_per_item * c.count for c in convs)
    assert 2.0e12 < fwd < 2.05e12


def test_network_count_matches_the_flop_counter():
    """Every conv and product of one evaluation, counted from shapes, equals
    what PyTorch's FLOP counter sees in the reference's U-Net."""
    cfg = rn.NetConfig(num_octs=3, bins_per_oct=8, emb_dim=32, Ns=(8, 8, 16),
                       num_dils=(1, 1, 2), audio_len=4096)
    from babe_tpu_torch.models.cqtdiff import CQTDiffPlusNet

    net = CQTDiffPlusNet(num_octs=3, bins_per_oct=8, emb_dim=32,
                         Ns=(8, 8, 16), num_dils=(1, 1, 2))
    P = seeded_tensors({n: tuple(t.shape) for n, t in
                        net.state_dict().items()}, 1, "cpu")
    fr = cfg.frame
    coeffs = fr.analysis(fr.spectrum(torch.randn(2, 4096)))
    with FlopCounterMode(display=False) as fc:
        rn.unet(P, cfg, coeffs, torch.zeros(2, 1))
    convs = network_convs(TINY, 4096, 22050.0)
    batch = 2
    assert fc.get_total_flops() == batch * sum(c.ops_per_item * c.count
                                               for c in convs)


def test_model_least_seconds_by_pass_and_dtype():
    convs = network_convs(TINY, 4096, 22050.0)
    bf = sum(c.ops_per_item * c.count for c in convs) / 989e12
    lin = sum(c.ops_per_item * c.count for c in convs
              if c.role == "linear") / 989e12
    assert model_least_seconds(convs, 1, {"forward": 1}) == pytest.approx(bf)
    assert model_least_seconds(convs, 2, {"forward": 1, "input_grad": 1}
                               ) == pytest.approx(2 * (2 * bf - lin))
    i8 = sum(c.ops_per_item * c.count for c in convs
             if c.role == "stage" and c.C >= 16)
    assert model_least_seconds(convs, 1, {"forward": 1}, 16) == (
        pytest.approx(bf - i8 / 989e12 + i8 / 1979e12))
