"""The convs and products of one CQTDiff+ evaluation, from its sizes.

Level i of the encoder holds the i + 1 highest octaves stacked along F
(F = bins_per_oct * (i + 1)) at the time size of octave n - 1 - i; the
decoder mirrors it.  Each ResnetBlock with a (5,3) stack runs ``num_dils``
stages at dilations 2^0 .. 2^(nd-1); the 1x1 blocks project to and from the
CQT's two real channels.  This mirrors ``perfbench/reference/network.py``
and is held to PyTorch's own FLOP counter over it in
``perfbench/tests/test_counts.py``.
"""

from __future__ import annotations

from perfbench.counts import Conv, least_seconds
from perfbench.reference.cqt import frame


def _block(out, F, T, dim, dim_out, nd, emb, kernel=(5, 3), after=False):
    N = dim if after else dim_out
    if dim != N:
        out.append(Conv("1x1", F, T, dim, N))
    for i in range(nd):
        out.append(Conv("linear", 1, 1, emb, N, count=2))
        if kernel == (5, 3):
            out.append(Conv("stage", F, T, N, N, 5, 3, 2**i))
        else:
            out.append(Conv("1x1", F, T, N, N))
    if after and N != dim_out:
        out.append(Conv("1x1", F, T, N, dim_out))
    if dim != dim_out:
        out.append(Conv("1x1", F, T, dim, dim_out))


def network_convs(net: dict, audio_len: int, fs: float) -> list[Conv]:
    """Every conv and product of one evaluation of the network ``net`` (the
    configuration file's ``network`` group) on ``audio_len`` samples."""
    n, bpo = int(net["cqt"]["num_octs"]), int(net["cqt"]["bins_per_oct"])
    Ns, nd, emb = list(net["Ns"]), list(net["num_dils"]), int(net["emb_dim"])
    M = frame(n, bpo, float(fs), int(audio_len),
              float(net["cqt"]["beta"])).M
    out = [Conv("linear", 1, 1, 64, 128), Conv("linear", 1, 1, 128, 256),
           Conv("linear", 1, 1, 256, emb)]
    for i in range(n):
        T = M[n - 1 - i]
        d_in = Ns[i - 1] if i > 0 else Ns[0]
        _block(out, bpo, T, 2, d_in, 1, emb, (1, 1))
        _block(out, bpo * (i + 1), T, d_in, Ns[i], nd[i], emb)
        Tp = T // 2 if i < n - 1 else T
        out.append(Conv("pyramid", bpo * (i + 1), Tp, 2, Ns[i], 5, 3))
    _block(out, bpo * n, M[0], Ns[-1], Ns[-1], nd[-1], emb)
    _block(out, bpo * n, M[0], Ns[-1], 2, 1, emb, (1, 1), after=True)
    for p in range(n):
        j = n - 1 - p
        d_out = Ns[j - 1] if j > 0 else Ns[0]
        F, T = bpo * (j + 1), M[n - 1 - j]
        _block(out, F, T, 2 * Ns[j], d_out, nd[j], emb)
        _block(out, F, T, d_out, 2, 1, emb, (1, 1), after=True)
    return out


def stage_shapes(convs: list[Conv]) -> dict[tuple, int]:
    """(F, T, C, d) of each (5,3) dilation stage -> stages per evaluation."""
    out: dict[tuple, int] = {}
    for c in convs:
        if c.role == "stage":
            key = (c.F, c.T, c.C, c.dil)
            out[key] = out.get(key, 0) + c.count
    return out


def int8_stage(c: Conv, int8_min_channels: int | None) -> bool:
    """Whether a stage runs its forward in int8 under a fused int8 chain of
    at least ``int8_min_channels`` channels (None: no int8)."""
    return (int8_min_channels is not None and c.role == "stage"
            and c.C >= int8_min_channels)


def model_least_seconds(convs: list[Conv], batch: int, passes: dict,
                        int8_min_channels: int | None = None) -> float:
    """The least time of one evaluation's model operations at the peaks:
    each conv and product ``passes["forward"]`` times forward (in int8
    where ``int8_stage`` says so, else bf16), plus ``passes["input_grad"]``
    and ``passes["weight_grad"]`` times in bf16 (the noise embedding's
    products take no input gradient: they do not depend on the audio).
    Remat recomputes are not counted."""
    t = 0.0
    for c in convs:
        ops = c.ops_per_item * batch * c.count
        fwd = "int8" if int8_stage(c, int8_min_channels) else "bf16"
        bwd = passes.get("weight_grad", 0) + (
            0 if c.role == "linear" else passes.get("input_grad", 0))
        t += passes.get("forward", 0) * least_seconds(ops, 0.0, fwd)
        t += bwd * least_seconds(ops, 0.0, "bf16")
    return t
