"""Q8's per-item int8 quantizers (``csrc/quant_int8.cu``) on the CPU.

The kernels run only on the card (``chip_smoke.py --phases kernels``, or
``--phases q8`` alone, holds them to their plain versions bit for bit
there).  Here:

* ``kernels.q8_plan``, the cut the launchers hand the kernels, over B in
  1..512, per_b in 1..2^24, both dtypes and several cards (SMs x resident
  blocks): every element in exactly one unit, each unit inside one item and
  taken by exactly one block, every partial slot written by the block that
  reads it back after the barrier (one unit a block wherever an item has
  more than one), the grid no larger than the resident blocks.
* the kernels' arithmetic mirrored in numpy on that cut (phase 1's max per
  unit, the max of an item's partials, phase 2 per unit) against the plain
  version: equal bit for bit.
* the port's quantizers against the JAX package's ``_quant_act_per_item``
  and ``_quant_act_with_scale`` at the edge cases (an all-zero item, per-item
  amaxes a factor of 1e6 apart, a per_b that is not a multiple of 16,
  exact .5 ties after scaling), bf16 and fp32: s bit for bit, q within
  FLIP_SHARE (as ``tests/test_torch_int8_modes.py`` holds them: XLA may
  fuse the product and the rounding differently; 0 flips here).
* the launchers refuse CPU tensors: no fallback; a device's first Q8
  call inside a CUDA graph capture raises (the workspace is made outside
  any capture)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from babe_tpu.ops import conv_kernels as jck
from babe_tpu_torch import kernels
from babe_tpu_torch.ops import conv_kernels as tck

FLIP_SHARE = 1e-3
# (SMs, resident blocks an SM): the H100's 132 at one block of 1024
# threads, other occupancies, a small card, one block
CARDS = [(132, 1), (132, 6), (114, 2), (8, 4), (1, 1)]
DTYPES = [torch.float32, torch.bfloat16]


def _spans(plan):
    return [plan.span(u) for u in range(plan.units)]


@settings(max_examples=300, deadline=None)
@given(B=st.integers(1, 512), per_b=st.integers(1, 2**24),
       dtype=st.sampled_from(DTYPES), card=st.sampled_from(CARDS))
def test_q8_plan_cuts_every_element_once(B, per_b, dtype, card):
    sms, per_sm = card
    plan = kernels.q8_plan(B, per_b, dtype, sms, per_sm)
    assert 1 <= plan.grid <= sms * per_sm
    assert plan.chunk % kernels.Q8_GROUP == 0
    # the kernel loads a step of Q8_GROUP elements as 16-byte vectors (two
    # of bf16, four of fp32): a step is whole vectors, and so is the offset
    # of every unit's start within its item
    size = torch.tensor([], dtype=dtype).element_size()
    assert kernels.Q8_GROUP * size % 16 == 0
    assert plan.chunk * size % 16 == 0
    spans = _spans(plan)
    # the units tile the flattened x in order: each element in one unit
    assert spans[0][0] == 0 and spans[-1][1] == B * per_b
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    # each unit is non-empty and inside one item: item u // per_item
    for u, (lo, hi) in enumerate(spans):
        assert lo < hi
        assert lo // per_b == (hi - 1) // per_b == u // plan.per_item
    # each unit taken by exactly one block
    taken = np.zeros(plan.units, np.int64)
    for k in range(plan.grid):
        taken[list(plan.block_units(k))] += 1
    assert (taken == 1).all()
    if plan.per_item > 1:
        # the barrier's side: every slot written, one unit a block, all
        # resident at once
        assert plan.grid == plan.units <= sms * per_sm
        assert all(list(plan.block_units(k)) == [k]
                   for k in range(plan.grid))


@pytest.mark.parametrize("B,per_b,card,per_item", [
    (1, 3670016, (132, 1), 132),         # the smallest flagship tensor
    (4, 12582912, (132, 1), 33),         # the largest, at QAT's batch
    (3000, 1000, (132, 1), 1),           # more items than blocks: walking
    (2, 5, (132, 1), 1),                 # items under one step
])
def test_q8_plan_at_known_shapes(B, per_b, card, per_item):
    plan = kernels.q8_plan(B, per_b, torch.bfloat16, *card)
    assert plan.per_item == per_item
    assert plan.grid == min(B * per_item, card[0] * card[1])


def test_q8_plan_refuses_an_empty_x():
    with pytest.raises(ValueError):
        kernels.q8_plan(0, 16, torch.float32, 132, 1)
    with pytest.raises(ValueError):
        kernels.q8_plan(2, 0, torch.float32, 132, 1)


def _kernel_mirror(x: np.ndarray, plan, amax=None):
    """act_quant_dyn (amax None) or act_quant on ``plan``'s cut, in numpy:
    phase 1's max per unit into its partial slot, the max of an item's
    partials, then each unit quantized at 127 / a, as the kernels do."""
    flat = x.reshape(-1).astype(np.float32)
    B = plan.B
    if amax is None:
        partial = np.zeros(plan.units, np.float32)
        for k in range(plan.grid):
            for u in plan.block_units(k):
                lo, hi = plan.span(u)
                partial[u] = np.abs(flat[lo:hi]).max()
        amax = partial.reshape(B, plan.per_item).max(axis=1)
    a = np.maximum(amax.astype(np.float32), np.float32(1e-20))
    s = (a / np.float32(127)).astype(np.float32)
    iv = (np.float32(127) / a).astype(np.float32)
    q = np.empty(flat.shape, np.int8)
    for u in range(plan.units):
        lo, hi = plan.span(u)
        v = np.rint(flat[lo:hi] * iv[u // plan.per_item])
        q[lo:hi] = np.clip(v, -127, 127).astype(np.int8)
    return q.reshape(x.shape), s


def _edge_x(kind: str, dtype, rng):
    """Edge-case inputs (B, F, T, C) as torch tensors of ``dtype``."""
    if kind == "zero item":
        x = rng.standard_normal((2, 4, 8, 16)).astype(np.float32)
        x[1] = 0.0
    elif kind == "mixed scales":
        x = rng.standard_normal((3, 5, 7, 9)).astype(np.float32)
        x *= np.array([1e-3, 1.0, 1e3], np.float32)[:, None, None, None]
    elif kind == "odd per_b":
        x = rng.standard_normal((2, 3, 7, 11)).astype(np.float32)
    else:  # "ties": every value k + 0.5 after scaling at amax 127
        x = (rng.integers(-253, 254, (2, 4, 8, 16)) / 2.0).astype(np.float32)
        x[:, 0, 0, 0] = 127.0
    return torch.as_tensor(x).to(dtype)


EDGES = ["zero item", "mixed scales", "odd per_b", "ties"]


@pytest.mark.parametrize("card", [(132, 1), (1, 1), (2, 3)])
@pytest.mark.parametrize("kind", EDGES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_arithmetic_on_the_cut_matches_the_plain_version(
        rng, kind, dtype, card):
    x = _edge_x(kind, dtype, rng)
    B = x.shape[0]
    plan = kernels.q8_plan(B, x.numel() // B, dtype, *card)
    xf = x.float().numpy()
    q, s = _kernel_mirror(xf, plan)
    rq, rs = tck.quant_act_per_item(x)
    np.testing.assert_array_equal(q, rq.numpy())
    np.testing.assert_array_equal(s, rs.numpy())
    bound = 1.02 * x.float().abs().amax(dim=(1, 2, 3))
    q, s = _kernel_mirror(xf, plan, bound.numpy())
    rq, rs = tck.quant_act_with_scale(x, bound)
    np.testing.assert_array_equal(q, rq.numpy())
    np.testing.assert_array_equal(s, rs.numpy())


def _jax_input(x: torch.Tensor):
    a = jnp.asarray(x.float().numpy())
    return a.astype(jnp.bfloat16) if x.dtype == torch.bfloat16 else a


def _same_quant(q, s, jq, js):
    flips = int((q.numpy() != np.asarray(jq)).sum())
    assert flips <= FLIP_SHARE * q.numel(), flips
    np.testing.assert_array_equal(s.numpy(), np.asarray(js).reshape(-1))


@pytest.mark.parametrize("kind", EDGES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_quant_act_per_item_matches_jax(rng, kind, dtype):
    x = _edge_x(kind, dtype, rng)
    q, s = tck.quant_act_per_item(x)
    jq, js = jck._quant_act_per_item(_jax_input(x))
    _same_quant(q, s, jq, js)
    if kind == "zero item":
        assert not q[1].any() and float(s[1]) == np.float32(1e-20) / 127
    if kind == "ties":
        # 2.5 -> 2, -3.5 -> -4: half to even at iv = 1
        v = x.float()
        assert torch.equal(q.float(), torch.round(v))


@pytest.mark.parametrize("kind", EDGES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_quant_act_with_scale_matches_jax(rng, kind, dtype):
    x = _edge_x(kind, dtype, rng)
    bound = x.float().abs().amax(dim=(1, 2, 3))
    if kind != "ties":
        bound = 1.02 * bound
    q, s = tck.quant_act_with_scale(x, bound)
    jq, js = jck._quant_act_with_scale(_jax_input(x),
                                       jnp.asarray(bound.numpy()))
    _same_quant(q, s, jq, js)


def test_cpu_quantizers_count_nothing(rng):
    kernels.reset_launch_counts()
    x = _edge_x("odd per_b", torch.bfloat16, rng)
    tck.quant_act_per_item(x)
    tck.quant_act_with_scale(x, torch.ones(x.shape[0]))
    assert all(n == 0 for n in kernels.LAUNCHES.values())
    assert "act_amax" not in kernels.LAUNCHES


@pytest.mark.parametrize("upto", ["all", "scale", "partial"])
def test_act_quant_dyn_refuses_cpu_tensors(upto):
    """The launcher (and its parts' launcher) takes CUDA tensors only: it
    never falls back."""
    with pytest.raises(ValueError):
        if upto == "all":
            kernels.launch_act_quant_dyn(torch.zeros((2, 40)))
        else:
            kernels.launch_act_quant_dyn_part(torch.zeros((2, 40)), upto)
    with pytest.raises(ValueError):
        kernels.launch_act_quant_dyn(torch.zeros((2, 40),
                                                 dtype=torch.bfloat16))


def test_act_quant_dyn_part_refuses_an_unknown_part():
    with pytest.raises(ValueError):
        kernels.launch_act_quant_dyn_part(torch.zeros((2, 40)), "all")


def test_first_q8_call_inside_a_capture_raises(monkeypatch):
    """The partials' workspace is made outside any CUDA graph capture: a
    device's first Q8 call inside one raises (before it touches the card)
    rather than take the workspace from the graph's private pool."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    monkeypatch.setattr(kernels, "_Q8_STATE", {})
    with pytest.raises(RuntimeError, match="q8_prepare"):
        kernels._q8_state(torch.device("cuda", 0))
