"""Seeded weights, made on the device in one draw.

Every parameter and buffer of the network comes from one ``torch.randn``
over all of them, on a generator of the run's device seeded from
``--seed``, then scaled by a rule on its name: a kernel (a Linear's
(in, out) or a conv's HWIO) by 1 / sqrt(fan_in), the gates included, so
that every residual branch carries weight (the program's own init starts
the gates at 1e-7, which would hide the stage convs from the comparison);
a bias by 0.1; a GroupNorm gain as 1 + 0.1 n; the random Fourier
frequencies of the noise embedding by 16.  The program and the reference
are handed the same tensors.
"""

from __future__ import annotations

import hashlib
import math

import torch


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for ``tag`` under the run's ``seed``."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _scale(name: str, shape) -> tuple[float, float]:
    """(offset, scale) of a standard normal for the tensor ``name``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "kernel":
        return 0.0, 1.0 / math.sqrt(math.prod(shape[:-1]))
    if leaf == "bias":
        return 0.0, 0.1
    if leaf == "gamma":
        return 1.0, 0.1
    if leaf == "RFF_freq":
        return 0.0, 16.0
    raise ValueError(f"no seeded rule for the network tensor {name!r}")


def seeded_tensors(shapes: dict, seed: int, device) -> dict:
    """``{name: tensor}`` in float32 on ``device`` for ``{name: shape}``."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    g = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out = {}
    for n, v in zip(names, torch.split(flat, sizes)):
        off, sc = _scale(n, shapes[n])
        out[n] = (v * sc + off).view(shapes[n])
    return out


def load_into(module: torch.nn.Module, tensors: dict) -> None:
    """Copy ``tensors`` into the module's parameters and buffers in place;
    every one of them has to be given."""
    own = dict(module.named_parameters())
    own.update(module.named_buffers())
    if set(own) != set(tensors):
        raise ValueError(f"weights do not match the network: missing "
                         f"{sorted(set(own) - set(tensors))[:5]}, extra "
                         f"{sorted(set(tensors) - set(own))[:5]}")
    with torch.no_grad():
        for n, p in own.items():
            p.copy_(tensors[n])
