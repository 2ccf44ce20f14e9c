"""The orbax checkpoint directory committed for the card, whose Python has
no orbax: ``tests/data/torch_orbax_fixture.orbax/`` and, beside it,
``torch_orbax_fixture.json`` with each leaf's sha256.

The payload has the JAX trainer's tree (``Trainer._state_payload``: it,
params, buffers, optax's chain state of the clip's ``EmptyState``, Adam's
count, mu and nu and the schedule's count, and the EMA) at small widths,
drawn from ``SEED``: random fp32 leaves (their zstd literals are Huffman
coded) and structured ones (zeros, ramps, a repeated pattern: FSE-coded
sequences and long matches).  Write it with orbax's ``StandardCheckpointer``
(the OCDBT layout) by running, from the repo root::

    JAX_PLATFORMS=cpu python tests/torch_orbax_fixture.py

``tests/test_torch_orbax.py`` remakes the payload from ``SEED`` and holds
the committed directory and digests to it; ``chip_smoke.py``'s ``pt``
phase decodes the directory with the port's reader and checks the digests.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

SEED = 17
HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "data", "torch_orbax_fixture.orbax")
DIGESTS = os.path.join(HERE, "data", "torch_orbax_fixture.json")


def _tree(rng, kind: str) -> dict:
    """A small network's params tree; ``kind`` picks the values."""
    shapes = {"downs_0_0": {"H_0": {"conv": {"kernel": (5, 3, 16, 16)}},
                            "affine_0": {"bias": (16,), "kernel": (32, 16)},
                            "norm_0": {"gamma": (16,)}},
              "downs_1_0": {"H_0": {"conv": {"kernel": (5, 3, 16, 32)}},
                            "res_conv": {"conv": {"kernel": (1, 1, 16, 32)}}},
              "ups_0_0": {"proj_out": {"conv": {"kernel": (1, 1, 32, 16)}},
                          "gate_0": {"bias": (32,), "kernel": (64, 32)}},
              "embedding": {"proj": {"kernel": (32, 256)}}}

    def leaf(shape):
        n = int(np.prod(shape))
        if kind == "params":
            return (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(
                np.float32)
        if kind == "mu":  # mostly zero, a few entries set
            v = np.zeros(n, np.float32)
            v[rng.integers(0, n, max(1, n // 64))] = 1e-3
            return v.reshape(shape)
        if kind == "nu":  # a ramp
            return (np.arange(n, dtype=np.float32) * 1e-6).reshape(shape)
        # the EMA: a 37-value pattern repeated
        return np.resize(rng.standard_normal(37).astype(np.float32),
                         n).reshape(shape)

    def walk(d):
        return {k: walk(v) if isinstance(v, dict) else leaf(v)
                for k, v in d.items()}

    return walk(shapes)


def payload(seed: int = SEED) -> dict:
    """The fixture's payload, with optax's named tuples as the JAX
    trainer's state holds them."""
    import optax

    rng = np.random.default_rng(seed)
    params = _tree(rng, "params")
    adam = optax.ScaleByAdamState(count=np.asarray(7, np.int32),
                                  mu=_tree(rng, "mu"), nu=_tree(rng, "nu"))
    sched = optax.ScaleByScheduleState(count=np.asarray(7, np.int32))
    return {"it": 7, "params": params,
            "buffers": {"embedding": {"RFF_freq": rng.standard_normal(
                (1, 32)).astype(np.float32)}},
            "opt_state": (optax.EmptyState(), (adam, sched)),
            "ema": _tree(rng, "ema")}


def leaf_digests(tree, prefix: str = "") -> dict:
    """{dotted key path: {"sha256", "dtype", "shape"}} of every array or
    number of a restored tree (dicts and lists; None and empty containers
    carry nothing)."""
    out = {}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple))
             else None)
    if items is None:
        if tree is None:
            return out
        a = np.ascontiguousarray(np.asarray(tree))
        return {prefix: {"sha256": hashlib.sha256(a.tobytes()).hexdigest(),
                         "dtype": a.dtype.str, "shape": list(a.shape)}}
    for k, v in items:
        out.update(leaf_digests(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def main() -> None:
    import shutil

    import orbax.checkpoint as ocp

    if os.path.exists(FIXTURE):
        shutil.rmtree(FIXTURE)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(FIXTURE, payload(), force=True)
    ckptr.wait_until_finished()
    restored = ocp.StandardCheckpointer().restore(FIXTURE)
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(FIXTURE) for f in fs)
    with open(DIGESTS, "w") as f:
        json.dump({"seed": SEED, "directory_bytes": total,
                   "leaves": leaf_digests(restored)}, f, indent=1,
                  sort_keys=True)
    print(f"wrote {FIXTURE} ({total} bytes) and {DIGESTS}")


if __name__ == "__main__":
    main()
