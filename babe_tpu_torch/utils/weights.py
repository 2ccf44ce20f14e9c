"""Weight bridge between the JAX package's variable tree and the port.

The optimizer state of a training checkpoint crosses the same way
(``adam_state_to_flax`` / ``adam_state_from_flax``): Adam's first and second
moments are trees of the params' layout, inside optax's chain state.

The JAX ``CQTDiffPlus.init`` returns ``{'params': tree, 'buffers': tree}``
of nested dicts (``params['downs_0_2']['H_0']['conv']['kernel']``, HWIO conv
kernels, (in, out) linear kernels; ``buffers['embedding']['RFF_freq']`` and
``buffers['freq_encodings_i']['embeddings']``).  The port's modules carry the
same names, so a torch state-dict key is the JAX path joined with dots and
the tensors need no transposition.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _nest(flat: dict[str, np.ndarray]) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def from_flax(params, buffers=None) -> dict[str, torch.Tensor]:
    """JAX ``(params, buffers)`` trees -> a ``CQTDiffPlusNet`` state dict."""
    flat = _flatten(params)
    flat.update(_flatten(buffers or {}))
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in flat.items()}


def to_flax(net: torch.nn.Module):
    """A ``CQTDiffPlusNet`` (or any of its modules) -> JAX
    ``(params, buffers)`` trees of fp32 numpy arrays."""
    def tree(named):
        return _nest({k: v.detach().float().cpu().numpy() for k, v in named})

    return tree(net.named_parameters()), tree(net.named_buffers())


def load_flax(net: torch.nn.Module, params, buffers=None) -> None:
    """Copy a JAX variable tree into ``net`` (shape-checked, every entry
    required)."""
    sd = from_flax(params, buffers)
    own = net.state_dict()
    bad = [f"  {k}: checkpoint {tuple(sd[k].shape)} vs model "
           f"{tuple(own[k].shape)}"
           for k in sorted(set(sd) & set(own))
           if tuple(sd[k].shape) != tuple(own[k].shape)]
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if bad or missing or extra:
        raise ValueError(
            "weights do not fit the model:\n" + "\n".join(
                bad + [f"  missing {k}" for k in missing]
                + [f"  unexpected {k}" for k in extra]))
    net.load_state_dict(sd)


def to_tree(tensors: dict[str, torch.Tensor]) -> dict:
    """Flat ``{dotted name: tensor}`` (params-like) -> a JAX-layout tree of
    fp32 numpy arrays."""
    return _nest({k: v.detach().float().cpu().numpy()
                  for k, v in tensors.items()})


def adam_state_to_flax(count: int, mu, nu, sched_count: int,
                       clip: bool) -> tuple:
    """Adam's state in the layout of the JAX trainer's optax chain
    (``clip_by_global_norm`` then ``adam`` with a schedule), as plain tuples
    that any reader unpickles: ``((), ((count, mu, nu), (sched_count,)))``
    with the clip's empty state first, ``(((count, mu, nu),
    (sched_count,)),)`` without it.  The leaves flatten in the order of
    optax's own state, so the JAX trainer resumes from it."""
    chain = ((np.asarray(count, np.int32), to_tree(mu), to_tree(nu)),
             (np.asarray(sched_count, np.int32),))
    return ((), chain) if clip else (chain,)


def adam_state_from_flax(opt_state):
    """(count, mu, nu, sched_count) from either package's checkpoint (the
    chain's last entry holds Adam's state and the schedule's count; optax's
    named tuples arrive as the tester's field-keeping stand-ins); mu and nu
    as flat ``{dotted name: fp32 tensor}``."""
    (count, mu, nu), sched = opt_state[-1]
    return int(count), from_flax(mu), from_flax(nu), int(sched[0])
