"""Weight bridge between the JAX package's variable tree and the port.

The optimizer state of a training checkpoint crosses the same way
(``adam_state_to_flax`` / ``adam_state_from_flax``, and
``adam_state_to_orbax`` for orbax directories): Adam's first and second
moments are trees of the params' layout, inside optax's chain state.

The JAX ``CQTDiffPlus.init`` returns ``{'params': tree, 'buffers': tree}``
of nested dicts (``params['downs_0_2']['H_0']['conv']['kernel']``, HWIO conv
kernels, (in, out) linear kernels; ``buffers['embedding']['RFF_freq']`` and
``buffers['freq_encodings_i']['embeddings']``).  The port's modules carry the
same names, so a torch state-dict key is the JAX path joined with dots and
the tensors need no transposition.

The STFT denoiser (``models/denoiser.py``) crosses through its own pair,
``load_denoiser_flax`` / ``denoiser_to_flax``: there the port is NCHW and
the JAX package channels-last, so every 4-D ``kernel`` leaf becomes a
``weight`` transposed by (3, 2, 0, 1): a conv kernel (kh, kw, in, out) to
(out, in, kh, kw), and a transposed conv's (kh, kw, out, in) (flax's
``transpose_kernel=True`` layout) to PyTorch's (in, out, kh, kw), with no
flip.  Biases and ``freq_encoding_fembeddings`` cross as they are.
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
    _load_checked(net, from_flax(params, buffers))


def _load_checked(net: torch.nn.Module, sd: dict) -> None:
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


def denoiser_from_flax(params) -> dict[str, torch.Tensor]:
    """A JAX ``MultiStageDenoiseNet`` params tree -> the port's state
    dict."""
    out = {}
    for k, v in _flatten(params).items():
        v = np.asarray(v, dtype=np.float32)
        if k.endswith(".kernel"):
            k, v = k[:-len("kernel")] + "weight", v.transpose(3, 2, 0, 1)
        out[k] = torch.from_numpy(np.array(v, order="C"))
    return out


def load_denoiser_flax(net: torch.nn.Module, params) -> None:
    """Copy a JAX denoiser params tree into ``net`` (shape-checked, every
    entry required)."""
    _load_checked(net, denoiser_from_flax(params))


def denoiser_to_flax(net: torch.nn.Module) -> dict:
    """The port's denoiser network -> a JAX params tree of fp32 numpy
    arrays."""
    flat = {}
    for k, v in net.state_dict().items():
        v = v.detach().float().cpu().numpy()
        if k.endswith(".weight"):
            k, v = k[:-len("weight")] + "kernel", v.transpose(2, 3, 1, 0)
        flat[k] = np.ascontiguousarray(v)
    return _nest(flat)


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


def adam_state_to_orbax(count: int, mu, nu, sched_count: int,
                        clip: bool) -> list:
    """Adam's state in the tree that orbax stores for the JAX trainer's
    optax chain: each named tuple a dict of its fields
    (``ScaleByAdamState``'s count, mu, nu; ``ScaleByScheduleState``'s
    count), the clip's ``EmptyState`` None, the chains lists:
    ``[None, [{count, mu, nu}, {count}]]`` with the clip,
    ``[[{count, mu, nu}, {count}]]`` without."""
    chain = [{"count": np.asarray(count, np.int32), "mu": to_tree(mu),
              "nu": to_tree(nu)},
             {"count": np.asarray(sched_count, np.int32)}]
    return [None, chain] if clip else [chain]


def adam_state_from_flax(opt_state):
    """(count, mu, nu, sched_count) from either package's checkpoint (the
    chain's last entry holds Adam's state and the schedule's count; optax's
    named tuples arrive as the tester's field-keeping stand-ins from a
    pickle, as dicts of their fields from an orbax directory); mu and nu as
    flat ``{dotted name: fp32 tensor}``."""
    adam, sched = opt_state[-1]
    if isinstance(adam, dict):
        count, mu, nu = adam["count"], adam["mu"], adam["nu"]
    else:
        count, mu, nu = adam
    sched = sched["count"] if isinstance(sched, dict) else sched[0]
    return int(count), from_flax(mu), from_flax(nu), int(sched)
