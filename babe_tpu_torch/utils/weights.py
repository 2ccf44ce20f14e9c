"""Weight bridge between the JAX package's variable tree and the port.

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
