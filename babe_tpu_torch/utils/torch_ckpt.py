"""Reference PyTorch checkpoints (``.pt``) -> the JAX-layout variable tree.

The port's own copy of ``babe_tpu/utils/torch_ckpt.py``.  The published BABE
checkpoints are torch pickles of the reference network
(``Unet_CQT_oct_with_attention``), whose module names the JAX tree mirrors
with underscores (``downs.0.2.H.3.weight`` -> ``downs_0_2/H_3/conv/kernel``),
so the conversion is a mechanical walk:

  * Conv2d  weight (O,I,kh,kw) -> kernel (kh,kw,I,O)
  * Conv1d  weight (O,I,k)     -> kernel (k,I,O)
  * Linear  weight (O,I)       -> kernel (I,O)
  * Embedding weight kept as it is (relative_attention_bias)
  * BiasFreeGroupNorm gamma (1,C,1,1) -> (C,)
  * the non-trainable RFF buffers -> the "buffers" collection
  * the fixed resampling kernels (``*samplerT``/``*samplerF``) and the
    frequency encodings' ``RFF_freq`` are dropped (derived or constant).

The result is the tree the JAX package's ``CQTDiffPlus.init`` returns, so
the weight bridge (``utils/weights.py``: ``load_flax``, and
``load_denoiser_flax`` for the STFT denoiser) serves both formats with one
name map.  ``fill_variables`` pours a converted tree into a template tree
(the port's ``to_flax`` of the built network), shape-checked.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np


def extract_network_state(ckpt: Mapping[str, Any],
                          prefer: str = "ema") -> dict:
    """The network's state dict inside a reference checkpoint: the first of
    ``prefer``, ema, network, ema_model, state_dict, model that holds
    tensors (else the checkpoint itself), with the ``diffusion_ema.`` or
    ``diffusion.`` prefix stripped."""
    if not isinstance(ckpt, Mapping):
        raise TypeError("checkpoint must be a dict-like object")

    def strip_prefixes(sd: Mapping) -> dict:
        for prefix in ("diffusion_ema.", "diffusion."):
            sub = {k[len(prefix):]: v for k, v in sd.items()
                   if k.startswith(prefix)}
            if sub:
                return sub
        return dict(sd)

    for key in (prefer, "ema", "network", "ema_model", "state_dict",
                "model"):
        sd = ckpt.get(key)
        if isinstance(sd, Mapping) and any(hasattr(v, "shape")
                                           for v in sd.values()):
            return strip_prefixes(sd)
    if any(hasattr(v, "shape") for v in ckpt.values()):
        return strip_prefixes(ckpt)
    raise ValueError(f"no network weights found; top-level keys: "
                     f"{list(ckpt)[:10]}")


def _to_numpy(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _tree_path(torch_key: str) -> list[str]:
    """'downs.0.2.H.3.weight' -> ['downs_0_2', 'H_3', 'weight']."""
    out: list[str] = []
    for tok in torch_key.split("."):
        if tok.isdigit() and out:
            out[-1] = f"{out[-1]}_{tok}"
        else:
            out.append(tok)
    return out


def _insert(tree: dict, path: list[str], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def convert_state_dict(state_dict: Mapping[str, Any]) -> dict:
    """A reference state dict -> {'params': tree, 'buffers': tree} of fp32
    numpy arrays in the JAX layout."""
    params: dict = {}
    buffers: dict = {}
    for key, tensor in state_dict.items():
        arr = _to_numpy(tensor).astype(np.float32)
        path = _tree_path(key)
        kind, struct = path[-1], path[:-1]
        if kind == "kernel" and struct and struct[-1].endswith(
                ("samplerT", "samplerF")):
            continue  # the fixed resampling kernels are constants here
        if kind == "RFF_freq":
            if struct and struct[0].startswith("freq_encodings"):
                continue  # derived: the module keeps only its table
            _insert(buffers, struct + ["RFF_freq"], arr)
        elif kind == "embeddings":
            _insert(buffers, struct + ["embeddings"],
                    arr.reshape(arr.shape[-2:]))
        elif kind == "gamma":
            _insert(params, struct + ["gamma"], arr.reshape(-1))
        elif kind == "fembeddings":
            # the denoiser's AddFreqEncoding table
            _insert(params, struct[:-1] + ["freq_encoding_fembeddings"], arr)
        elif kind == "weight":
            if struct and struct[-1] == "relative_attention_bias":
                _insert(params, struct[:-1] + ["relative_attention_bias"],
                        arr)
            elif arr.ndim == 4:
                # a Conv2d (O,I,kh,kw), or a ConvTranspose2d (I,O,kh,kw)
                # into flax's transpose_kernel layout (kh,kw,O,I): one
                # transposition serves both
                _insert(params, struct + ["kernel"], arr.transpose(2, 3, 1, 0))
            elif arr.ndim == 3:
                _insert(params, struct + ["kernel"], arr.transpose(2, 1, 0))
            elif arr.ndim == 2:
                _insert(params, struct + ["kernel"], arr.transpose(1, 0))
            else:
                raise ValueError(f"unexpected weight rank for {key}: "
                                 f"{arr.shape}")
        elif kind == "bias":
            if arr.ndim != 1:
                raise ValueError(f"unexpected bias rank for {key}: "
                                 f"{arr.shape}")
            _insert(params, struct + ["bias"], arr)
        elif kind == "scale":  # LayerScale: defined, unused in the forward
            _insert(params, struct + ["scale"], arr)
        else:
            raise ValueError(f"unrecognized parameter kind in key {key!r}")
    return {"params": params, "buffers": buffers}


def _tree_paths(tree: Mapping, prefix=()) -> dict[tuple, Any]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_tree_paths(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def fill_variables(template: Mapping, converted: Mapping,
                   strict: bool = True) -> dict:
    """Pour a converted tree into ``template`` ({collection: tree}),
    shape-checked.  A converted path that the template lacks is tried one
    ``conv`` level down (the Conv2d wrappers' nesting) and with its last
    two module names merged (``finalblock`` + ``conv2`` ->
    ``finalblock_conv2``).  ``strict``: every path on both sides must
    match, else ValueError naming the first mismatches; otherwise a
    template entry the checkpoint lacks keeps the template's value.  A
    shape mismatch always raises, naming the key."""
    tflat = {}
    for coll in template:
        tflat.update(_tree_paths({coll: template[coll]}))
    cflat = {}
    for coll in ("params", "buffers"):
        if coll in converted:
            cflat.update(_tree_paths({coll: converted[coll]}))

    remapped = {}
    for path, val in cflat.items():
        alts = [path, path[:-1] + ("conv", path[-1])]
        if len(path) >= 3:
            alts.append(path[:-3] + (path[-3] + "_" + path[-2], path[-1]))
        remapped[next((a for a in alts if a in tflat), path)] = val
    cflat = remapped

    missing = sorted(set(map(str, tflat)) - set(map(str, cflat)))
    extra = sorted(set(map(str, cflat)) - set(map(str, tflat)))
    if strict and (missing or extra):
        raise ValueError(
            f"checkpoint/model mismatch.\n missing ({len(missing)}): "
            f"{missing[:8]}\n extra ({len(extra)}): {extra[:8]}")

    out: dict = {}
    for path, tval in tflat.items():
        val = np.asarray(tval)
        if path in cflat:
            cval = np.asarray(cflat[path])
            if cval.shape != val.shape:
                raise ValueError(f"shape mismatch at {'/'.join(path)}: "
                                 f"ckpt {cval.shape} vs model {val.shape}")
            val = cval
        _insert(out, list(path), val)
    return out


def read_torch_checkpoint(path: str):
    """The unpickled reference checkpoint at ``path`` (``torch.load`` on
    the CPU with full unpickling, as the JAX package reads it: only for a
    path the user names)."""
    import torch

    return torch.load(path, map_location="cpu", weights_only=False)


def load_torch_checkpoint(path: str, prefer: str = "ema") -> dict:
    """torch.load, extract, convert: {'params': tree, 'buffers': tree}."""
    return convert_state_dict(extract_network_state(
        read_torch_checkpoint(path), prefer=prefer))
