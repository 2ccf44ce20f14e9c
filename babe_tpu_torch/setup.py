"""Factories for the network and the diffusion parameterization.

Counterpart of ``babe_tpu/setup.py`` (``setup_network``,
``setup_diff_parameters``).  The shared ``conf/`` YAMLs name the JAX
package's classes (or the reference's); each is matched here by its last
two dotted components (module and class) and mapped onto its port.
"""

from __future__ import annotations

from babe_tpu_torch.diffusion.edm import EDM
from babe_tpu_torch.models.cqtdiff import CQTDiffPlus

_NETWORKS = {
    ("cqtdiff", "CQTDiffPlus"): CQTDiffPlus,
    ("cqtdiff+", "Unet_CQT_oct_with_attention"): CQTDiffPlus,
}
_DIFF_PARAMS = {("edm", "EDM"): EDM}


def _resolve(table: dict, name, what: str):
    key = tuple(str(name).split(".")[-2:])
    if key not in table:
        raise NotImplementedError(f"{what} {name!r} has no port yet")
    return table[key]


def setup_diff_parameters(args, cqt_hpf=None) -> EDM:
    cls = _resolve(_DIFF_PARAMS, args.diff_params.get("callable", "edm.EDM"),
                   "diff_params callable")
    return cls.from_config(args, cqt_hpf=cqt_hpf)


def setup_network(args, compute_dtype=None) -> CQTDiffPlus:
    cls = _resolve(_NETWORKS, args.network.get(
        "callable", "cqtdiff.CQTDiffPlus"), "network callable")
    return cls.from_config(args, compute_dtype=compute_dtype)
