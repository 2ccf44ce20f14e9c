"""Factories for the network, the diffusion parameterization, the training
streams and the trainer.

Counterpart of ``babe_tpu/setup.py`` (``setup_network``,
``setup_diff_parameters``) and of the JAX package's registry lookups of
``dset.callable`` and ``exp.trainer_callable``.  The shared ``conf/`` YAMLs
name the JAX package's classes (or the reference's); each is matched here by
its last two dotted components (module and class), by name only, and mapped
onto its port.
"""

from __future__ import annotations

from babe_tpu_torch.data import datasets as _ds
from babe_tpu_torch.diffusion.edm import EDM
from babe_tpu_torch.models.cqtdiff import CQTDiffPlus
from babe_tpu_torch.training.trainer import Trainer

_NETWORKS = {
    ("cqtdiff", "CQTDiffPlus"): CQTDiffPlus,
    ("cqtdiff+", "Unet_CQT_oct_with_attention"): CQTDiffPlus,
}
_DIFF_PARAMS = {("edm", "EDM"): EDM}
_DATASETS = {("datasets", c.__name__): c for c in (
    _ds.AudioFolderDataset, _ds.MaestroDataset, _ds.MaestroDatasetFs,
    _ds.CocoChoralesDataset)}
_TRAINERS = {("trainer", "Trainer"): Trainer}


def _resolve(table: dict, name, what: str):
    key = tuple(str(name).split(".")[-2:])
    if key not in table:
        raise NotImplementedError(f"{what} {name!r} has no port yet")
    return table[key]


def setup_diff_parameters(args, cqt_hpf=None) -> EDM:
    cls = _resolve(_DIFF_PARAMS, args.diff_params.get("callable", "edm.EDM"),
                   "diff_params callable")
    return cls.from_config(args, cqt_hpf=cqt_hpf)


def setup_network(args, compute_dtype=None, precision=None) -> CQTDiffPlus:
    cls = _resolve(_NETWORKS, args.network.get(
        "callable", "cqtdiff.CQTDiffPlus"), "network callable")
    return cls.from_config(args, compute_dtype=compute_dtype,
                           precision=precision)


def dataset_class(name):
    """The port's training stream class for a ``dset.callable`` name."""
    return _resolve(_DATASETS, name, "dset callable")


def trainer_class(name):
    """The port's trainer for an ``exp.trainer_callable`` name."""
    return _resolve(_TRAINERS, name, "trainer callable")
