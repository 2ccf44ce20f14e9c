"""Factories for the network, the diffusion parameterization, the training
streams and the trainer, and the classes the test CLI builds.

Counterpart of ``babe_tpu/setup.py`` (``setup_network``,
``setup_diff_parameters``) and of the JAX package's registry lookups of
``dset.callable``, ``dset.test.callable``, ``exp.trainer_callable``,
``tester.callable`` and ``tester.sampler_callable``.  The shared ``conf/``
YAMLs name the JAX package's classes (or the reference's, which the JAX
registry aliases onto them); each is matched here by its last two dotted
components (module and class), by name only, and mapped onto its port.
"""

from __future__ import annotations

from babe_tpu_torch.data import datasets as _ds
from babe_tpu_torch.diffusion.edm import EDM
from babe_tpu_torch.diffusion.edm_eps import EDMEps
from babe_tpu_torch.diffusion.edm_pd import EDMPD
from babe_tpu_torch.models.cqtdiff import CQTDiffPlus
from babe_tpu_torch.sampling.blind import BlindSampler
from babe_tpu_torch.sampling.heun import Sampler
from babe_tpu_torch.testers.tester import Tester
from babe_tpu_torch.training.trainer import Trainer

_NETWORKS = {
    ("cqtdiff", "CQTDiffPlus"): CQTDiffPlus,
    ("cqtdiff+", "Unet_CQT_oct_with_attention"): CQTDiffPlus,
}
# the JAX callables and the reference's names (the A-weighted variant is
# the EDM class with aweighting.use_aweighting set)
_DIFF_PARAMS = {
    ("edm", "EDM"): EDM, ("edm_eps", "EDMEps"): EDMEps,
    ("edm_pd", "EDMPD"): EDMPD, ("edm_aweighting", "EDM"): EDM,
    ("edm_eps", "EDM"): EDMEps, ("edm_PD", "EDM"): EDMPD}
_DATASETS = {("datasets", c.__name__): c for c in (
    _ds.AudioFolderDataset, _ds.MaestroDataset, _ds.MaestroDatasetFs,
    _ds.CocoChoralesDataset)}
_TRAINERS = {("trainer", "Trainer"): Trainer}
# the reference's five tester classes are the one mode-dispatching Tester
_TESTERS = {key: Tester for key in (
    ("tester", "Tester"), ("blind_bwe_tester", "BlindTester"),
    ("blind_bwe_tester_small", "BlindTester"),
    ("blind_bwe_tester_mushra", "BlindTester"),
    ("denoise_and_bwe_tester", "BlindTester"))}
_SAMPLERS = {("blind", "BlindSampler"): BlindSampler,
             ("blind_bwe_sampler", "BlindSampler"): BlindSampler,
             ("heun", "Sampler"): Sampler, ("edm_sampler", "Sampler"): Sampler}
_TEST_DATASETS = {
    ("datasets", "AudioFolderDatasetTest"): _ds.AudioFolderDatasetTest,
    ("audiofolder_test", "AudioFolderDatasetTest"): _ds.AudioFolderDatasetTest,
    ("datasets", "MaestroDatasetTestChunks"): _ds.MaestroDatasetTestChunks,
    ("maestro_dataset_test", "MaestroDatasetTestChunks"):
        _ds.MaestroDatasetTestChunks}


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


def tester_class(name):
    """The port's tester for a ``tester.callable`` name."""
    return _resolve(_TESTERS, name, "tester callable")


def sampler_class(name):
    """The port's sampler for a ``tester.sampler_callable`` name."""
    return _resolve(_SAMPLERS, name, "sampler callable")


def test_dataset_class(name):
    """The port's test set class for a ``dset.test.callable`` name."""
    return _resolve(_TEST_DATASETS, name, "dset.test callable")
