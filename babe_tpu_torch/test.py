"""Evaluation entry point of the port, on one device or over several
processes:

    python -m babe_tpu_torch.test tester=blind_bwe network=cqtdiff+ \\
        exp=maestro22k_8s dset=maestro_allyears tester.checkpoint=<ckpt>
    torchrun --nproc_per_node 4 -m babe_tpu_torch.test ...   # 4 cards

Counterpart of the repository's ``test.py``: the same ``conf/`` overrides,
the network, EDM, test set, optional STFT denoiser and tester built from
the config, the checkpoint loaded and every mode of ``tester.modes`` run
(``Tester.dodajob``).  ``exp.remat`` is off unless given (a training-memory
knob that would make every guided backward recompute the blocks).  The
checkpoint is ``tester.checkpoint`` itself or that name under
``model_dir``, a ``.ckpt`` pickle or a reference ``.pt`` torch checkpoint
(give ``network=cqtdiff+_ckpt`` for the published weights); nothing is
downloaded.  ``BABE_PRECISION`` (``bf16`` or ``int8``) sets the network's
precision, and the JAX package's int8 knobs (``BABE_INT8_MINC``, the
narrowest conv that runs int8, ``BABE_INT8_FUSED``, ``BABE_INT8_BWD``,
``BABE_INT8_SCALE``, ``BABE_INT8_OPS``; ``models/cqtdiff.py``) its int8
configuration.  It runs on the card, and then ends with a
line ``kernel launches: {...}`` (each hand kernel's launches in the run);
the override ``device=cpu`` runs the plain PyTorch path on the CPU.  Under
``torchrun`` each process joins the group
(``parallel.mesh.init_distributed``) and the tester spreads its sharded
modes over them, rank 0 writing the files.
"""

from __future__ import annotations

import json
import os
import sys


def _resolve_checkpoint(args) -> str:
    """``tester.checkpoint``, else that name under ``model_dir``."""
    ckpt = str(args.tester.checkpoint)
    cand = os.path.join(str(args.model_dir), ckpt)
    for path in (ckpt, cand):
        if os.path.exists(path):
            return path
    raise FileNotFoundError(
        f"checkpoint not found: tried {ckpt!r} and {cand!r} (nothing is "
        f"downloaded; place the file under {args.model_dir})")


def _main(args, device="cuda", overrides=None):
    """Build from ``args`` and run the tester's modes; ``overrides`` are
    the command line's (``sys.argv[1:]`` when None)."""
    from babe_tpu_torch.setup import (sampler_class, setup_diff_parameters,
                                      setup_network, tester_class)
    from babe_tpu_torch.utils.device import check_device

    from babe_tpu_torch.parallel.mesh import init_distributed

    device = check_device(device, "babe_tpu_torch.test")
    init_distributed(device=device)
    os.makedirs(str(args.model_dir), exist_ok=True)
    overrides = sys.argv[1:] if overrides is None else overrides
    if not any(ov.startswith("exp.remat=") for ov in overrides):
        args.exp["remat"] = False
    precision = os.environ.get("BABE_PRECISION", "bf16")
    model = setup_network(args, precision=precision)
    diff_params = setup_diff_parameters(args, cqt_hpf=model.apply_hpf_DC)
    # the tester runs the blind sampler, whichever class the config names
    # (as the JAX tester does); the name must still have a port
    sampler_class(args.tester.get("sampler_callable",
                                  "sampling.blind.BlindSampler"))

    test_set = None
    if args.get_path("dset.test.callable", None):
        from babe_tpu_torch.data.datasets import setup_dataset_test

        try:
            test_set = setup_dataset_test(args)
        except (FileNotFoundError, AssertionError) as e:
            # the modes on recordings folders need no test split; those
            # that do say it is missing
            print(f"warning: test set unavailable ({e}); continuing "
                  "without it")

    denoiser = None
    if args.get_path("tester.complete_recording.use_denoiser", False):
        from babe_tpu_torch.models.denoiser import setup_denoiser

        denoiser = setup_denoiser(args, device=device)

    tester = tester_class(args.tester.callable)(
        args, model, diff_params, device=device, test_set=test_set,
        denoiser=denoiser)
    if not bool(args.tester.get("do_test", True)):
        print("tester.do_test is False, nothing to do")
        return None
    tester.load_checkpoint(_resolve_checkpoint(args))
    results = tester.dodajob()
    if device.type == "cuda":
        from babe_tpu_torch import kernels

        print("kernel launches: " + json.dumps(kernels.LAUNCHES))
    return results


def main(argv=None):
    """Parse ``conf/`` overrides (plus ``device=...``) and test."""
    from babe_tpu_torch.config import default_config

    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    for a in [a for a in argv if a.startswith("device=")]:
        device = a.partition("=")[2]
        argv.remove(a)
    return _main(default_config(argv), device=device, overrides=argv)


if __name__ == "__main__":
    main()
