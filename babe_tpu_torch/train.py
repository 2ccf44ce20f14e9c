"""Training entry point of the port, on one device:

    python -m babe_tpu_torch.train dset=musicnet dset.path=<wavs> \\
        exp=maestro22k_8s network=cqtdiff+ model_dir=experiments/run1 \\
        tester.do_test=false

Counterpart of the repository's ``train.py``: the same ``conf/`` overrides,
the training stream, network, EDM and trainer built from the config, the
loop for ``exp.total_its`` steps (forever when unset) and a final
checkpoint that both packages' loaders read.  The tester demos of heavy
logging are not ported: a run that would reach
``logging.heavy_log_interval`` needs ``tester.do_test=false``.  It runs on
the card; the override ``device=cpu`` runs the plain PyTorch path on the
CPU.
"""

from __future__ import annotations

import os
import sys


def _main(args, device="cuda"):
    from babe_tpu_torch.data.datasets import setup_dataset
    from babe_tpu_torch.setup import (setup_diff_parameters, setup_network,
                                      trainer_class)

    dirname = str(args.model_dir)
    os.makedirs(dirname, exist_ok=True)
    args.exp["model_dir"] = dirname
    dset = setup_dataset(args)
    model = setup_network(args)
    diff_params = setup_diff_parameters(args, cqt_hpf=model.apply_hpf_DC)
    trainer_cls = trainer_class(args.exp.get(
        "trainer_callable", "training.trainer.Trainer"))
    print(f"training on 1 device ({device}), batch {int(args.exp.batch)}")
    try:
        trainer = trainer_cls(args, dset, model, diff_params, device=device)
        print(f"total params: {trainer.total_params / 1e6:.2f} M")
        total_its = args.exp.get("total_its", None)
        trainer.training_loop(
            max_its=None if total_its in (None, "None") else int(total_its))
        if bool(args.get_path("logging.save_model", True)):
            print("saved final checkpoint:", trainer.save_checkpoint())
    finally:
        dset.close()
    return trainer


def main(argv=None):
    """Parse ``conf/`` overrides (plus ``device=...``) and train."""
    from babe_tpu_torch.config import default_config

    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    for a in [a for a in argv if a.startswith("device=")]:
        device = a.partition("=")[2]
        argv.remove(a)
    return _main(default_config(argv), device=device)


if __name__ == "__main__":
    main()
