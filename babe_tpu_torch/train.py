"""Training entry point of the port, on one device or data-parallel over
several processes:

    python -m babe_tpu_torch.train dset=musicnet dset.path=<wavs> \\
        exp=maestro22k_8s network=cqtdiff+ model_dir=experiments/run1 \\
        tester.do_test=false
    torchrun --nproc_per_node 4 -m babe_tpu_torch.train ...   # 4 cards

Counterpart of the repository's ``train.py``: the same ``conf/`` overrides,
the training stream, network, diffusion family (``diff_params=edm``,
``edm_aweighting``, ``edm_eps`` or ``edm_PD``) and trainer built from the
config, the loop for ``exp.total_its`` steps (forever when unset) and a
final checkpoint that both packages' loaders read.  With
``diff_params=edm_PD diff_params.PD.teacher_checkpoint=<.ckpt>`` a second
network of the same config holds the teacher (the checkpoint's EMA, else
its params, and its buffers), frozen, and the trainer distills it at
``diff_params.PD.stage``.  With ``tester.do_test`` a tester on its own
network runs the demos every ``logging.heavy_log_interval`` steps (on
rank 0).  It runs on the card; the override ``device=cpu`` runs the plain
PyTorch path on the CPU.  Under ``torchrun`` each process joins the group
(``parallel.mesh.init_distributed``: NCCL on the cards, gloo with
``device=cpu``) and takes its rows of each batch (``mesh_for_batch``:
``exp.batch`` must divide the process count, as in ``train.py``).
"""

from __future__ import annotations

import os
import sys


def _main(args, device="cuda"):
    from babe_tpu_torch.data.datasets import setup_dataset
    from babe_tpu_torch.parallel.mesh import init_distributed, mesh_for_batch
    from babe_tpu_torch.setup import (setup_diff_parameters, setup_network,
                                      trainer_class)

    init_distributed(device=device)
    n_batch = int(args.exp.batch)
    # a hard error (never a silent one-process fallback) when the batch
    # cannot be split over the processes
    mesh = mesh_for_batch(n_batch, device=device)
    dirname = str(args.model_dir)
    os.makedirs(dirname, exist_ok=True)
    args.exp["model_dir"] = dirname
    dset = setup_dataset(args)
    model = setup_network(args)
    diff_params = setup_diff_parameters(args, cqt_hpf=model.apply_hpf_DC)
    teacher = _load_teacher(args, device)
    tester = _demo_tester(args, diff_params, device) if mesh.is_main else None
    trainer_cls = trainer_class(args.exp.get(
        "trainer_callable", "training.trainer.Trainer"))
    print(f"training on {mesh.size} device(s) ({mesh.device}), batch "
          f"{n_batch}")
    try:
        trainer = trainer_cls(args, dset, model, diff_params, device=device,
                              tester=tester, teacher=teacher, mesh=mesh)
        print(f"total params: {trainer.total_params / 1e6:.2f} M")
        total_its = args.exp.get("total_its", None)
        trainer.training_loop(
            max_its=None if total_its in (None, "None") else int(total_its))
        if bool(args.get_path("logging.save_model", True)):
            path = trainer.save_checkpoint()
            if mesh.is_main:
                print("saved final checkpoint:", path)
    finally:
        dset.close()
    return trainer


def _load_teacher(args, device):
    """The frozen PD teacher of ``diff_params.PD.teacher_checkpoint`` (a
    ``.ckpt``: its EMA, else its params, and its buffers) in a network of
    the same config on ``device``, or None when none is configured."""
    path = args.get_path("diff_params.PD.teacher_checkpoint", None)
    if path in (None, "None", ""):
        return None
    from babe_tpu_torch.setup import setup_network
    from babe_tpu_torch.testers.tester import read_checkpoint
    from babe_tpu_torch.utils.weights import load_flax

    payload = read_checkpoint(str(path))
    teacher = setup_network(args)
    load_flax(teacher.net, payload.get("ema", payload["params"]),
              payload.get("buffers", {}))
    teacher.to(device).eval().requires_grad_(False)
    print(f"loaded PD teacher from {path}")
    return teacher


def _demo_tester(args, diff_params, device):
    """The tester of the heavy-logging demos on a network of its own (the
    trainer's EMA is loaded into it at each demo), without remat, or None
    unless ``tester.do_test``."""
    if not bool(args.get_path("tester.do_test", False)):
        return None
    from babe_tpu_torch.data.datasets import setup_dataset_test
    from babe_tpu_torch.setup import setup_network
    from babe_tpu_torch.testers.tester import Tester

    test_set = None
    if args.get_path("dset.test.callable", None):
        try:
            test_set = setup_dataset_test(args)
        except (FileNotFoundError, AssertionError) as e:
            # the unconditional demo needs no test set; inpainting and
            # bwe say that it is missing
            print(f"warning: test set unavailable ({e}); the demos run "
                  "without it")
    from babe_tpu_torch.parallel.mesh import make_mesh

    net = setup_network(args)
    net.net.remat = False
    # rank 0 runs the demos alone
    return Tester(args, net, diff_params, device=device, test_set=test_set,
                  mesh=make_mesh(1, device=device))


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
