"""One process of the port's data-parallel runs on the CPU (gloo), for
``tests/test_torch_mesh.py``.  Imports torch and the port only.

    python tests/torch_mesh_worker.py JOB RANK WORLD PORT DIR

JOB is ``train`` (two training steps of the tiny network at batch 4, the
batch's draws from the trainer's generator) or ``bwe`` (informed BWE over
the two items of ``DIR/items.pkl`` through ``Tester.dodajob``).  Both start
from the weights in ``DIR/weights.pkl`` (the JAX package's layout, through
``utils/weights.py``) and the config overrides in ``DIR/overrides.pkl``.
Rank 0 writes ``DIR/out_<JOB>_<WORLD>.pkl``.  With WORLD 1 it runs alone,
without a process group.
"""

from __future__ import annotations

import os
import pickle
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from babe_tpu_torch.config import default_config  # noqa: E402
from babe_tpu_torch.diffusion.edm import EDM  # noqa: E402
from babe_tpu_torch.models.cqtdiff import CQTDiffPlus  # noqa: E402
from babe_tpu_torch.parallel import mesh as M  # noqa: E402
from babe_tpu_torch.utils.weights import load_flax  # noqa: E402


class Items:
    """Test items (audio, fs, name) from a list."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def train(args, w, mesh, d):
    from babe_tpu_torch.training.trainer import Trainer

    model = CQTDiffPlus.from_config(args)
    edm = EDM.from_config(args, cqt_hpf=model.apply_hpf_DC)
    tr = Trainer(args, None, model, edm, device="cpu", mesh=mesh)
    load_flax(tr.net, w["params"], w["buffers"])
    for k, p in tr.params.items():
        tr.ema[k].copy_(p.detach())
    x = _load(os.path.join(d, "batch.pkl"))
    losses = [float(tr.train_step(x)["loss"]) for _ in range(2)]
    return {"loss": losses,
            "params": {k: p.detach().numpy().copy()
                       for k, p in tr.params.items()},
            "ema": {k: v.numpy().copy() for k, v in tr.ema.items()}}


def bwe(args, w, mesh, d):
    from babe_tpu_torch.testers.tester import Tester

    model = CQTDiffPlus.from_config(args)
    edm = EDM.from_config(args, cqt_hpf=model.apply_hpf_DC)
    t = Tester(args, model, edm, device="cpu",
               test_set=Items(_load(os.path.join(d, "items.pkl"))),
               mesh=mesh)
    t.set_variables(w["params"], w["buffers"])
    return {"bwe": t.dodajob()["bwe"]}


def main(job, rank, world, port, d):
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    if world > 1:
        M.init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    mesh = M.make_mesh(device="cpu")
    assert (mesh.size, mesh.rank) == (world, rank)
    args = default_config(_load(os.path.join(d, "overrides.pkl"))
                          + [f"model_dir={os.path.join(d, f'w{world}')}"])
    w = _load(os.path.join(d, "weights.pkl"))
    out = {"train": train, "bwe": bwe}[job](args, w, mesh, d)
    if mesh.is_main:
        with open(os.path.join(d, f"out_{job}_{world}.pkl"), "wb") as f:
            pickle.dump(out, f)
    if world > 1:
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
