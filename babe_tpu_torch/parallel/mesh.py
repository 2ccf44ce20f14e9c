"""Data parallelism over processes: the mesh, a rank's rows, the gather.

Counterpart of ``babe_tpu/parallel/mesh.py`` in the torch idiom: one
process per device, started by ``torchrun`` (or given its coordinator,
process count and index), joined by ``torch.distributed`` (NCCL on the
card, gloo on the CPU).  Where the JAX package places a global batch on a
mesh with ``NamedSharding`` and lets XLA insert the gradient all-reduce,
each rank here holds its own rows of the leading axis (``shard_batch``),
the trainer sums the gradients with one fp32 ``all_reduce`` and the tester
reassembles its results with ``gather_batch`` (the counterpart of an
``out_shardings`` read back with ``np.asarray``).  JAX's
``batch_sharding`` and ``replicated`` name XLA layouts: their counterparts
are a rank's ``rows`` and the initial weights broadcast from rank 0
(``broadcast_``).

Training: data parallelism over the batch axis.  Evaluation: independent
test items and OLA chunk batches spread over the ranks.  No tensor or
pipeline parallelism at this model size, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``size`` processes along ``axis``; this process is ``rank`` and
    computes on ``device``.  ``joined``: the mesh spans the process group,
    so its helpers run the collectives (also for a group of one)."""
    size: int
    rank: int
    axis: str
    device: torch.device
    joined: bool = False

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes checkpoints, logs and files."""
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of a leading axis of ``n`` (a multiple of
        ``size``)."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} "
                             f"processes")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def _env_int(name: str):
    v = os.environ.get(name, "")
    return int(v) if v.strip() else None


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device=None) -> int:
    """Join the process group, once per process, before any collective:
    from the arguments, else from torchrun's environment (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``).
    ``coordinator`` is "host:port" of rank 0.  NCCL where ``device`` (the
    card by default, when there is one) is CUDA, each process on the card
    of its local rank; gloo on the CPU.  With one process it is a no-op.
    Returns the number of processes (the global device count)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    world = (int(num_processes) if num_processes is not None
             else _env_int("WORLD_SIZE"))
    if not world or world <= 1:
        return 1
    rank = (int(process_id) if process_id is not None
            else _env_int("RANK"))
    if rank is None:
        raise ValueError("init_distributed: the process index is missing "
                         "(process_id=, or RANK as torchrun sets it)")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    cuda = torch.device(device).type == "cuda"
    if cuda:
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(rank % torch.cuda.device_count()
                              if local is None else local)
    init = f"tcp://{coordinator}" if coordinator else "env://"
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init,
                            world_size=world, rank=rank)
    return world


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(n_devices: int | None = None, axis: str = "dp",
              device=None) -> Mesh:
    """The mesh over every process of the group (``n_devices`` None), or
    over this one alone (1, no collectives).  As JAX slices its device
    list, a count above the number of processes gives all of them.
    ``device``: this process's (the card by default)."""
    size, rank = _world()
    joined = dist.is_available() and dist.is_initialized()
    if n_devices is not None:
        n = min(int(n_devices), size)
        if n == 1:
            size, rank, joined = 1, 0, False
        elif n != size:
            raise ValueError(f"a mesh of {n} of the {size} processes: take "
                             f"all of them or one")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return Mesh(size, rank, axis, torch.device(device), joined)


def mesh_for_batch(n_batch: int, n_devices: int | None = None,
                   axis: str = "dp", device=None) -> Mesh:
    """The training mesh over every process, validated against the batch.

    A batch that does not divide the process count is a hard error, not a
    silent one-process fallback (as in the JAX package)."""
    n = _world()[0] if n_devices is None else int(n_devices)
    if int(n_batch) % n != 0:
        raise ValueError(
            f"exp.batch={n_batch} is not divisible by the {n} processes, "
            f"so the batch cannot be split data-parallel. Fix one of: (a) "
            f"raise exp.batch to a multiple of {n} (optionally raising "
            f"exp.num_accumulation_rounds to keep the effective optimizer "
            f"batch), or (b) run fewer processes (torchrun "
            f"--nproc_per_node)."
        )
    return make_mesh(n, axis, device)


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of the leading axis of every leaf of ``tree`` (a
    tensor, an array, or a tuple, list or dict of them; None stays None),
    as tensors on the mesh's device."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_batch(mesh, v) for v in tree)
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    x = torch.as_tensor(tree)
    return x[mesh.rows(x.shape[0])].to(mesh.device)


def gather_batch(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The global batch from every rank's rows (in rank order), on every
    rank."""
    if not mesh.joined:
        return x
    x = x.contiguous().to(mesh.device)
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x)
    return torch.cat(parts, dim=0)


def gather_objects(mesh: Mesh, obj) -> list:
    """Every rank's ``obj`` (picklable), in rank order, on every rank."""
    if not mesh.joined:
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj)
    return out


def all_reduce_sum(mesh: Mesh, tensors) -> list[torch.Tensor]:
    """The fp32 sums over the ranks of ``tensors``, through one flat
    buffer and one ``all_reduce``; shapes and dtypes as given, each in
    memory of its own (a view into the buffer would start off the
    alignment its reductions assume, and they would sum in another
    order)."""
    tensors = list(tensors)
    if not mesh.joined or not tensors:
        return tensors
    flat = torch.cat([t.float().reshape(-1) for t in tensors]).to(
        mesh.device)
    dist.all_reduce(flat)
    out, i = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[i:i + n].view(t.shape).to(
            device=t.device, dtype=t.dtype, copy=True))
        i += n
    return out


def broadcast_(mesh: Mesh, tensors) -> None:
    """Overwrite ``tensors`` in place with rank 0's (the replicated
    weights)."""
    if not mesh.joined:
        return
    for t in tensors:
        buf = t.detach().to(mesh.device).contiguous()
        dist.broadcast(buf, 0)
        with torch.no_grad():
            t.copy_(buf)


def broadcast_object(mesh: Mesh, obj):
    """Rank 0's ``obj`` on every rank."""
    if not mesh.joined:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, 0)
    return box[0]
