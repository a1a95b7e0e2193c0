"""A ('data', 'model') mesh of process groups, one process per rank.

Counterpart of horizonnet_tpu/parallel/mesh.py. JAX runs one SPMD program
over a device mesh and GSPMD inserts the collectives; here each rank is a
process (started by ``torchrun`` or by parallel/dryrun.py::run_ranks)
that holds its own rows of the batch and, under tensor parallelism, its
own slices of the encoder's channels (parallel/sharding.py), and the
collectives are written out: DistributedDataParallel's gradient
all-reduce over 'data', the batch-norm statistics over 'data'
(models/layers.py::BatchNorm2d), and the channel gather and the sum of
the input gradients of the sharded convs over 'model'
(ops/collectives.py).

Ranks are laid out as JAX reshapes its devices: rank = d * n_model + m
for data index d and model index m, so a model group is n_model
consecutive ranks. JAX's ``data_sharding`` and ``replicated`` build
NamedShardings, placements that GSPMD reads; they have no PyTorch object.
Their work is ``shard_batch`` (a rank's rows) and the replicated
parameters that DistributedDataParallel keeps equal.

Batch norm under this layout computes global batch statistics, as JAX's
does (sync-BN; the reference's DataParallel computes them per replica,
the documented deviation of the JAX package).
"""

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

# A collective that waits this long fails, so a rank that died or never
# joined ends the run instead of stalling it
TIMEOUT = timedelta(seconds=300)


def init_distributed(device="cuda", init_method="env://"):
    """Join the process group of this rank and return its torch.device.

    Reads torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` (``init_method`` env:// also its
    ``MASTER_ADDR``/``MASTER_PORT``). ``device`` gives the type: on "cuda"
    the rank's device is ``cuda:{LOCAL_RANK % device_count}`` and a
    missing CUDA device raises; "cpu" only when asked. The backend
    follows one rule: NCCL when each local rank has a CUDA device of its
    own, gloo when local ranks share one (NCCL refuses two ranks on one
    device) or run on the CPU. Rank 0 prints the choice. A process that
    already joined keeps its group, which must have that backend."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda requested but CUDA is not "
                               "available")
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
        if local_world <= n_cards:
            backend, why = "nccl", f"{local_world} local ranks on " \
                                   f"{n_cards} CUDA devices, one each"
        else:
            backend, why = "gloo", f"{local_world} local ranks share " \
                                   f"{n_cards} CUDA device(s)"
    elif dev.type == "cpu":
        backend, why = "gloo", "CPU ranks"
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"process group runs {dist.get_backend()}, "
                               f"this rank's device needs {backend}")
        return dev
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    if rank == 0:
        print(f"[dist] {world} ranks, backend {backend}: {why}", flush=True)
    return dev


@dataclass(frozen=True)
class Mesh:
    """This rank's place in an (n_data, n_model) mesh and its two groups:
    ``data_group`` holds the ranks with its model index (they hold the
    same channel slices and reduce gradients and statistics together),
    ``model_group`` the ranks with its data index (they hold the same
    rows and gather channels)."""

    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    data_group: object
    model_group: object

    @property
    def shape(self):
        return {"data": self.n_data, "model": self.n_model}

    @property
    def batch_shard(self):
        """(i, n): this rank holds rows i of n of the global batch."""
        return self.data_rank, self.n_data


def make_mesh(n_data: Optional[int] = None,
              n_model: int = 1) -> Optional[Mesh]:
    """Build the two axes over the ranks of the process group, JAX's
    argument rules: ``n_data`` defaults to world / n_model (which must
    divide), and n_data * n_model must fit the world. Every rank calls
    it; a rank past the mesh's n_data * n_model gets None."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        if world % n_model:
            raise ValueError(f"n_model {n_model} does not divide the "
                             f"{world} ranks")
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > world:
        raise ValueError(f"mesh ({n_data} data, {n_model} model) does not "
                         f"fit {world} ranks")
    mine = None
    # every rank creates every group, in the same order (new_group is
    # collective)
    for m in range(n_model):
        ranks = [d * n_model + m for d in range(n_data)]
        g = dist.new_group(ranks)
        if rank in ranks:
            mine = {"data_group": g, "model_rank": m,
                    "data_rank": ranks.index(rank)}
    for d in range(n_data):
        ranks = [d * n_model + m for m in range(n_model)]
        g = dist.new_group(ranks)
        if rank in ranks:
            mine["model_group"] = g
    if mine is None:
        return None
    return Mesh(n_data, n_model, **mine)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a global batch: each [B, ...] array or tensor
    of ``batch`` (a tuple or list) cut into n_data equal parts."""
    i, n = mesh.batch_shard
    out = []
    for a in batch:
        if a.shape[0] % n:
            raise ValueError(f"batch of {a.shape[0]} does not split over "
                             f"{n} data ranks")
        b = a.shape[0] // n
        out.append(a[i * b:(i + 1) * b])
    return type(batch)(out)
