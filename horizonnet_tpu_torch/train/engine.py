"""Training engine: one train step per call, on one device or a mesh.

Counterpart of horizonnet_tpu/train/engine.py. The JAX engine compiles the
step ahead of time and lays the state out in the executable's formats;
here PyTorch runs the step eagerly, so the engine holds the state on its
device, uploads host batches and checks their shapes. ``step`` queues the
whole step and returns its metrics as device tensors without waiting, so
the host can build the next batch while the device trains.

With a ``mesh`` (parallel/mesh.py) the engine is this rank's part of a
multi-process step, as the JAX engine's sharded step is: the encoder's
and height stage's conv + batch-norm units keep this rank's channel
slices (parallel/sharding.py), DistributedDataParallel averages the
gradients over the data group, batch norm takes the global batch's
statistics, the dropout masks are the global batch's rows, and the
returned losses are the global batch's means. So a step at any layout is
the single-process step on the whole batch, up to the order of the sums.
"""

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from ..inference import resolve_device
from ..models.layers import BatchNorm2d
from ..parallel.sharding import gather_state, shard_state
from .step import train_step


class TrainEngine:
    """``model`` is the model of ``state`` (train/step.py::TrainState);
    both move to ``device``. ``batch_size`` is the global batch; under a
    mesh each rank steps on its rows, batch_size / n_data of them. Under a
    mesh, give the whole model: the engine shards it in place."""

    def __init__(self, model, state, batch_size, H=512, W=1024,
                 device="cuda", mesh=None):
        if state.model is not model:
            raise ValueError("state.model must be the engine's model")
        self.device = resolve_device(device)
        self.model = model
        self.mesh = mesh
        self.H, self.W = H, W
        self.net, self.batch_shard, self.sharded = None, None, frozenset()
        if mesh is not None:
            if batch_size % mesh.n_data:
                raise ValueError(f"batch of {batch_size} does not split "
                                 f"over {mesh.n_data} data ranks")
            batch_size //= mesh.n_data
            self.batch_shard = mesh.batch_shard
            self.sharded = shard_state(mesh, state)
            if mesh.n_data > 1:
                for m in model.modules():
                    if isinstance(m, BatchNorm2d):
                        m.data_group = mesh.data_group
        self.state = state.to(self.device)
        if mesh is not None:
            self.net = DistributedDataParallel(
                model, process_group=mesh.data_group)
        self.batch_size = batch_size

    def _put(self, a, shape, name):
        if isinstance(a, torch.Tensor):
            t = a.to(self.device, torch.float32)
        else:
            t = torch.from_numpy(np.asarray(a, np.float32)).to(self.device)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != engine's "
                             f"{shape}")
        return t

    def step(self, x, y_bon, y_cor, generator):
        """One training step; returns {"total", "bon", "cor"} as device
        tensors. ``x`` [B, H, W, 3] in [0, 1], a host array or a device
        tensor (e.g. the output of data/augment.py); ``generator`` a
        torch.Generator on the engine's device for the dropout masks. Under
        a mesh B is this rank's rows, every rank seeds ``generator`` alike,
        and the losses are the global batch's means."""
        B, H, W = self.batch_size, self.H, self.W
        x = self._put(x, (B, H, W, 3), "x")
        y_bon = self._put(y_bon, (B, 2, W), "y_bon")
        y_cor = self._put(y_cor, (B, 1, W), "y_cor")
        m = train_step(self.state, x, y_bon, y_cor, generator, self.net,
                       self.batch_shard)
        if self.mesh is None or self.mesh.n_data == 1:
            return m
        losses = torch.stack([m["total"], m["bon"], m["cor"]])
        dist.all_reduce(losses, group=self.mesh.data_group)
        losses /= self.mesh.n_data
        return dict(zip(("total", "bon", "cor"), losses.unbind()))

    def full(self, tensors):
        """{name: this rank's tensor} -> the whole tensors (the channel
        shards gathered over the model group; collective under a mesh)."""
        if not self.sharded:
            return dict(tensors)
        return gather_state(self.mesh, tensors, self.sharded)

    def host_state(self):
        """The state on the host, for checkpointing (TrainState.host): the
        whole model and moments, gathered from every model rank under a
        mesh (every rank must call it)."""
        return self.state.host(self.full)
