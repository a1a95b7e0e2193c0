"""Training engine: one train step per call, on one device or a mesh.

Counterpart of horizonnet_tpu/train/engine.py. The JAX engine compiles the
step ahead of time, with the state donated to it and the learning rate
evaluated on the device from the step count. Here, on a CUDA device
without a mesh, the engine captures the whole step (forward with dropout,
losses, backward through K3, the optimizer update and the batch-norm
statistics) once as a CUDA graph (program.py) and replays it each step;
the optimizer's count and learning rate live on the device
(train/step.py). The model names its targets and their shapes
(``TARGETS``, ``target_shapes``): HorizonNet's boundary and corner maps,
LGT-Net's horizon depths and ratio (models/lgt.py). Host batches go up
through pinned staging on a copy stream, device tensors (the
augmentation's output) by a device-to-device copy. ``step`` queues the
step and returns its metrics as device tensors without waiting, so the
host builds the next batch while the device trains. On the CPU and under a mesh the same step runs eagerly.

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
from ..program import CapturedProgram, UploadRing, engine_device
from .step import train_step


class TrainEngine:
    """``model`` is the model of ``state`` (train/step.py::TrainState);
    both move to ``device``. ``batch_size`` is the global batch; under a
    mesh each rank steps on its rows, batch_size / n_data of them. Under a
    mesh, give the whole model: the engine shards it in place.

    ``graph``: on a CUDA device without a mesh (the default, True) the
    step is captured here, after a warm-up whose writes to the state are
    undone (program.py::CapturedProgram); a capture that fails raises.
    ``graph=False`` steps eagerly, as the CPU and a mesh always do. The
    capture holds the addresses of the parameters, statistics and moments:
    change them only in place (train/checkpoint.py::load_checkpoint
    does)."""

    def __init__(self, model, state, batch_size, H=512, W=1024,
                 device="cuda", mesh=None, graph=True):
        if state.model is not model:
            raise ValueError("state.model must be the engine's model")
        self.device = engine_device(resolve_device(device))
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
        self.batch_size = B = batch_size
        #: the model's targets, in the order ``step`` takes them
        self.targets = model.TARGETS
        self.metrics = model.METRICS
        self._shapes = {"x": (B, H, W, 3), **model.target_shapes(B, W)}
        # two slots: the step in flight reads one while the next uploads
        self._rings = {k: UploadRing(v, torch.float32, self.device, 2)
                       for k, v in self._shapes.items()}
        self.program = None
        if graph and self.device.type == "cuda" and mesh is None:
            self._static = {k: torch.zeros(v, device=self.device)
                            for k, v in self._shapes.items()}
            self._gen = torch.Generator(device=self.device)
            m = self.model
            self.program = CapturedProgram(
                lambda: train_step(self.state, self._static["x"],
                                   *[self._static[k] for k in self.targets],
                                   self._gen),
                self.device,
                keep=[*m.parameters(), *m.buffers(),
                      *state.opt.state_tensors()],
                generator=self._gen)

    def _batch(self, batch):
        """{name: array or tensor} -> {name: (device tensor or Upload)}:
        tensors on the engine's device as they are, anything else up
        through the ring."""
        out = {}
        for k, a in batch.items():
            shape = self._shapes[k]
            if isinstance(a, torch.Tensor) and a.device == self.device:
                t = a.float()
            else:
                t = np.asarray(a, np.float32)
            if tuple(t.shape) != shape:
                raise ValueError(f"{k} shape {tuple(t.shape)} != engine's "
                                 f"{shape}")
            out[k] = (self._rings[k].put(t) if isinstance(t, np.ndarray)
                      else t)
        return out

    def step(self, x, *args):
        """One training step, ``step(x, *targets, generator)``; returns
        the model's METRICS ({"total", "bon", "cor"} for HorizonNet) as
        device tensors (under a captured step, copies that the next step
        leaves alone). ``x`` [B, H, W, 3] in [0, 1], a host array or a
        device tensor (e.g. the output of data/augment.py); the targets in
        the model's TARGETS order (y_bon, y_cor for HorizonNet; y_depth,
        y_ratio for LGT-Net), host arrays or device tensors;
        ``generator`` a torch.Generator on the engine's device for the
        dropout masks, which the step advances. Under a mesh B is this
        rank's rows, every rank seeds ``generator`` alike, and the losses
        are the global batch's means."""
        *targets, generator = args
        if not isinstance(generator, torch.Generator):
            raise ValueError("the train step needs a torch.Generator for "
                             "its dropout masks")
        if len(targets) != len(self.targets):
            raise ValueError(f"the model's targets are {self.targets}; "
                             f"{len(targets)} given")
        batch = self._batch({"x": x, **dict(zip(self.targets, targets))})
        ups = {k: v for k, v in batch.items() if not torch.is_tensor(v)}
        t = {k: self._rings[k].take(v) if k in ups else v
             for k, v in batch.items()}
        try:
            if self.program is not None:
                for k, v in t.items():
                    self._static[k].copy_(v)
            else:
                m = train_step(self.state, t["x"],
                               *[t[k] for k in self.targets], generator,
                               net=self.net, batch_shard=self.batch_shard)
        finally:
            for k, up in ups.items():
                self._rings[k].release(up)
        if self.program is not None:
            return self._replay(generator)
        if self.mesh is None or self.mesh.n_data == 1:
            return m
        losses = torch.stack([m[k] for k in self.metrics])
        dist.all_reduce(losses, group=self.mesh.data_group)
        losses /= self.mesh.n_data
        return dict(zip(self.metrics, losses.unbind()))

    def _replay(self, generator):
        """The captured step, drawing its dropout masks from
        ``generator``'s state and advancing it as the eager step would."""
        if engine_device(generator.device) != self.device:
            raise ValueError(f"generator on {generator.device}, engine on "
                             f"{self.device}")
        self._gen.set_state(generator.get_state())
        out = self.program.replay()
        generator.set_state(self._gen.get_state())
        return {k: out[k].clone() for k in self.metrics}

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
