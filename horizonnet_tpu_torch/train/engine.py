"""Training engine: one train step per call on one device.

Counterpart of horizonnet_tpu/train/engine.py. The JAX engine compiles the
step ahead of time and lays the state out in the executable's formats;
here PyTorch runs the step eagerly, so the engine holds the state on its
device, uploads host batches and checks their shapes. ``step`` queues the
whole step and returns its metrics as device tensors without waiting, so
the host can build the next batch while the device trains.
"""

import numpy as np
import torch

from ..inference import resolve_device
from .step import train_step


class TrainEngine:
    """``model`` is the model of ``state`` (train/step.py::TrainState);
    both move to ``device``. A mesh (data or tensor parallelism) is
    ROADMAP Queue 1 item 9."""

    def __init__(self, model, state, batch_size, H=512, W=1024,
                 device="cuda", mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "multi-device training (a mesh, --n_model > 1) is ROADMAP "
                "Queue 1 item 9")
        if state.model is not model:
            raise ValueError("state.model must be the engine's model")
        self.device = resolve_device(device)
        self.state = state.to(self.device)
        self.model = model
        self.batch_size, self.H, self.W = batch_size, H, W

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
        torch.Generator on the engine's device for the dropout masks."""
        B, H, W = self.batch_size, self.H, self.W
        x = self._put(x, (B, H, W, 3), "x")
        y_bon = self._put(y_bon, (B, 2, W), "y_bon")
        y_cor = self._put(y_cor, (B, 1, W), "y_cor")
        return train_step(self.state, x, y_bon, y_cor, generator)

    def host_state(self):
        """The state on the host, for checkpointing (TrainState.host)."""
        return self.state.host()
