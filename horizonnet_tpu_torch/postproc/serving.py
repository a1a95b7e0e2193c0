"""Host tail of cuboid serving.

Counterpart of horizonnet_tpu/postproc/serving.py::unpack_cuboid_outputs
(numpy); the general-mode host tail is ROADMAP Queue 1 item 5.
"""

import numpy as np
import torch


def unpack_cuboid_outputs(packed):
    """Host twin of device.pack_cuboid_outputs: ONE [B, 17] float32 array
    (numpy or a tensor on any device) -> (cor_id [B, 8, 2], z1 [B]).
    Also accepts the raw (cor_id, z1) pair."""
    if isinstance(packed, (tuple, list)):
        cor_id, z1 = packed
        return _host(cor_id), _host(z1)
    packed = _host(packed).astype(np.float32)
    return packed[:, :16].reshape(-1, 8, 2), packed[:, 16]


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
