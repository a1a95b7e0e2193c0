"""Dropout in the JAX package's form, with masks from an explicit generator.

flax's nn.Dropout and horizonnet_tpu/ops/lstm.py:142-145 keep each entry
with probability 1 - rate and scale the kept ones: ``where(keep,
x / (1 - rate), 0)``. Every dropout mask of the port is drawn by
``keep_mask``, from the ``torch.Generator`` the caller passes, so a run is
reproducible from its seeds and a test can put its own masks in.

Under data parallelism (parallel/) a rank holds rows ``i`` of ``n`` equal
parts of the global batch. Every rank seeds the same generator, draws the
mask of the global batch and keeps its own rows (``shard=(i, n)``), so the
ranks together drop what one process on the whole batch drops, as JAX's
replicated dropout key does under a sharded batch.
"""

import torch


def keep_mask(shape, keep_prob, generator, device):
    """Bool tensor of ``shape`` on ``device``: True with ``keep_prob``.

    Under a captured train step (train/engine.py) ``generator`` is the
    engine's own, registered with the CUDA graph: each replay draws from
    its state, which the engine copies in from the caller's generator
    before the replay and back after it."""
    return torch.rand(shape, generator=generator, device=device) < keep_prob


def dropout(x, rate, generator, shard=None, batch_dim=0):
    """where(keep, x / (1 - rate), 0) with keep from ``keep_mask``;
    ``shard=(i, n)``: keep is rows i of n of the global batch's mask along
    ``batch_dim``."""
    if rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs a torch.Generator (train-mode "
                         "forward takes one)")
    if shard is None:
        keep = keep_mask(x.shape, 1.0 - rate, generator, x.device)
    else:
        i, n = shard
        b = x.shape[batch_dim]
        shape = list(x.shape)
        shape[batch_dim] = n * b
        keep = keep_mask(tuple(shape), 1.0 - rate, generator,
                         x.device).narrow(batch_dim, i * b, b)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
