"""Differentiable collectives of the multi-process layout (parallel/).

``all_reduce_sum`` sums a tensor over a process group; its backward sums
the gradients the same way (models/layers.py::BatchNorm2d's statistics
over the data group).

The tensor-parallel conv unit (parallel/sharding.py) uses the other two,
over the model group. A conv that holds the rank's slice of the output
channels sees its whole input, but its backward gives only that slice's
part of the input's gradient: ``sum_input_grads`` (identity forward) sums
the parts in its backward, before the gradient meets the replicated
paths. ``gather_channels`` concatenates the ranks' channel slices of the
unit's output; its backward returns the rank's own slice of the gradient
and sends nothing, since every model rank then holds the same whole
gradient of the gathered tensor. (``torch.distributed.nn.functional.
all_gather`` sums that gradient over the ranks, n_model times too much
for the replicated paths.) This is Megatron's column-parallel pair with
the output gathered.

Gathers use the list form of ``dist.all_gather``, which every PyTorch
release in use has (``all_gather_into_tensor`` warns as deprecated in
newer ones).
"""

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x, group):
    """Sum of ``x`` over ``group``, differentiable."""
    return _AllReduceSum.apply(x, group)


class _SumInputGrads(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # summed in float32, as one process accumulates the whole gradient
        s = g.to(torch.float32, memory_format=torch.contiguous_format,
                 copy=True)
        dist.all_reduce(s, group=ctx.group)
        return s.to(g.dtype), None


def sum_input_grads(x, group):
    """x, whose gradient is summed over ``group`` (in float32) in the
    backward."""
    return _SumInputGrads.apply(x, group)


class _GatherChannels(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        c = x.shape[1]
        ctx.channels = (r * c, (r + 1) * c)
        # NHWC is contiguous for a channels_last x: no copy before the send
        local = x.permute(0, 2, 3, 1).contiguous()
        parts = [torch.empty_like(local) for _ in range(n)]
        dist.all_gather(parts, local, group=group)
        # the cat makes a new channels_last tensor, not a view: a view
        # returned by a custom Function may not be modified in place, and
        # the height stage's ReLU is in place
        return torch.cat([p.permute(0, 3, 1, 2) for p in parts], dim=1)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.channels
        return g[:, lo:hi], None


def gather_channels(x, group):
    """[B, c, H, W] on each rank of ``group`` -> [B, n c, H, W], the ranks'
    slices in rank order, differentiable."""
    return _GatherChannels.apply(x, group)
