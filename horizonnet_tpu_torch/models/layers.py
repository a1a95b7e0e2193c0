"""Shared layers: wrap-padded conv, batch norm, max pool (NCHW).

Counterpart of horizonnet_tpu/models/layers.py. The reference wraps every
width-padded Conv2d in ``Sequential(LR_PAD, conv)`` (model.py:27-55), which
puts a ``.1`` into those parameters' state_dict keys; WrapConv keeps that
layout, so a reference state_dict loads with ``load_state_dict``. Max
pooling keeps torch's -inf edge padding (the reference does not wrap it).

Convolutions and linears run in the dtype of their input: a parameter of
another dtype is cast per call, so a training model keeps float32
parameters and computes in bfloat16 as the JAX package's flax modules do
(``dtype`` bf16, ``param_dtype`` f32); a serving model's bf16 weights
need no cast.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.pad import wrap_pad_width


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in its input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """nn.Linear computing in its input's dtype."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose train-mode running variance takes the biased
    batch variance, as flax's nn.BatchNorm in the JAX package does
    (``ra_var`` from ``_compute_stats``), where torch takes the unbiased
    one. Normalization uses the biased variance in both. Eval mode is
    nn.BatchNorm2d's. ``momentum`` has torch's meaning: new = (1 - m) old
    + m batch.
    """

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        # the batch kernel writes the batch mean and unbiased variance into
        # zeroed scratch at momentum 1; the running update is done here
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         self.eps)
        n = x.numel() // x.shape[1]
        m = self.momentum
        with torch.no_grad():
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m * (n - 1) / n)
            self.num_batches_tracked.add_(1)
        return y


class WrapPad(nn.Module):
    """Circular pad of the width (dim 3) by ``pad`` columns each side."""

    def __init__(self, pad):
        super().__init__()
        self.pad = pad

    def forward(self, x):
        return wrap_pad_width(x, self.pad, dim=3)


class WrapConv(nn.Sequential):
    """Conv2d with zero padding on H and circular padding on W.

    The default path of the JAX WrapConv (no seam_fix): materialize the
    circular pad, then a conv with height padding only. Children are
    ``0`` (the pad) and ``1`` (the conv), as in the reference.
    """

    def __init__(self, cin, cout, kernel_size, stride=1, padding=(0, 0),
                 bias=False, groups=1):
        ph, pw = padding
        super().__init__(WrapPad(pw), Conv2d(
            cin, cout, kernel_size, stride, padding=(ph, 0), bias=bias,
            groups=groups))


def conv2d(cin, cout, kernel_size, stride=1, padding=0, bias=False,
           groups=1):
    """WrapConv when the width is padded, else a plain nn.Conv2d (the
    reference wraps only width-padded convs)."""
    if padding == 0:
        return Conv2d(cin, cout, kernel_size, stride, bias=bias,
                      groups=groups)
    return WrapConv(cin, cout, kernel_size, stride, (padding, padding), bias,
                    groups)


def max_pool_same_as_torch(x, window=3, stride=2, padding=1):
    """torch MaxPool2d(window, stride, padding): pads with -inf."""
    return F.max_pool2d(x, window, stride, padding)
