"""Shared layers: wrap-padded conv, batch norm, pooling, int8 conv (NCHW).

Counterpart of horizonnet_tpu/models/layers.py. The reference wraps every
width-padded Conv2d in ``Sequential(LR_PAD, conv)`` (model.py:27-55), which
puts a ``.1`` into those parameters' state_dict keys; WrapConv keeps that
layout, so a reference state_dict loads with ``load_state_dict``. Max
pooling keeps torch's -inf edge padding (the reference does not wrap it)
unless ``wrap_width`` asks for the seam-free pool.

Convolutions and linears run in the dtype of their input: a parameter of
another dtype is cast per call, so a training model keeps float32
parameters and computes in bfloat16 as the JAX package's flax modules do
(``dtype`` bf16, ``param_dtype`` f32); a serving model's bf16 weights
need no cast.
"""

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..ops.collectives import all_reduce_sum
from ..ops.int8_conv import int8_conv_nhwc
from ..ops.pad import seam_layout, wrap_pad_width


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in its input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """nn.Linear computing in its input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose train-mode running variance takes the biased
    batch variance, as flax's nn.BatchNorm in the JAX package does
    (``ra_var`` from ``_compute_stats``), where torch takes the unbiased
    one. Normalization uses the biased variance in both. Eval mode is
    nn.BatchNorm2d's. ``momentum`` has torch's meaning: new = (1 - m) old
    + m batch.

    ``data_group``, the data axis's process group under data parallelism
    (parallel/; None outside it), makes the train-mode
    statistics those of the global batch, as JAX's batch norm computes
    them over a batch sharded on 'data': in float32, the ranks' per-channel
    sums give the mean, then their sums of squares about it the biased
    variance, each summed by a differentiable all-reduce; the running
    update takes the global count. Two passes, where flax takes mean(x^2) -
    mean(x)^2 in one: that difference and its gradient cancel where the
    mean is large against the spread (resnet50's float32 gradients on the
    card came out 3.5e-2 from one process's over the model in one pass).
    nn.SyncBatchNorm is not used: it refuses CPU tensors and its running
    variance is the unbiased one.
    """

    data_group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.data_group is not None:
            return self._global_batch_forward(x)
        return self._batch_forward(x)

    def _global_batch_forward(self, x):
        xf = x.float()
        n = x.numel() // x.shape[1] * dist.get_world_size(self.data_group)
        mean = all_reduce_sum(xf.sum((0, 2, 3)), self.data_group) / n
        xc = xf - mean[:, None, None]
        var = all_reduce_sum((xc * xc).sum((0, 2, 3)), self.data_group) / n
        y = (xc * (self.weight * torch.rsqrt(var + self.eps))[:, None, None]
             + self.bias[:, None, None])
        m = self.momentum
        with torch.no_grad():
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)

    def _batch_forward(self, x):
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

    Children are ``0`` (the pad) and ``1`` (the conv), as in the
    reference. The default materializes the circular pad, then runs a
    conv with height padding only. ``seam_fix=True`` runs the conv with
    zero width padding instead and recomputes only the output columns
    whose window crosses the seam (1-2 an edge) from the
    ``(a + b)``-column wrapped strip of ops/pad.py::seam_layout, written
    back in place: the same products, so the same result, without a
    padded copy of the input. Where seam_layout returns None it takes
    the materialized pad, as the JAX WrapConv does.
    """

    def __init__(self, cin, cout, kernel_size, stride=1, padding=(0, 0),
                 bias=False, groups=1, seam_fix=False):
        ph, pw = padding
        super().__init__(WrapPad(pw), Conv2d(
            cin, cout, kernel_size, stride, padding=(ph, 0), bias=bias,
            groups=groups))
        self.seam_fix = seam_fix

    def forward(self, x):
        pad, conv = self[0], self[1]
        W = x.shape[3]
        layout = (seam_layout(W, conv.kernel_size[1], conv.stride[1],
                              pad.pad) if self.seam_fix else None)
        if layout is None:
            return conv(pad(x))
        n_left, n_right, a, b = layout
        weight = conv.weight.to(x.dtype)
        bias = None if conv.bias is None else conv.bias.to(x.dtype)
        ph = conv.padding[0]
        y = F.conv2d(x, weight, bias, conv.stride, (ph, pad.pad), 1,
                     conv.groups)
        strip = torch.cat([x[..., W - a:], x[..., :b]], dim=3)
        ys = F.conv2d(strip, weight, bias, conv.stride, (ph, 0), 1,
                      conv.groups)
        y[..., :n_left] = ys[..., n_right:]
        if n_right:
            y[..., y.shape[3] - n_right:] = ys[..., :n_right]
        return y


class QuantConvBN(nn.Module):
    """Serving-only int8 conv with its batch norm folded in (the JAX
    QuantConvBN, horizonnet_tpu/models/layers.py:113-160).

    Buffers, made by models/quant.py::quantize_state_dict from a float
    state_dict and never trained: ``weight_q`` int8 [out, in/groups, kh,
    kw], symmetric per output channel; ``scale`` f32 [out], the
    per-channel weight step with the BN gamma/sigma folded in; ``bias``
    f32 [out], the folded BN shift. The activation is quantized per
    tensor with a dynamic max-abs scale over the whole batch (so a
    pano's result depends on its batch mates, as in JAX), rounded half
    to even and clipped to +-127; the product accumulates int8 x int8 in
    int32 (ops/int8_conv.py), and the result is dequantized and biased in
    float32, then cast to the input's dtype. Padding as WrapConv: wrap
    on W, zeros on H, applied to the int8 tensor.
    """

    def __init__(self, cin, cout, kernel_size, stride=1, padding=(0, 0),
                 groups=1):
        super().__init__()
        self.stride = (stride, stride)
        self.padding = tuple(padding)
        self.groups = groups
        self.register_buffer("weight_q", torch.zeros(
            cout, cin // groups, kernel_size, kernel_size, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(cout))
        self.register_buffer("bias", torch.zeros(cout))

    @torch.no_grad()
    def reset_parameters(self):
        """The JAX module's init: a zero kernel, unit scale, zero bias."""
        self.weight_q.zero_()
        self.scale.fill_(1.0)
        self.bias.zero_()

    @staticmethod
    def quantize(x):
        """NCHW float x -> (int8 NHWC, the f32 scale sx): x / sx rounded
        half to even, clipped to +-127, sx = max(max|x|, 1e-6) / 127."""
        xf = x.float()
        sx = xf.abs().amax().clamp(min=1e-6) / 127.0
        xq = torch.round(xf / sx).clamp_(-127, 127).to(torch.int8)
        return xq.permute(0, 2, 3, 1), sx

    def accumulate(self, xq):
        """int8 NHWC -> the int32 sums [B, Ho, Wo, out]."""
        return int8_conv_nhwc(xq, self.weight_q, self.stride, self.padding,
                              self.groups)

    def forward(self, x):
        xq, sx = self.quantize(x)
        out = self.accumulate(xq).float() * (self.scale * sx) + self.bias
        return out.to(x.dtype).permute(0, 3, 1, 2)


def conv2d(cin, cout, kernel_size, stride=1, padding=0, bias=False,
           groups=1):
    """WrapConv when the width is padded, else a plain nn.Conv2d (the
    reference wraps only width-padded convs)."""
    if padding == 0:
        return Conv2d(cin, cout, kernel_size, stride, bias=bias,
                      groups=groups)
    return WrapConv(cin, cout, kernel_size, stride, (padding, padding), bias,
                    groups)


def max_pool_same_as_torch(x, window=3, stride=2, padding=1,
                           wrap_width=False):
    """torch MaxPool2d(window, stride, padding): pads with -inf.
    ``wrap_width`` wrap-pads the width instead, making the pool seam-free
    (HorizonNet(seam_pool=True)); the height keeps the -inf padding."""
    if wrap_width:
        return F.max_pool2d(wrap_pad_width(x, padding, dim=3), window,
                            stride, (padding, 0))
    return F.max_pool2d(x, window, stride, padding)


def avg_pool_2x2(x):
    """torch AvgPool2d(2, 2) (the DenseNet transition layers), summed in
    the JAX package's order, the two rows' pairs first, so that it equals
    JAX's reduce_window bit for bit."""
    x = x[:, :, :x.shape[2] // 2 * 2, :x.shape[3] // 2 * 2]
    top = x[:, :, 0::2, 0::2] + x[:, :, 0::2, 1::2]
    return (top + (x[:, :, 1::2, 0::2] + x[:, :, 1::2, 1::2])) / 4.0
