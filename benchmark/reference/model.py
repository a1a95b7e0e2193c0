"""Plain float32 HorizonNet: the benchmark's reference forward.

The published architecture (sunset1995/HorizonNet, model.py): ImageNet
normalization, a resnet50 encoder whose width-padded convolutions wrap
around the panorama's seam, four height-compression stacks (conv k3
stride (2, 1) + batch norm + ReLU, four times, then a seam-free bilinear
resize of the width to W/4), a 2-layer bidirectional LSTM of hidden size
512 over the W/4 columns and a linear head to 3 x 4 values a column.
Returns (bon [B, 2, W], cor logits [B, 1, W]) in float32.

Plain torch operations only: convolutions, batch norm, ``F.interpolate``
and an LSTM written as its per-step products, so that a FLOP counter sees
every step and no library recurrence stands in. Module names give the
published checkpoints' state_dict keys. Nothing here imports the
program under test.

``set_lowp(model, fn)`` rounds the operands of every product (each
convolution, linear and LSTM product, input and weight) through ``fn``
before it runs, with float32 accumulation: ``fp8`` makes the reference
compute its products in float8 e4m3, the control that the benchmark holds
its comparisons against. Batch norm and the cell's nonlinearities stay in
float32.

Departure from the published model: none in the forward. In train mode
the two dropouts (between the LSTM layers and after the LSTM) take their
keep masks from a ``torch.Generator``, drawn as ``rand(shape) < 0.5`` in
that order, so a caller can draw the same masks another implementation
drew from the same generator state.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
STEP_COLS = 4
RNN_HIDDEN = 512
DROPOUT = 0.5
#: resnet50: (planes, blocks, stride) of each stage
RESNET50_STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))


def fp8(t):
    """``t`` rounded to float8 e4m3 with one scale for the whole tensor
    (its largest magnitude to 448, e4m3's largest), back in float32. The
    gradient passes the rounding unchanged."""
    with torch.no_grad():
        s = t.abs().amax().clamp(min=1e-30) / 448.0
        q = (t / s).to(torch.float8_e4m3fn).float() * s
    return t + (q - t).detach() if t.requires_grad else q


def _same(t):
    return t


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose operands go through ``lowp`` first."""

    lowp = staticmethod(_same)

    def forward(self, x):
        return self._conv_forward(self.lowp(x), self.lowp(self.weight),
                                  self.bias)


class Linear(nn.Linear):
    """nn.Linear whose operands go through ``lowp`` first."""

    lowp = staticmethod(_same)

    def forward(self, x):
        return F.linear(self.lowp(x), self.lowp(self.weight), self.bias)


def set_lowp(model, fn=None):
    """Round every product's operands of ``model`` through ``fn`` (None:
    compute in float32 as published)."""
    for m in model.modules():
        if isinstance(m, (Conv2d, Linear, LSTM)):
            m.lowp = fn or _same


class LRPad(nn.Module):
    """Circular pad of the width by ``pad`` columns each side."""

    def __init__(self, pad):
        super().__init__()
        self.pad = pad

    def forward(self, x):
        p = self.pad
        return torch.cat([x[..., -p:], x, x[..., :p]], dim=3)


def wrap_conv(cin, cout, k, stride=1, bias=False):
    """Conv with wrap padding on the width and zeros on the height; the
    Sequential puts the published ``.1`` into the conv's keys."""
    return nn.Sequential(LRPad(k // 2), Conv2d(
        cin, cout, k, stride=stride, padding=(k // 2, 0), bias=bias))


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = wrap_conv(planes, planes, 3, stride)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = None
        if stride != 1 or cin != planes * 4:
            self.downsample = nn.Sequential(
                Conv2d(cin, planes * 4, 1, stride=stride, bias=False),
                nn.BatchNorm2d(planes * 4))

    def forward(self, x):
        idn = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + idn)


class ResNet50(nn.Module):
    """torchvision's resnet50 (v1.5) with wrap-padded width, no head."""

    def __init__(self):
        super().__init__()
        self.conv1 = wrap_conv(3, 64, 7, 2)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for i, (planes, n, stride) in enumerate(RESNET50_STAGES):
            blocks = []
            for b in range(n):
                blocks.append(Bottleneck(cin, planes, stride if b == 0
                                         else 1))
                cin = planes * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        feats = []
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            feats.append(x)
        return feats


class ConvCompressH(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.layers = nn.Sequential(wrap_conv(cin, cout, 3, (2, 1), True),
                                    nn.BatchNorm2d(cout), nn.ReLU())

    def forward(self, x):
        return self.layers(x)


class GlobalHeightConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        sizes = (cin, cin // 2, cin // 2, cin // 4, cout)
        self.layer = nn.Sequential(*[ConvCompressH(sizes[j], sizes[j + 1])
                                     for j in range(4)])

    def forward(self, x, out_w):
        x = self.layer(x)
        factor = out_w // x.shape[3]
        x = torch.cat([x[..., -1:], x, x[..., :1]], 3)
        x = F.interpolate(x, size=(x.shape[2], out_w + 2 * factor),
                          mode="bilinear", align_corners=False)
        return x[..., factor:-factor]


class LSTM(nn.Module):
    """Bidirectional multi-layer LSTM under nn.LSTM's parameter names,
    computed step by step: gates = x W_ih^T + b_ih + b_hh + h W_hh^T,
    order i, f, g, o, zero initial state."""

    lowp = staticmethod(_same)

    def __init__(self, input_size, hidden, layers):
        super().__init__()
        self.hidden, self.layers = hidden, layers
        for l in range(layers):
            cin = input_size if l == 0 else 2 * hidden
            for sfx in ("", "_reverse"):
                self.register_parameter(f"weight_ih_l{l}{sfx}", nn.Parameter(
                    torch.empty(4 * hidden, cin)))
                self.register_parameter(f"weight_hh_l{l}{sfx}", nn.Parameter(
                    torch.empty(4 * hidden, hidden)))
                self.register_parameter(f"bias_ih_l{l}{sfx}", nn.Parameter(
                    torch.empty(4 * hidden)))
                self.register_parameter(f"bias_hh_l{l}{sfx}", nn.Parameter(
                    torch.empty(4 * hidden)))

    def _layer(self, x, l):
        """x [T, B, I] -> [T, B, 2H]."""
        H = self.hidden
        p = lambda n: [getattr(self, f"{n}_l{l}{s}")  # noqa: E731
                       for s in ("", "_reverse")]
        w_ih = torch.stack(p("weight_ih"))                      # [2, 4H, I]
        b = torch.stack(p("bias_ih")) + torch.stack(p("bias_hh"))
        w_hh_t = torch.stack(p("weight_hh")).transpose(1, 2)    # [2, H, 4H]
        xs = torch.stack([x, x.flip(0)], 1)                     # [T, 2, B, I]
        q = self.lowp
        xw = torch.matmul(q(xs), q(w_ih).transpose(1, 2)[None]) \
            + b[None, :, None]
        w_hh_t = q(w_hh_t)
        T, _, B, _ = xw.shape
        h = x.new_zeros(2, B, H)
        c = x.new_zeros(2, B, H)
        ys = []
        for t in range(T):
            g = xw[t] + torch.bmm(q(h), w_hh_t)
            i, f, gg, o = g.split(H, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
            ys.append(h)
        ys = torch.stack(ys)                                    # [T, 2, B, H]
        return torch.cat([ys[:, 0], ys[:, 1].flip(0)], -1)

    def forward(self, x, generator=None):
        for l in range(self.layers):
            x = self._layer(x, l)
            if l < self.layers - 1:
                x = dropout(x, self.training, generator)
        return x


def dropout(x, training, generator):
    """Dropout at 0.5 with the keep mask ``rand < 0.5`` from
    ``generator``; the identity in eval mode."""
    if not training:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - DROPOUT
    return torch.where(keep, x / (1.0 - DROPOUT), torch.zeros_like(x))


class _Encoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = ResNet50()


class _Height(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.ghc_lst = nn.ModuleList([GlobalHeightConv(c, c // 8)
                                      for c in channels])


class HorizonNet(nn.Module):
    """resnet50_rnn. ``forward(x [B, 3, H, W] in [0, 1])`` -> (bon, cor)."""

    CHANNELS = (256, 512, 1024, 2048)

    def __init__(self):
        super().__init__()
        self.feature_extractor = _Encoder()
        self.reduce_height_module = _Height(self.CHANNELS)
        c1, c2, c3, c4 = self.CHANNELS
        c_last = (c1 * 8 + c2 * 4 + c3 * 2 + c4) // 8
        self.bi_rnn = LSTM(c_last, RNN_HIDDEN, 2)
        self.linear = Linear(2 * RNN_HIDDEN, 3 * STEP_COLS)
        self.register_buffer("x_mean", torch.tensor(IMAGENET_MEAN).view(
            1, 3, 1, 1), persistent=False)
        self.register_buffer("x_std", torch.tensor(IMAGENET_STD).view(
            1, 3, 1, 1), persistent=False)

    def forward(self, x, generator=None):
        B, _, _, W = x.shape
        x = (x - self.x_mean) / self.x_std
        feats = self.feature_extractor.encoder(x)
        out_w = W // STEP_COLS
        feature = torch.cat(
            [g(f, out_w).reshape(B, -1, out_w) for g, f in
             zip(self.reduce_height_module.ghc_lst, feats)], 1)
        seq = self.bi_rnn(feature.permute(2, 0, 1), generator)
        seq = dropout(seq, self.training, generator)
        out = self.linear(seq)                                  # [T, B, 12]
        out = out.view(out_w, B, 3, STEP_COLS).permute(1, 2, 0, 3)
        out = out.reshape(B, 3, W)
        return out[:, 1:], out[:, :1]


def build(state_dict, device):
    """The reference on ``device`` in float32 and eval mode, holding
    ``state_dict`` (cast to float32)."""
    with torch.device("meta"):
        m = HorizonNet()
    m = m.to_empty(device=device)
    m.load_state_dict({k: v.float() for k, v in state_dict.items()})
    m.x_mean = torch.tensor(IMAGENET_MEAN, device=device).view(1, 3, 1, 1)
    m.x_std = torch.tensor(IMAGENET_STD, device=device).view(1, 3, 1, 1)
    return m.eval()
