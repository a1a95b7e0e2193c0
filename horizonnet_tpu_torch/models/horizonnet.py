"""HorizonNet: encoder + height compression + 1D recurrent head (NCHW).

Counterpart of horizonnet_tpu/models/horizonnet.py (reference
model.py:185-281): ImageNet normalization, encoder -> 4 maps ->
GlobalHeightStage -> [B, c_last, W/4], a 2-layer bi-LSTM over the W/4
columns and Linear(1024 -> 3*step_cols), reshaped to [B, 3, W]; or, with
use_rnn=False, a per-column MLP c_last -> 512 -> 3*step_cols. Returns
(bon [B, 2, W], cor [B, 1, W]) in float32.

Weights: module attribute names give the reference's state_dict keys
(tests/torch_replica.py), so ``load_state_dict`` takes a reference
state_dict or models/torch_convert.py::variables_to_state_dict of the JAX
package's variables. Compute dtype: convolutions and linears run in the
model's ``dtype`` (models/layers.py), batch norm keeps float32 parameters
and the bi-LSTM keeps float32 parameters that it casts per call as the
JAX package does (ops/lstm.py), so bf16 rounds at the same points. A
serving model stores its conv and linear weights in ``dtype``; a training
model (``param_dtype=torch.float32``) keeps them in float32 and casts
them per call, as flax does with ``dtype`` bf16 and ``param_dtype`` f32.

Train mode (``model.train()``) mirrors the JAX module's ``train=True``:
batch norm on batch statistics (models/layers.py::BatchNorm2d), dropout
0.5 between the LSTM layers and after the LSTM (or in the MLP head) with
masks from the ``generator`` passed to ``forward``, and the LSTM
recurrence that has a backward (see BiLSTM).
"""

import math

import numpy as np
import torch
import torch.nn as nn

from .height import GlobalHeightStage
from .layers import Linear
from .resnet import ResNetEncoder, resnet_feature_channels
from ..ops.dropout import dropout
from ..ops.lstm import bilstm

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
OUT_SCALE = 8        # height-stage channel divisor (model.py:212-215)
STEP_COLS = 4        # output columns per LSTM step
RNN_HIDDEN = 512
DROPOUT = 0.5        # between LSTM layers and in the head (model.py:221-233)


def head_bias(step_cols):
    """Prior of the head's bias: cor logit -1, ceiling boundary -0.478,
    floor boundary 0.425 (reference model.py:229-231)."""
    b = torch.zeros(3 * step_cols)
    b[0 * step_cols:1 * step_cols] = -1.0
    b[1 * step_cols:2 * step_cols] = -0.478
    b[2 * step_cols:3 * step_cols] = 0.425
    return b


class BiLSTM(nn.Module):
    """Parameters under nn.LSTM's names (``weight_ih_l0_reverse`` etc.),
    forward through ops/lstm.py::bilstm.

    The cell adds b_ih and b_hh, so the two are one bias; as in the JAX
    package (one folded ``b`` per layer) it trains as one parameter,
    ``bias_ih``. ``bias_hh`` is a zero buffer that keeps nn.LSTM's keys: a
    state_dict with a nonzero ``bias_hh`` (the reference's) loads with it
    folded into ``bias_ih``.

    ``impl`` (ops/lstm.py): in eval mode "kernel" and "kernel_train" run
    K1, "plain" its twin; in train mode "kernel_train" runs K2/K3 and the
    others autograd through the plain loop, as the JAX module takes
    pallas_train or the scan (horizonnet_tpu/models/horizonnet.py:71-82).
    """

    def __init__(self, input_size, hidden_size=512, num_layers=2,
                 impl="kernel"):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.impl = impl
        G = 4 * hidden_size
        for layer in range(num_layers):
            in_l = input_size if layer == 0 else 2 * hidden_size
            for sfx in ("", "_reverse"):
                for name, shape in (("weight_ih", (G, in_l)),
                                    ("weight_hh", (G, hidden_size)),
                                    ("bias_ih", (G,))):
                    self.register_parameter(f"{name}_l{layer}{sfx}",
                                            nn.Parameter(torch.empty(shape)))
                self.register_buffer(f"bias_hh_l{layer}{sfx}",
                                     torch.zeros(G))
        self.register_load_state_dict_post_hook(BiLSTM._fold_bias_hh)

    @staticmethod
    @torch.no_grad()
    def _fold_bias_hh(module, incompatible_keys):
        for name, buf in module.named_buffers():
            if name.startswith("bias_hh"):
                getattr(module, "bias_ih" + name[len("bias_hh"):]).add_(buf)
                buf.zero_()

    def layer_params(self):
        """Per layer {"w_ih" [2,4H,I], "w_hh" [2,4H,H], "b" [2,4H]}, the
        JAX package's layout (b is ``bias_ih``, the folded bias)."""
        out = []
        for layer in range(self.num_layers):
            get = lambda n: [getattr(self, f"{n}_l{layer}{s}")  # noqa: E731
                             for s in ("", "_reverse")]
            out.append({
                "w_ih": torch.stack(get("weight_ih")),
                "w_hh": torch.stack(get("weight_hh")),
                "b": torch.stack(get("bias_ih")),
            })
        return out

    def recurrence_impl(self):
        """The ops/lstm.py impl this mode runs."""
        if self.training:
            return "kernel_train" if self.impl == "kernel_train" else "plain"
        return "kernel" if self.impl == "kernel_train" else self.impl

    def forward(self, x, generator=None):
        """x: [T, B, I] -> [T, B, 2H]. Train mode drops between layers with
        masks from ``generator``."""
        return bilstm(x, self.layer_params(), self.recurrence_impl(),
                      DROPOUT if self.training else 0.0, generator)


class _FeatureExtractor(nn.Module):
    def __init__(self, backbone, bn_momentum, fused_blocks):
        super().__init__()
        self.encoder = ResNetEncoder(backbone, bn_momentum, fused_blocks)


class HorizonNet(nn.Module):
    """Built on ``device``, computing in ``dtype``, with conv and linear
    weights stored in ``param_dtype`` (default: ``dtype``); parameters are
    random from a torch.Generator seeded with ``seed`` until weights are
    loaded. ``bn_momentum`` is torch's running-stat momentum.
    ``fused_blocks="kernel"`` serves the identity bottlenecks as fused
    blocks (models/resnet.py, K4); the default runs them unfused."""

    def __init__(self, backbone="resnet50", use_rnn=True, *, device,
                 dtype=torch.float32, lstm_impl="kernel", seed=0,
                 param_dtype=None, bn_momentum=0.1, fused_blocks=""):
        super().__init__()
        if not backbone.startswith("res"):
            raise NotImplementedError(
                f"{backbone}: the densenet encoders are ROADMAP Queue 1 "
                "item 7")
        self.backbone = backbone
        self.use_rnn = use_rnn
        self.dtype = dtype
        with torch.device("meta"):
            self.feature_extractor = _FeatureExtractor(backbone, bn_momentum,
                                                       fused_blocks)
            c1, c2, c3, c4 = resnet_feature_channels(backbone)
            self.reduce_height_module = GlobalHeightStage(
                (c1, c2, c3, c4), OUT_SCALE, bn_momentum)
            c_last = (c1 * 8 + c2 * 4 + c3 * 2 + c4) // OUT_SCALE
            if use_rnn:
                self.bi_rnn = BiLSTM(c_last, RNN_HIDDEN, 2, lstm_impl)
                self.linear = Linear(2 * RNN_HIDDEN, 3 * STEP_COLS)
            else:
                # index 2 stands for the head's dropout, drawn in forward
                self.linear = nn.Sequential(
                    Linear(c_last, RNN_HIDDEN), nn.ReLU(inplace=True),
                    nn.Identity(), Linear(RNN_HIDDEN, 3 * STEP_COLS))
        self.to_empty(device=device)
        self.reset_parameters(torch.Generator(device=device).manual_seed(seed))
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.to(dtype if param_dtype is None else param_dtype)
        self.to(memory_format=torch.channels_last)
        self.register_buffer("x_mean", torch.tensor(
            IMAGENET_MEAN, device=device).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("x_std", torch.tensor(
            IMAGENET_STD, device=device).view(1, 3, 1, 1), persistent=False)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator):
        """The JAX package's init: lecun-normal convs and linears (normal,
        std sqrt(1/fan_in)), zero conv biases, identity batch norm,
        U(-1/sqrt(H), 1/sqrt(H)) LSTM weights and folded bias, and the
        head-bias prior."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, math.sqrt(1.0 / fan_in),
                                 generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, BiLSTM):
                k = 1.0 / math.sqrt(m.hidden_size)
                for p in m.parameters():
                    p.uniform_(-k, k, generator=generator)
                for b in m.buffers():
                    b.zero_()
        last = self.linear if self.use_rnn else self.linear[3]
        last.bias.copy_(head_bias(STEP_COLS))

    def forward(self, x, generator=None):
        """x: [B, 3, H, W] float in [0, 1] -> (bon [B, 2, W], cor [B, 1, W]).

        Train mode needs ``generator`` (a torch.Generator on x's device)
        for the dropout masks."""
        B, _, H, W = x.shape
        x = ((x - self.x_mean) / self.x_std).to(self.dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        feats = self.feature_extractor.encoder(x)
        out_w = W // STEP_COLS
        feature = self.reduce_height_module(feats, out_w)   # [B, c, out_w]
        sc = STEP_COLS
        rate = DROPOUT if self.training else 0.0
        if self.use_rnn:
            seq = self.bi_rnn(feature.permute(2, 0, 1), generator)
            seq = dropout(seq, rate, generator)             # [out_w, B, 2H]
            out = self.linear(seq)                          # [out_w, B, 3sc]
            out = out.view(out_w, B, 3, sc).permute(1, 2, 0, 3)
        else:
            first, relu, _, last = self.linear
            h = relu(first(feature.permute(0, 2, 1)))       # [B, out_w, 512]
            out = last(dropout(h, rate, generator))         # [B, out_w, 3sc]
            out = out.view(B, out_w, 3, sc).permute(0, 2, 1, 3)
        out = out.reshape(B, 3, out_w * sc).float()
        return out[:, 1:], out[:, :1]
