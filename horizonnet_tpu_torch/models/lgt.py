"""LGT-Net: HorizonNet's feature extractor, the SWG-Transformer and a
horizon-depth head (Jiang et al., CVPR 2022, arXiv:2203.01824;
github.com/zhigangjiang/LGT-Net, config/mp3d.yaml).

The encoder and the height compression are HorizonNet's
(models/horizonnet.py: ResNetEncoder + GlobalHeightStage, step_cols 4,
out_scale 8), giving [B, C, N] with N = W/4 columns (C = 1024 for
resnet50). Transposed to [B, N, C], the columns pass through the
SWG-Transformer (models/swg.py: 8 blocks, 8 heads, feed-forward 2C,
windows of 16). The head:

    depth = x w_d + b_d                        [B, N] horizon depths
    ratio = (x w_r + b_r)[B, N] w_r2 + b_r2    [B, 1] ceiling / camera height

Keys beyond HorizonNet's encoder and height stage: ``swg.*`` (models/
swg.py), ``depth.{weight,bias}`` [1, C], ``ratio.{weight,bias}`` [1, C],
``ratio_out.{weight,bias}`` [1, N]. No dropout: a train step draws
nothing from its generator.

Training targets (``TARGETS``): ``y_depth`` [B, N] and ``y_ratio``
[B, 1] (data/labels.py::horizon_depth); the loss (``loss_terms``,
weighted by LOSS_WEIGHTS):

    L = 0.9 L1(depth) + 0.1 L1(ratio) + 0.1 L_n + 0.1 L_g
    L_n = mean(1 - n_i.n^_i),  L_g = mean|n_i.n_{i+1} - n^_i.n^_{i+1}|

over the unit normals n of the floor boundary the depths imply
(``boundary_normals``; ^ the labels'). In a captured train step the
model marks the device stages (utils/profiling.py): ``encoder_fwd`` and
``swg_fwd`` on the way forward, and from the backward pass ``head_loss``
where the gradient reaches the transformer's output and ``swg_bwd`` where
it leaves its input; train/step.py marks ``encoder_bwd`` and ``optim``
(``TRAIN_STAGES``).
"""

import math

import torch
import torch.nn as nn

from .height import GlobalHeightStage
from .horizonnet import (IMAGENET_MEAN, IMAGENET_STD, OUT_SCALE, STEP_COLS,
                         _FeatureExtractor)
from .layers import Linear
from .swg import KINDS, SWGTransformer
from ..utils import profiling

HEADS = 8
WINDOW = 16
#: the loss's weights: horizon depth, ratio, normals, normals' turns
LOSS_WEIGHTS = {"depth": 0.9, "ratio": 0.1, "normal": 0.1, "grad": 0.1}


def boundary_normals(depth):
    """Unit normals [B, N, 2] of the floor boundary that horizon depths
    [B, N] imply: p_i = d_i (cos t_i, sin t_i) at column i's centre
    longitude t_i = ((i + 0.5) / N - 0.5) 2 pi, and n_i the unit normal
    (-e_y, e_x) / |e| of e = p_{i+1} - p_i, taken cyclically (|e| no less
    than 1e-6)."""
    n = depth.shape[-1]
    t = (torch.arange(n, device=depth.device, dtype=torch.float32) + 0.5) \
        / n * (2 * math.pi) - math.pi
    p = torch.stack([depth * torch.cos(t), depth * torch.sin(t)], -1)
    e = torch.roll(p, -1, dims=1) - p
    normal = torch.stack([-e[..., 1], e[..., 0]], -1)
    return normal / e.norm(dim=-1, keepdim=True).clamp(min=1e-6)


def loss_terms(depth, ratio, y_depth, y_ratio):
    """LGT-Net's losses, each a mean over all: L1 of the horizon depths
    [B, N] and of the ratio [B, 1]; the normal term 1 - n_i.n^_i and the
    gradient term |n_i.n_{i+1} - n^_i.n^_{i+1}| of the boundary normals
    (``boundary_normals``, ^ the labels'). -> {"depth", "ratio",
    "normal", "grad"}."""
    n, m = boundary_normals(depth), boundary_normals(y_depth)
    turn = lambda v: (v * torch.roll(v, -1, dims=1)).sum(-1)  # noqa: E731
    return {"depth": (depth - y_depth).abs().mean(),
            "ratio": (ratio - y_ratio).abs().mean(),
            "normal": (1.0 - (n * m).sum(-1)).mean(),
            "grad": (turn(n) - turn(m)).abs().mean()}


class LGTNet(nn.Module):
    """Built on ``device`` for input width ``W`` (the columns N = W/4 fix
    the global blocks' tables and the ratio head), computing in ``dtype``
    with conv and linear weights stored in ``param_dtype`` (default:
    ``dtype``); random from ``seed`` until weights are loaded."""

    ARCH = "lgt"
    TARGETS = ("y_depth", "y_ratio")
    METRICS = ("total", "depth", "ratio", "normal", "grad")
    #: whether the train step marks its device stages (train/step.py)
    TRAIN_STAGES = True
    use_rnn = False

    def __init__(self, backbone="resnet50", W=1024, *, device,
                 dtype=torch.float32, seed=0, param_dtype=None,
                 bn_momentum=0.1, seam_pool=False):
        super().__init__()
        self.backbone = backbone
        self.dtype = dtype
        self.n = W // STEP_COLS
        with torch.device("meta"):
            self.feature_extractor = _FeatureExtractor(
                backbone, bn_momentum, "", seam_pool, False)
            c1, c2, c3, c4 = self.feature_extractor.channels
            self.reduce_height_module = GlobalHeightStage(
                (c1, c2, c3, c4), OUT_SCALE, bn_momentum)
            c = (c1 * 8 + c2 * 4 + c3 * 2 + c4) // OUT_SCALE
            self.swg = SWGTransformer(c, self.n, HEADS, 2 * c, WINDOW, KINDS,
                                      dtype)
            self.depth = Linear(c, 1)
            self.ratio = Linear(c, 1)
            self.ratio_out = Linear(self.n, 1)
        self.to_empty(device=device)
        self.reset_parameters(torch.Generator(device=device).manual_seed(seed))
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.to(dtype if param_dtype is None else param_dtype)
        self.to(memory_format=torch.channels_last)
        for blk in self.swg.blocks:
            blk.attn.reset_index()
        self.register_buffer("x_mean", torch.tensor(
            IMAGENET_MEAN, device=device).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("x_std", torch.tensor(
            IMAGENET_STD, device=device).view(1, 3, 1, 1), persistent=False)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Lecun-normal convs and linears with zero biases, identity batch
        and layer norms, relative-position tables N(0, 0.02)."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, math.sqrt(1.0 / fan_in),
                                 generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                m.reset_parameters()
        for blk in self.swg.blocks:
            blk.attn.rpe.normal_(0.0, 0.02, generator=generator)

    def target_shapes(self, B, W):
        """{target: shape} of a batch of B panos W wide."""
        return {"y_depth": (B, W // STEP_COLS), "y_ratio": (B, 1)}

    def losses(self, outputs, targets):
        """{"total", and each of ``loss_terms``} of ``outputs`` (depth,
        ratio) against ``targets`` (y_depth, y_ratio); the total weighted
        by LOSS_WEIGHTS."""
        terms = loss_terms(*outputs, *targets)
        return {"total": sum(LOSS_WEIGHTS[k] * v for k, v in terms.items()),
                **terms}

    def forward(self, x, generator=None, batch_shard=None):
        """x [B, 3, H, W] float in [0, 1] -> (depth [B, N], ratio [B, 1])
        in float32. ``generator`` and ``batch_shard`` are taken for the
        train step's call and unused: the model draws nothing."""
        B, _, H, W = x.shape
        if W // STEP_COLS != self.n:
            raise ValueError(f"input {W} wide; the model was built for "
                             f"{self.n * STEP_COLS}")
        profiling.mark(None)
        x = ((x - self.x_mean) / self.x_std).to(self.dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        feats = self.feature_extractor.encoder(x)
        feature = self.reduce_height_module(feats, self.n)   # [B, C, N]
        profiling.mark("encoder_fwd")
        h = profiling.mark_backward(feature.permute(0, 2, 1), "swg_bwd")
        h = self.swg(h)                                      # [B, N, C] f32
        profiling.mark("swg_fwd")
        h = profiling.mark_backward(h, "head_loss").to(self.dtype)
        depth = self.depth(h).squeeze(-1)                    # [B, N]
        ratio = self.ratio_out(self.ratio(h).squeeze(-1))    # [B, 1]
        return depth.float(), ratio.float()

