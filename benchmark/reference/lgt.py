"""Plain float32 LGT-Net: the benchmark's reference for its training cell.

LGT-Net (Jiang et al., "LGT-Net: Indoor Panoramic Room Layout Estimation
with Geometry-Aware Transformer Network", CVPR 2022, arXiv:2203.01824;
github.com/zhigangjiang/LGT-Net, config/mp3d.yaml): HorizonNet's resnet50
feature extractor and height compression (reference/model.py) give
[B, 1024, N] over N = W/4 columns; 8 pre-norm transformer blocks of
width 1024 (8 heads of 128, feed-forward 2048 with GELU, no dropout) run
over the columns in the order window, global, shifted window, global,
twice; a linear head gives a horizon depth a column and, through a second
linear over the columns, one ceiling-to-camera height ratio a pano.

Attention, written out: softmax(q k^T / sqrt(128) + R) v. A global
block's R is R_G[h, min(|i-j|, N-|i-j|)] (N/2 + 1 entries a head, the
panoramic relative position bias); a window block cuts the columns into
windows of 16 and adds R_W[h, j-i+15] (31 entries a head, a table per
block); a shifted window block rolls the columns by +8 (``torch.roll``)
before and by -8 after, with no mask.

Labels (``horizon_depth``): the floor corners at distance
r_k = 1.6 / tan(v_k) (v down-positive latitude, the camera 1.6 above the
floor) give the floor polygon; column i's depth is the distance along its
centre longitude ((i + 0.5) / N - 0.5) 2 pi to the polygon's nearest
crossing; the ratio is the mean of the ceiling's heights r_k tan(-v^c_k)
over 1.6. Loss: 0.9 L1(depth) + 0.1 L1(ratio) + 0.1 L_n + 0.1 L_g, with
p_i = d_i (cos t_i, sin t_i), n_i the unit normal (-e_y, e_x) / |e| of
e = p_{i+1} - p_i (cyclic, |e| no less than 1e-6), L_n = mean(1 - n.n^)
and L_g = mean|n_i.n_{i+1} - n^_i.n^_{i+1}|.

Departures from the published description, each a reading this
benchmark makes where the paper and its configuration leave a choice
(the configuration's ``assumed`` lists them): the block order above; the
shift's sign (+8); a window table per block; no layer norm after the last
block; the loss's weights and its two geometric terms as above (the
published code computes normals from the boundary's 3D points and
weights its terms by its own configuration); the ratio as the ceiling's
height over the camera's. The training data are synthetic rooms
(reference/rooms.py) in place of MatterportLayout.

Module names give the port's state_dict keys (horizonnet_tpu_torch
models/lgt.py). ``set_lowp`` (reference/model.py) rounds every product's
operands, the attention's too. ``fault`` builds one of the planted
faults the judge is held against: ``no_rg`` (global blocks without R_G),
``unshifted`` (shifted blocks not shifted), ``rw_transposed`` (R_W read
at i-j+15). Nothing here imports the program under test.
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.model import (IMAGENET_MEAN, IMAGENET_STD, STEP_COLS, Conv2d,
                             Linear, _Encoder, _Height, _same)
from reference.rooms import coorx2u, coory2v

DIM = 1024
HEADS = 8
MLP = 2048
WINDOW = 16
SHIFT = 8
KINDS = ("window", "global", "shifted", "global") * 2
CAMERA_HEIGHT = 1.6
WEIGHTS = {"depth": 0.9, "ratio": 0.1, "normal": 0.1, "grad": 0.1}
FAULTS = ("no_rg", "unshifted", "rw_transposed")


class Attention(nn.Module):
    lowp = staticmethod(_same)

    def __init__(self, kind, n, fault=None):
        super().__init__()
        self.kind, self.n, self.fault = kind, n, fault
        self.qkv = Linear(DIM, 3 * DIM, bias=False)
        self.proj = Linear(DIM, DIM)
        size = n // 2 + 1 if kind == "global" else 2 * WINDOW - 1
        self.rpe = nn.Parameter(torch.empty(HEADS, size))

    def bias(self):
        """R [heads, L, L] of this block."""
        dev = self.rpe.device
        if self.kind == "global":
            i = torch.arange(self.n, device=dev)
            d = (i[None, :] - i[:, None]).abs()
            r = self.rpe[:, torch.minimum(d, self.n - d)]
            return r * 0.0 if self.fault == "no_rg" else r
        i = torch.arange(WINDOW, device=dev)
        rel = i[None, :] - i[:, None]
        if self.fault == "rw_transposed":
            rel = -rel
        return self.rpe[:, rel + WINDOW - 1]

    def attend(self, x):
        """x [G, L, C] -> [G, L, C]: attention within each of G groups."""
        G, L, _ = x.shape
        q, k, v = self.qkv(x).view(G, L, 3, HEADS, DIM // HEADS).permute(
            2, 0, 3, 1, 4)                                     # [G, h, L, d]
        lp = self.lowp
        logits = lp(q) @ lp(k).transpose(-1, -2) / math.sqrt(DIM // HEADS)
        p = torch.softmax(logits + self.bias(), dim=-1)
        y = (lp(p) @ lp(v)).permute(0, 2, 1, 3).reshape(G, L, DIM)
        return self.proj(y)

    def forward(self, x):
        B, N, C = x.shape
        if self.kind == "global":
            return self.attend(x)
        shift = SHIFT if self.kind == "shifted" and self.fault != "unshifted" \
            else 0
        x = torch.roll(x, shift, dims=1)
        y = self.attend(x.reshape(B * N // WINDOW, WINDOW, C))
        return torch.roll(y.reshape(B, N, C), -shift, dims=1)


class Mlp(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = Linear(DIM, MLP)
        self.fc2 = Linear(MLP, DIM)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, kind, n, fault=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(DIM)
        self.attn = Attention(kind, n, fault)
        self.norm2 = nn.LayerNorm(DIM)
        self.mlp = Mlp()

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _SWG(nn.Module):
    def __init__(self, n, fault=None):
        super().__init__()
        self.blocks = nn.ModuleList([Block(k, n, fault) for k in KINDS])


class LGTNet(nn.Module):
    """``forward(x [B, 3, H, W] in [0, 1])`` -> (depth [B, W/4], ratio
    [B, 1])."""

    CHANNELS = (256, 512, 1024, 2048)

    def __init__(self, W=1024, fault=None):
        super().__init__()
        if fault not in (None,) + FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.n = W // STEP_COLS
        self.feature_extractor = _Encoder()
        self.reduce_height_module = _Height(self.CHANNELS)
        self.swg = _SWG(self.n, fault)
        self.depth = Linear(DIM, 1)
        self.ratio = Linear(DIM, 1)
        self.ratio_out = Linear(self.n, 1)
        self.register_buffer("x_mean", torch.tensor(IMAGENET_MEAN).view(
            1, 3, 1, 1), persistent=False)
        self.register_buffer("x_std", torch.tensor(IMAGENET_STD).view(
            1, 3, 1, 1), persistent=False)

    def forward(self, x):
        B = x.shape[0]
        x = (x - self.x_mean) / self.x_std
        feats = self.feature_extractor.encoder(x)
        feature = torch.cat(
            [g(f, self.n).reshape(B, -1, self.n) for g, f in
             zip(self.reduce_height_module.ghc_lst, feats)], 1)
        h = feature.permute(0, 2, 1)
        for blk in self.swg.blocks:
            h = blk(h)
        depth = self.depth(h)[..., 0]
        ratio = self.ratio_out(self.ratio(h)[..., 0])
        return depth, ratio


def spec(W=1024):
    """The architecture built here for input width ``W``, under the
    configuration's keys."""
    n = W // STEP_COLS
    return {"backbone": "resnet50", "step_cols": STEP_COLS, "out_scale": 8,
            "patch_num": n, "dim": DIM, "heads": HEADS,
            "head_dim": DIM // HEADS, "mlp_dim": MLP, "win_size": WINDOW,
            "shift": SHIFT, "depth": len(KINDS), "blocks": list(KINDS),
            "rpe": {"global": n // 2 + 1, "window": 2 * WINDOW - 1},
            "dropout": 0.0, "camera_height": CAMERA_HEIGHT, "loss": WEIGHTS}


def set_lowp(model, fn=None):
    """Round every product's operands of ``model`` through ``fn``: the
    convolutions, the linears and the attention's two products."""
    for m in model.modules():
        if isinstance(m, (Conv2d, Linear, Attention)):
            m.lowp = fn or _same


def build(state_dict, device, W=1024, fault=None):
    """The reference on ``device`` in float32 and eval mode, holding
    ``state_dict``."""
    with torch.device("meta"):
        m = LGTNet(W, fault)
    m = m.to_empty(device=device)
    m.load_state_dict({k: v.float() for k, v in state_dict.items()})
    m.x_mean = torch.tensor(IMAGENET_MEAN, device=device).view(1, 3, 1, 1)
    m.x_std = torch.tensor(IMAGENET_STD, device=device).view(1, 3, 1, 1)
    return m.eval()


# labels and loss ---------------------------------------------------------

def horizon_depth(cor, H, W, n):
    """(depth [n] float32, ratio) of a corner list (ceiling/floor pairs in
    pixels), column by column."""
    cor = np.asarray(cor, np.float64)
    ceil, floor = cor[0::2], cor[1::2]
    r = CAMERA_HEIGHT / np.tan(coory2v(floor[:, 1], H))
    u = coorx2u(floor[:, 0], W)
    pts = np.stack([r * np.cos(u), r * np.sin(u)], 1)
    ratio = float(np.mean(r * np.tan(-coory2v(ceil[:, 1], H)))
                  / CAMERA_HEIGHT)
    depth = np.empty(n)
    for i in range(n):
        t = ((i + 0.5) / n - 0.5) * 2 * np.pi
        e = np.array([np.cos(t), np.sin(t)])
        best = np.inf
        for k in range(len(pts)):
            a, b = pts[k], pts[(k + 1) % len(pts)]
            d = b - a
            den = e[0] * d[1] - e[1] * d[0]
            if abs(den) <= 1e-12:
                continue
            dist = (a[0] * d[1] - a[1] * d[0]) / den
            s = (a[0] * e[1] - a[1] * e[0]) / den
            if 0 <= s <= 1 and dist > 0:
                best = min(best, dist)
        depth[i] = best
    return depth.astype(np.float32), ratio


def normals(depth):
    n = depth.shape[-1]
    t = (torch.arange(n, device=depth.device, dtype=torch.float32) + 0.5) \
        / n * (2 * math.pi) - math.pi
    p = torch.stack([depth * torch.cos(t), depth * torch.sin(t)], -1)
    e = torch.roll(p, -1, dims=1) - p
    nrm = torch.stack([-e[..., 1], e[..., 0]], -1)
    return nrm / e.norm(dim=-1, keepdim=True).clamp(min=1e-6)


def loss_terms(depth, ratio, y_depth, y_ratio):
    """{"depth", "ratio", "normal", "grad"}, each a mean over all."""
    n, m = normals(depth), normals(y_depth)
    dot_next = lambda v: (v * torch.roll(v, -1, dims=1)).sum(-1)  # noqa
    return {"depth": (depth - y_depth).abs().mean(),
            "ratio": (ratio - y_ratio).abs().mean(),
            "normal": (1.0 - (n * m).sum(-1)).mean(),
            "grad": (dot_next(n) - dot_next(m)).abs().mean()}


def total_loss(terms):
    return sum(WEIGHTS[k] * v for k, v in terms.items())


def step(net, opt, x, y_depth, y_ratio):
    """One train step (batch norm on the batch's statistics) -> (total
    loss, the gradients {name: tensor} the optimizer took)."""
    net.train()
    for p in opt.params.values():
        p.grad = None
    depth, ratio = net(x)
    total = total_loss(loss_terms(depth, ratio, y_depth, y_ratio))
    total.backward()
    grads = {k: p.grad.detach().clone() for k, p in opt.params.items()}
    opt.step(grads)
    return float(total.detach()), grads
