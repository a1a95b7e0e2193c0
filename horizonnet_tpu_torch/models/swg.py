"""The SWG-Transformer of LGT-Net over a panorama's columns.

LGT-Net (Jiang et al., CVPR 2022, arXiv:2203.01824; config/mp3d.yaml)
puts a stack of pre-norm transformer blocks over the W/4 column features
of HorizonNet's feature extractor. Block ``l`` of kind W (window), S
(shifted window) or G (global), in the order (W, G, S, G) repeated:

    x <- x + A_l(LN1_l(x))
    x <- x + fc2(GELU(fc1(LN2_l(x))))          fc1: C -> 2C, fc2: 2C -> C

A global block attends over all N columns with logits
q_i.k_j / sqrt(d) + R_G[h, min(|i-j|, N-|i-j|)]: the panoramic relative
position bias, one entry per head for each circular distance (N/2 + 1
entries), symmetric and wrapping at the seam. A window block cuts the
columns into windows of ``win`` and attends inside each with
R_W[h, j-i+win-1] (2 win - 1 entries, a table per block); a shifted block
first rolls the columns by +win/2 (``torch.roll``: column c moves to
c + win/2, so its first window holds the last win/2 columns and the first
win/2) and rolls back after, with no mask, since the panorama is cyclic.
q, k and v come from one bias-free product; the heads' outputs are joined
and projected with a bias.

Precision (as models/horizonnet.py): parameters float32, products in the
input's compute dtype (bf16 in training), the residual stream, the layer
norms, the bias add and the softmax in float32.

State_dict keys: ``blocks.{l}.norm1.{weight,bias}``,
``blocks.{l}.attn.qkv.weight`` [3C, C], ``blocks.{l}.attn.proj.{weight,
bias}``, ``blocks.{l}.attn.rpe`` [heads, N/2 + 1 or 2 win - 1],
``blocks.{l}.norm2.{weight,bias}``, ``blocks.{l}.mlp.fc{1,2}.{weight,
bias}``. They are the port's own: no published checkpoint was at hand to
match.

Counters (ops/launch_counts.py): ``swg.window_blocks`` and
``swg.global_blocks`` count the blocks of each kind a forward runs
(shifted ones with the window ones); a captured program adds them again
at every replay, as it does a kernel's launches.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import launch_counts
from .layers import Linear

#: the published stack: (window, global, shifted window, global) x 2
KINDS = ("window", "global", "shifted", "global") * 2

#: blocks run, by kind, in this process
window_blocks = 0
global_blocks = 0
launch_counts.register(__name__, "window_blocks")
launch_counts.register(__name__, "global_blocks")


def global_index(n):
    """[n, n] index into a global block's table: the circular distance
    min(|i - j|, n - |i - j|), in [0, n/2]."""
    i = torch.arange(n)
    d = (i[None, :] - i[:, None]).abs()
    return torch.minimum(d, n - d)


def window_index(win):
    """[win, win] index into a window block's table: j - i + win - 1 for
    query i and key j, in [0, 2 win - 2]."""
    i = torch.arange(win)
    return i[None, :] - i[:, None] + win - 1


def attend(q, k, v, bias):
    """softmax(q k^T / sqrt(d) + bias) v over the last two dims: q, k, v
    [..., L, d] in the compute dtype, ``bias`` [heads, L, L] float32
    (broadcast over the leading dims). The logits, the bias add and the
    softmax are float32; the output is in q's dtype."""
    logits = torch.matmul(q, k.transpose(-1, -2)).float()
    logits = logits * q.shape[-1] ** -0.5 + bias
    return torch.matmul(torch.softmax(logits, -1).to(q.dtype), v)


class Attention(nn.Module):
    """Multi-head attention of one block over x [B, N, C] (normed):
    ``kind`` "global", "window" or "shifted"."""

    def __init__(self, dim, heads, kind, n, win):
        super().__init__()
        if kind not in ("global", "window", "shifted"):
            raise ValueError(f"unknown block kind {kind!r}")
        if kind != "global" and n % win:
            raise ValueError(f"{n} columns do not cut into windows of {win}")
        self.heads, self.kind, self.n, self.win = heads, kind, n, win
        #: the shifted blocks' roll along the columns
        self.shift = win // 2
        self.qkv = Linear(dim, 3 * dim, bias=False)
        self.proj = Linear(dim, dim)
        size = n // 2 + 1 if kind == "global" else 2 * win - 1
        self.rpe = nn.Parameter(torch.empty(heads, size))
        self.register_buffer("index", torch.empty(0, dtype=torch.long),
                             persistent=False)
        self.reset_index()

    def reset_index(self):
        """(Re)make the table's index on the table's device (a module
        built on the meta device and moved with ``to_empty`` calls it)."""
        index = (global_index(self.n) if self.kind == "global"
                 else window_index(self.win))
        self.index = index.to(self.rpe.device)

    def forward(self, x):
        B, N, C = x.shape
        h = self.heads
        bias = self.rpe[:, self.index]                     # [h, L, L]
        if self.kind == "global":
            groups, L = 1, N
        else:
            groups, L = N // self.win, self.win
            if self.kind == "shifted":
                x = torch.roll(x, self.shift, dims=1)
        qkv = self.qkv(x).view(B, groups, L, 3, h, C // h)
        q, k, v = qkv.permute(3, 0, 1, 4, 2, 5).unbind(0)  # [B, g, h, L, d]
        y = attend(q, k, v, bias).permute(0, 1, 3, 2, 4).reshape(B, N, C)
        y = self.proj(y)
        if self.kind == "shifted":
            y = torch.roll(y, -self.shift, dims=1)
        return y


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """One pre-norm block; ``dtype`` is the products' compute dtype."""

    def __init__(self, dim, heads, mlp, kind, n, win, dtype):
        super().__init__()
        self.kind, self.dtype = kind, dtype
        self.norm1 = nn.LayerNorm(dim)
        self.attn = Attention(dim, heads, kind, n, win)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, mlp)

    def forward(self, x):
        """x [B, N, C] float32 -> float32."""
        global window_blocks, global_blocks
        if self.kind == "global":
            global_blocks += 1
        else:
            window_blocks += 1
        x = x + self.attn(self.norm1(x).to(self.dtype)).float()
        return x + self.mlp(self.norm2(x).to(self.dtype)).float()


class SWGTransformer(nn.Module):
    """Blocks of ``kinds`` at width ``dim`` over ``n`` columns: ``heads``
    heads, feed-forward width ``mlp``, windows of ``win``."""

    def __init__(self, dim, n, heads=8, mlp=None, win=16, kinds=KINDS,
                 dtype=torch.float32):
        super().__init__()
        if dim % heads:
            raise ValueError(f"width {dim} does not split into {heads} "
                             "heads")
        self.blocks = nn.ModuleList(
            [Block(dim, heads, mlp or 2 * dim, kind, n, win, dtype)
             for kind in kinds])

    def forward(self, x):
        x = x.float()
        for blk in self.blocks:
            x = blk(x)
        return x
