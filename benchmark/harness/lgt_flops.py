"""The LGT-Net cell's yardstick: FLOPs of a train step a pano, and the
SWG-Transformer's operations and bytes a step.

Counted on the benchmark's own reference (reference/lgt.py) with
``FlopCounterMode`` on the meta device, so that no change to the program
moves a count (harness/flops.py has the peaks and does the same for
HorizonNet). A train step counts the forward, the losses and the
backward, the optimizer's adds left out.

The SWG-Transformer's least time (``swg_roofline.lgt_train``) takes its
operations, forward and backward (the backward with the input's
gradient, as in the train step, where the encoder trains too), and its
bytes: each parameter read in bf16 by the forward and by the backward
and its gradient written in float32 (8 bytes a parameter), and each
block's float32 input and output read and written once by the forward
and once, as gradients, by the backward (16 bytes an element of
[B, N, C] a block).
"""

import math

import torch
from torch.utils.flop_counter import FlopCounterMode


def _counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _meta_net(W):
    from reference.lgt import LGTNet

    with torch.device("meta"):
        return LGTNet(W).train()


def train_flops_per_pano(H, W):
    """FLOPs of one pano through a train step: the train-mode forward, the
    losses and the backward."""
    from reference.lgt import loss_terms, total_loss

    net = _meta_net(W)
    x = torch.zeros(1, 3, H, W, device="meta")
    y_depth = torch.zeros(1, W // 4, device="meta")
    y_ratio = torch.zeros(1, 1, device="meta")

    def step():
        depth, ratio = net(x)
        total_loss(loss_terms(depth, ratio, y_depth, y_ratio)).backward()
    return _counted(step)


def swg_ops(B, W):
    """The SWG-Transformer's operations a step at batch B: its 8 blocks
    forward and backward (with the input's gradient)."""
    from reference.lgt import DIM

    blocks = _meta_net(W).swg.blocks
    x = torch.zeros(B, W // 4, DIM, device="meta", requires_grad=True)

    def fwd_bwd():
        h = x
        for blk in blocks:
            h = blk(h)
        h.sum().backward()
    return _counted(fwd_bwd)


def swg_bytes(B, W):
    """The SWG-Transformer's bytes a step at batch B (module docstring)."""
    from reference.lgt import DIM

    blocks = _meta_net(W).swg.blocks
    params = sum(math.prod(p.shape) for p in blocks.parameters())
    return 8 * params + 16 * B * (W // 4) * DIM * len(blocks)
