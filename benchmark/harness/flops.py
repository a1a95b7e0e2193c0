"""The yardstick's arithmetic: peaks, FLOP counts, kernel bounds.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): 989e12 FLOP/s in bf16 on the tensor cores, 3.35e12 B/s of HBM3.

FLOPs of a pano are counted on the benchmark's own reference (reference/
model.py, whose LSTM runs its products step by step) with
``FlopCounterMode`` on the meta device, so a change to the program moves
no count: serving counts the dct4 decode and the forward; training counts
the forward, the losses and the backward (the optimizer's adds left
out). The fits count nothing: they hold no products.

A recurrence kernel's operations are one recurrent product a step,
2 T D B 4H H for T steps, D directions, batch B and hidden size H,
counted once (the kernels split each product into three bf16 terms for
float32 accuracy; that is their cost, not the work). Its bytes are each
tensor the launch reads or writes, once, at its dtype.
"""

import torch
from torch.utils.flop_counter import FlopCounterMode

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16 = 2


def _counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _meta_model():
    from reference.model import HorizonNet

    with torch.device("meta"):
        return HorizonNet()


def serve_flops_per_pano(H, W, dct):
    """FLOPs of one pano through the serving program's work: the dct4
    decode and the forward (every recurrence step)."""
    from reference.dct4 import dct4_wire_shape, unpack_dct4_to_rgb

    net = _meta_model().eval()
    wire = torch.zeros(dct4_wire_shape(1, H, W, dct[0], dct[1]),
                       dtype=torch.int8, device="meta")

    def program():
        with torch.no_grad():
            rgb = unpack_dct4_to_rgb(wire, H, W, *dct)
            net(rgb.permute(0, 3, 1, 2))
    return _counted(program)


def train_flops_per_pano(H, W):
    """FLOPs of one pano through a train step: the train-mode forward with
    dropout, the losses and the backward."""
    from reference.train import loss_terms

    net = _meta_model().train()
    x = torch.zeros(1, 3, H, W, device="meta")
    y_bon = torch.zeros(1, 2, W, device="meta")
    y_cor = torch.zeros(1, 1, W, device="meta")

    def step():
        bon, cor = net(x)
        bon_loss, cor_loss = loss_terms(bon, cor, y_bon, y_cor)
        (bon_loss + cor_loss).backward()
    return _counted(step)


def recurrence_ops(T, D, B, H):
    """One recurrent product a step: 2 T D B 4H H."""
    return 2 * T * D * B * 4 * H * H


def tensor_bytes(*elements, itemsize=BF16):
    """Bytes of tensors of ``elements`` elements each, each counted once."""
    return itemsize * sum(elements)


def roofline_pct(ops, nbytes, seconds):
    """The least time the card could take for ``ops`` operations and
    ``nbytes`` bytes, over ``seconds``, in percent."""
    return 100.0 * max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES) / seconds


def mfu_pct(flops, seconds):
    """``flops`` done in ``seconds`` against the bf16 peak, in percent."""
    return 100.0 * flops / seconds / PEAK_FLOPS
