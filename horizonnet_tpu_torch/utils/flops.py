"""FLOP count of the serving program and of the train step.

The counterpart of XLA's ``compiled.cost_analysis()["flops"]``, which the
JAX package's bench.py and tools/train_throughput.py read for their MFU.
Here ``torch.utils.flop_counter.FlopCounterMode`` counts the products
(matmuls, convolutions and their backward) of one pano's program, run on
the ``meta`` device, where no op computes anything, and the count is
scaled by the batch: every op of the program is linear in it.

What the count covers:
- the LSTM recurrence at every step. The CUDA kernels (K1-K3) are ctypes
  launches that the counter cannot see, so the count runs a twin of the
  model built with ``lstm_impl="plain"``, whose loop's ``h @ W_hh`` the
  counter sees at each of the T steps. XLA counts a ``while`` loop's body
  once, so JAX's figure lacks (T - 1) steps of the recurrence: 63 x 4 x
  2*512*2048 = 0.53 GFLOP at W=256 (tests/test_torch_bench.py holds the
  two counts against each other with that correction);
- the twin's encoder unfused and in float: the fused bottleneck (K4) and
  the int8 encoder do the same products, which the counter sees only in
  the plain convolutions;
- wire decode and the fit on the device as their products: the fit has
  none (JAX counts it at 0.3 MFLOP a pano: its comparisons and adds);
- the train step's forward with dropout, the losses and the backward (the
  first convolution takes no input gradient). The optimizer is left out:
  it is adds on the parameters, a few MFLOP.

MFU = FLOPs a pano x panos/s / peak, against the card's dense bf16 rate.
"""

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

#: Dense bf16 rate of one H100 SXM on its tensor cores (NVIDIA's data
#: sheet, without sparsity, at the 700 W power limit)
PEAK_BF16_FLOPS = 989e12


def _counting_twin(model, param_dtype=None):
    """``model``'s architecture on the meta device with the plain LSTM, its
    encoder unfused and in float."""
    from ..models import build_model

    return build_model(model.backbone, model.use_rnn, device="cpu",
                       dtype=model.dtype, lstm_impl="plain",
                       param_dtype=param_dtype,
                       seam_pool=model.seam_pool).to("meta")


def _counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def serving_flops(model, B, H, W, input_format="float", postproc=None,
                  flip=False, rotate=(), dct_luma_m=None, dct_chroma_m=None,
                  dct_quality=None):
    """FLOPs of one batch of B through InferenceEngine's program (wire
    decode, TTA forward, fit) for ``model`` in that configuration."""
    from ..inference import decode_wire, serving_outputs, wire_spec
    from ..ops import dct as _dct

    twin = _counting_twin(model)
    dct = (_dct.DEFAULT_LUMA_M if dct_luma_m is None else dct_luma_m,
           _dct.DEFAULT_CHROMA_M if dct_chroma_m is None else dct_chroma_m,
           _dct.DEFAULT_QUALITY if dct_quality is None else dct_quality)
    dtype, shape = wire_spec(input_format, 1, H, W, *dct[:2])
    x = torch.from_numpy(np.zeros(shape, dtype)).to("meta")

    def program():
        with torch.no_grad():
            serving_outputs(twin, decode_wire(x, input_format, H, W, *dct),
                            H, W, flip, rotate, postproc)
    return B * _counted(program)


def train_step_flops(model, B, H, W):
    """FLOPs of one train step on a batch of B for ``model``: forward in
    train mode with dropout, the losses and the backward."""
    from ..models.horizonnet import loss_terms

    twin = _counting_twin(model, param_dtype=torch.float32).train()
    x = torch.zeros(1, 3, H, W, device="meta")
    y_bon = torch.zeros(1, 2, W, device="meta")
    y_cor = torch.zeros(1, 1, W, device="meta")

    def step():
        bon, cor = twin(x, torch.Generator())
        bon_loss, cor_loss = loss_terms(bon, cor, y_bon, y_cor)
        (bon_loss + cor_loss).backward()
    return B * _counted(step)


def mfu_pct(flops_per_pano, panos_per_sec):
    """Model FLOP utilization, in percent of the H100's dense bf16 rate."""
    return 100.0 * flops_per_pano * panos_per_sec / PEAK_BF16_FLOPS
