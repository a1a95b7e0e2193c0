"""Bidirectional multi-layer LSTM: hoisted input projection + recurrence.

Counterpart of horizonnet_tpu/ops/lstm.py (the reference's cuDNN LSTM,
model.py:221-227: 2 layers, hidden 512, bidirectional, dropout 0.5
between layers in training, sequence-first over the pano columns). The
input projection x @ W_ih^T + b for all steps and both directions is one
matmul outside the recurrence, as in JAX. Gate order i, f, g, o.

``impl`` (the JAX package's names in brackets):
  "kernel"        [pallas] K1 for a CUDA tensor, its plain twin for a CPU
                  tensor (ops/cuda_lstm.py::bilstm_recurrence); serving
                  only, it has no backward;
  "kernel_train"  [pallas_train] the differentiable pair K2/K3 for a CUDA
                  tensor, their twins for a CPU tensor
                  (ops/cuda_lstm_train.py::bilstm_recurrence_trainable);
  "plain"         [scan] the plain twin of K1 on any device, differentiable
                  by autograd through its loop.
"""

import torch

from . import dropout as _dropout
from .cuda_lstm import bilstm_recurrence, bilstm_recurrence_plain
from .cuda_lstm_train import bilstm_recurrence_trainable

IMPLS = ("kernel", "kernel_train", "plain")
_RECURRENCE = {"kernel": bilstm_recurrence,
               "kernel_train": bilstm_recurrence_trainable,
               "plain": bilstm_recurrence_plain}


def bidir_layer(x, p, impl="kernel"):
    """One bidirectional layer. x: [T, B, I] -> [T, B, 2H].

    ``p``: {"w_ih": [D, 4H, I], "w_hh": [D, 4H, H], "b": [D, 4H]}, the
    JAX package's layout (b = b_ih + b_hh folded). As in JAX
    (lstm.py:79-80), w_ih and b are cast to x's dtype before the
    projection, so bf16 rounds at the same points.
    """
    if impl not in IMPLS:
        raise ValueError(f"lstm impl {impl!r} not in {IMPLS}")
    D = p["w_ih"].shape[0]
    w_ih = p["w_ih"].to(x.dtype)
    b = p["b"].to(x.dtype)
    xw = torch.einsum("tbi,dgi->tdbg", x, w_ih) + b[None, :, None, :]
    if D == 2:
        # the reverse direction consumes the sequence back to front
        xw = torch.stack([xw[:, 0], xw[:, 1].flip(0)], dim=1)
    w_hh_t = p["w_hh"].transpose(1, 2).to(x.dtype)      # [D, H, 4H]
    ys = _RECURRENCE[impl](xw.contiguous(), w_hh_t.contiguous())
    if D == 2:
        return torch.cat([ys[:, 0], ys[:, 1].flip(0)], dim=-1)
    return ys[:, 0]


def bilstm(x, params, impl="kernel", dropout_rate=0.0, generator=None):
    """Multi-layer bidirectional LSTM. x: [T, B, I] -> [T, B, 2H].

    ``dropout_rate`` > 0 drops between layers, never after the last, with
    masks from ``generator`` (JAX: ops/lstm.py:138-146); inference passes
    0.
    """
    n = len(params)
    for li, p in enumerate(params):
        x = bidir_layer(x, p, impl)
        if li < n - 1:
            x = _dropout.dropout(x, dropout_rate, generator)
    return x
