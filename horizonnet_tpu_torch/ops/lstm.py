"""Bidirectional multi-layer LSTM: hoisted input projection + recurrence.

Counterpart of horizonnet_tpu/ops/lstm.py (the reference's cuDNN LSTM,
model.py:221-227: 2 layers, hidden 512, bidirectional, sequence-first over
the pano columns). The input projection x @ W_ih^T + b for all steps and
both directions is one matmul outside the recurrence, as in JAX; the
recurrence is ops/cuda_lstm.py. Gate order i, f, g, o.

``impl``:
  "kernel"  the CUDA kernel for a CUDA tensor, its plain twin for a CPU
            tensor (ops/cuda_lstm.py::bilstm_recurrence);
  "plain"   the plain twin on any device (the CLI's ``--lstm_impl scan``).
"""

import torch

from .cuda_lstm import bilstm_recurrence, bilstm_recurrence_plain

IMPLS = ("kernel", "plain")


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
    run = bilstm_recurrence if impl == "kernel" else bilstm_recurrence_plain
    ys = run(xw.contiguous(), w_hh_t.contiguous())      # [T, D, B, H]
    if D == 2:
        return torch.cat([ys[:, 0], ys[:, 1].flip(0)], dim=-1)
    return ys[:, 0]


def bilstm(x, params, impl="kernel"):
    """Multi-layer bidirectional LSTM, inference. x: [T, B, I] -> [T, B, 2H].

    Dropout between layers is a training-time op and is not applied.
    """
    for p in params:
        x = bidir_layer(x, p, impl)
    return x
