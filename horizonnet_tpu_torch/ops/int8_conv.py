"""int8 convolution with int32 accumulation: int8 im2col + ``torch._int_mm``.

The JAX package computes models/layers.py::QuantConvBN's product in XLA,
outside any Pallas kernel (horizonnet_tpu/models/layers.py:150-154:
``lax.conv_general_dilated`` on int8 with ``preferred_element_type``
int32). PyTorch has no int8 convolution on CUDA, so the port writes it as
a matrix product: the padded int8 input is cut into im2col rows (a
strided view and one copy, which works for any dtype), and
``torch._int_mm`` (on CUDA cuBLASLt's int8 tensor-core GEMM) multiplies
them by the kernel, accumulating in int32. Integer sums are exact, so the
result equals any other int8 convolution's bit for bit, on the CPU and
on the card.

On CUDA ``_int_mm`` takes more than 16 rows and a depth and width that
are multiples of 8: rows, depth and width are padded with zeros, which
is exact. A grouped convolution runs one product per group. Nothing
falls back to a float convolution; a shape ``_int_mm`` still refuses
raises.
"""

import torch
import torch.nn.functional as F


def _up8(n):
    return -(-n // 8) * 8


def pad_nhwc(xq, ph, pw):
    """Zeros on the height (``ph`` rows each side) and the circular wrap
    on the width (``pw`` columns each side) of NHWC ``xq``, in one
    buffer. Zeros are exact in the quantized domain."""
    if not (ph or pw):
        return xq
    B, H, W, C = xq.shape
    out = xq.new_zeros(B, H + 2 * ph, W + 2 * pw, C)
    rows = out[:, ph:ph + H]
    rows[:, :, pw:pw + W] = xq
    if pw:
        rows[:, :, :pw] = xq[:, :, W - pw:]
        rows[:, :, pw + W:] = xq[:, :, :pw]
    return out


def int8_conv_nhwc(xq, weight_q, stride=(1, 1), padding=(0, 0), groups=1):
    """int32 sums of an int8 convolution.

    xq: int8 [B, H, W, C] (NHWC); weight_q: int8 [O, C / groups, kh, kw]
    (OIHW); the height is zero-padded by ``padding[0]`` and the width
    wrap-padded by ``padding[1]``. Returns int32 [B, Ho, Wo, O]."""
    if xq.dtype != torch.int8 or weight_q.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {xq.dtype} and "
                        f"{weight_q.dtype}")
    B, H, W, C = xq.shape
    O, Cg, kh, kw = weight_q.shape
    if Cg * groups != C or O % groups:
        raise ValueError(f"input channels {C} and kernel "
                         f"{tuple(weight_q.shape)} do not fit {groups} groups")
    sh, sw = stride
    xp = pad_nhwc(xq, *padding)
    Ho = (xp.shape[1] - kh) // sh + 1
    Wo = (xp.shape[2] - kw) // sw + 1
    M, K, Og = B * Ho * Wo, Cg * kh * kw, O // groups
    Mp, Kp, Np = max(M, 17), _up8(K), _up8(Og)
    w = weight_q.reshape(O, K)
    win = (None if kh == kw == 1 and groups == 1 and (Mp, Kp) == (M, K)
           else xp.unfold(1, kh, sh).unfold(2, kw, sw))  # [B,Ho,Wo,C,kh,kw]
    outs = []
    for g in range(groups):
        if win is None:
            a = xp[:, ::sh, ::sw].reshape(M, C)         # a view at stride 1
        else:
            a = (xq.new_zeros(Mp, Kp) if (Mp, Kp) != (M, K)
                 else xq.new_empty(M, K))
            a[:M, :K].view(B, Ho, Wo, Cg, kh, kw).copy_(
                win[:, :, :, g * Cg:(g + 1) * Cg])
        b = F.pad(w[g * Og:(g + 1) * Og], (0, Kp - K, 0, Np - Og))
        try:
            y = torch._int_mm(a, b.contiguous().t())
        except RuntimeError as e:
            raise RuntimeError(f"torch._int_mm refused [{Mp}, {Kp}] x "
                               f"[{Kp}, {Np}] (conv of {tuple(xq.shape)} by "
                               f"{tuple(weight_q.shape)}): {e}") from None
        outs.append(y if (Mp, Np) == (M, Og) else y[:M, :Og])
    y = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return y.reshape(B, Ho, Wo, O)
