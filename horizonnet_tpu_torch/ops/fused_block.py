"""Fused identity ResNet bottleneck: the CUDA kernel and its plain twin.

Counterpart of horizonnet_tpu/ops/pallas_block.py::fused_bottleneck (K4,
``_block_kernel``), the serving-only block that the JAX package runs with
``fused_blocks="pallas"``. The kernel is ``csrc/fused_bottleneck.cu``; its
header says what bounds it on the H100 and how it is tiled.

Contract, shared by the kernel and the twin (NHWC, as in JAX):
  x  [B, H, W, C]   float32 or bfloat16
  w1 [C, Wd], w2 [3, 3, Wd, Wd] (kh, kw, in, out), w3 [Wd, C]: conv
                    kernels with batch norm folded in (``fold_conv_bn``),
                    cast to x's dtype before use
  b1 [Wd], b2 [Wd], b3 [C]: float32 biases
  -> y [B, H, W, C] in x's dtype
with the rounding points of the JAX kernel:
  m  = relu(x . w1 + b1)                 rounded to x's dtype
  m2 = relu(conv3x3(m) + b2)             rounded; W wraps, H is zero-padded
                                         in m's space (pallas_block.py:72-79)
  y  = relu(m2 . w3 + b3 + x)            summed in f32, rounded once
Products take dtype inputs and sum in f32.

``fused_bottleneck`` launches the kernel for a CUDA tensor and runs the
twin for a CPU tensor; there is no fallback from one to the other. A bf16
launch the card refuses (its thread-block cluster or its TMA maps) raises.
"""

import ctypes

import torch

#: Number of calls that launched the CUDA kernel (one per block).
launches = 0

_SMEM_LIMIT = 232448  # bytes of dynamic shared memory a Hopper CTA may use


def fold_conv_bn(kernel, gamma, beta, mean, var, eps=1e-5):
    """Fold an inference-mode batch norm into the conv before it.

    kernel: [kh, kw, Cin, Cout] (no conv bias in the resnet family).
    BN(conv(x)) == conv'(x) + b' with conv' = kernel * s and
    b' = beta - mean * s, s = gamma / sqrt(var + eps). Returns
    (folded kernel in float32, bias in float32 [Cout]).
    """
    s = gamma.float() / torch.sqrt(var.float() + eps)
    return kernel.float() * s, beta.float() - mean.float() * s


def _check(x, w1, b1, w2, b2, w3, b3):
    if x.dim() != 4:
        raise ValueError(f"x {tuple(x.shape)} is not [B, H, W, C]")
    C = x.shape[-1]
    Wd = w1.shape[-1]
    if (w1.shape != (C, Wd) or w2.shape != (3, 3, Wd, Wd)
            or w3.shape != (Wd, C) or b1.shape != (Wd,)
            or b2.shape != (Wd,) or b3.shape != (C,)):
        raise ValueError(
            f"shapes x {tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 "
            f"{tuple(w2.shape)}, w3 {tuple(w3.shape)}, biases "
            f"{tuple(b1.shape)} {tuple(b2.shape)} {tuple(b3.shape)} break the "
            "[C,Wd] / [3,3,Wd,Wd] / [Wd,C] contract")
    return C, Wd


def fused_bottleneck_plain(x, w1, b1, w2, b2, w3, b3):
    """Plain PyTorch twin of the kernel (NHWC), same rounding points."""
    _check(x, w1, b1, w2, b2, w3, b3)
    dt = x.dtype
    w1, w2, w3 = (w.to(dt).float() for w in (w1, w2, w3))
    xf = x.float()
    m = torch.relu(xf @ w1 + b1.float()).to(dt).float()
    # zero rows above and below (in m's space), wrapped columns
    zrow = torch.zeros_like(m[:, :1])
    mp = torch.cat([zrow, m, zrow], dim=1)
    mp = torch.cat([mp[:, :, -1:], mp, mp[:, :, :1]], dim=2)
    H, W = x.shape[1], x.shape[2]
    acc = b2.float().expand(*m.shape).clone()
    for dy in range(3):
        for dx in range(3):
            acc = acc + mp[:, dy:dy + H, dx:dx + W] @ w2[dy, dx]
    m2 = torch.relu(acc).to(dt).float()
    return torch.relu(m2 @ w3 + b3.float() + xf).to(dt)


def _library():
    from ._build import load_kernel_library

    lib = load_kernel_library("fused_bottleneck")
    lib.fused_bottleneck.argtypes = ([ctypes.c_void_p] * 8
                                     + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.fused_bottleneck.restype = ctypes.c_int
    lib.fused_bottleneck_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fused_bottleneck_smem_bytes.restype = ctypes.c_size_t
    lib.fused_bottleneck_weight_bytes.argtypes = [ctypes.c_int] * 4
    lib.fused_bottleneck_weight_bytes.restype = ctypes.c_size_t
    lib.fused_bottleneck_bf16_max_width.argtypes = []
    lib.fused_bottleneck_bf16_max_width.restype = ctypes.c_int
    lib.fused_bottleneck_error_string.argtypes = [ctypes.c_int]
    lib.fused_bottleneck_error_string.restype = ctypes.c_char_p
    return lib


def build():
    """Build (or load the cached build of) the kernel library."""
    _library()


def weight_bytes(B, H, W, Wd):
    """Bytes of folded weights one bf16 launch at [B, H, W, 4 Wd] reads
    from L2 (each weight slice once per CTA cluster)."""
    return _library().fused_bottleneck_weight_bytes(B, H, W, Wd)


def fused_bottleneck_cuda(x, w1, b1, w2, b2, w3, b3):
    """Launch the kernel on the current stream. Raises on any failure.

    x may be a non-contiguous view only if it is NHWC-contiguous (a
    channels_last NCHW tensor permuted to NHWC is); the weights are laid
    out for the kernel here (output channel major, a few MB at most)."""
    global launches
    C, Wd = _check(x, w1, b1, w2, b2, w3, b3)
    tensors = (x, w1, b1, w2, b2, w3, b3)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("fused_bottleneck_cuda takes CUDA tensors on one "
                         "device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x {x.dtype}: the kernel takes float32 or bfloat16")
    if Wd % 16 or C != 4 * Wd:
        raise ValueError(f"width {Wd} and channels {C}: the kernel needs a "
                         "width that is a multiple of 16 and C = 4 * width")
    lib = _library()
    is_bf16 = int(x.dtype == torch.bfloat16)
    if is_bf16 and Wd > lib.fused_bottleneck_bf16_max_width():
        raise ValueError(f"no bf16 tile plan for width {Wd} (the widest is "
                         f"{lib.fused_bottleneck_bf16_max_width()})")
    if lib.fused_bottleneck_smem_bytes(Wd, is_bf16) > _SMEM_LIMIT:
        raise ValueError(f"width {Wd} needs more shared memory than a CTA "
                         "has")
    B, H, W, _ = x.shape
    dt = x.dtype
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    # output channel major: each output channel's taps are contiguous
    w1t = w1.to(dt).t().contiguous()                      # [Wd, C]
    w2t = w2.to(dt).permute(0, 1, 3, 2).contiguous()      # [3, 3, Wd, Wd]
    w3t = w3.to(dt).t().contiguous()                      # [C, Wd]
    b1, b2, b3 = (b.float().contiguous() for b in (b1, b2, b3))
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.fused_bottleneck(
            x.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
            b2.data_ptr(), w3t.data_ptr(), b3.data_ptr(), y.data_ptr(),
            B, H, W, C, Wd, is_bf16, stream)
    if err != 0:
        raise RuntimeError("fused_bottleneck launch failed: "
                           + lib.fused_bottleneck_error_string(err).decode())
    launches += 1
    return y


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3):
    """The kernel for a CUDA tensor, the plain twin for a CPU tensor."""
    if x.device.type == "cuda":
        return fused_bottleneck_cuda(x, w1, b1, w2, b2, w3, b3)
    if x.device.type == "cpu":
        return fused_bottleneck_plain(x, w1, b1, w2, b2, w3, b3)
    raise ValueError(f"no fused bottleneck for device {x.device}")
