"""Horizontal wrap padding: the equirectangular seam is periodic.

Counterpart of horizonnet_tpu/ops/pad.py: ``wrap_pad_width`` (the
reference's lr_pad, model.py:27-29) and ``seam_layout``, the geometry of
models/layers.py::WrapConv's ``seam_fix`` path, which pads nothing.

``wrap_pad_width`` is an autograd.Function over a 4-D tensor padded on its
width (dim 3). On a CUDA tensor its forward and its backward launch K5
(``csrc/wrap_pad.cu``; its header says what bounds it and how it is laid
out): ``wrap_pad_cuda`` writes the padded copy in one pass, and
``wrap_fold_cuda`` folds the padded gradient back into the input's in one
pass. On any other device (the CPU; the meta device of utils/flops.py's
count) the forward is ``wrap_pad_plain`` (torch.cat of the edge columns
around x) and the backward ``wrap_fold_plain``, the fold's plain twin,
which K5's fold equals bit for bit. There is no fallback from one device's
path to the other's. K5 takes float32 and bfloat16 tensors that are dense
as NCHW or as channels_last, padded by 0 < pad <= W.

The fold sums the three gradients of a column in float32 and rounds once.
With W >= 2 pad a column has at most two terms besides exact zeros, so
the fold equals torch.cat's autograd bit for bit. With W < 2 pad (the
deepest map of the 512x32 parallel dry runs, 1 wide under a pad of 1) a
column may take three terms, which autograd sums in the tensor's dtype in
its own order: there the fold rounds once where autograd rounds twice.
"""

import ctypes

import torch

from . import launch_counts

#: Number of times K5's pad (forward) and fold (backward) were launched: a
#: call that launches one adds one; a captured program (program.py) adds
#: its captured launches on each replay, and none while it is captured.
fwd_launches = 0
bwd_launches = 0
launch_counts.register(__name__, "fwd_launches")
launch_counts.register(__name__, "bwd_launches")

DTYPES = (torch.float32, torch.bfloat16)


def _check(t, W, pad):
    if t.dim() != 4:
        raise ValueError(f"wrap pad: {tuple(t.shape)} is not [B, C, H, W]")
    if t.dtype not in DTYPES:
        raise TypeError(f"wrap pad: {t.dtype}; K5 takes float32 or "
                        "bfloat16")
    if pad <= 0 or pad > W:
        raise ValueError(f"wrap pad: width {W} by {pad}; K5 needs 0 < pad "
                         "<= W")


def _layout(t):
    """(memory format, R, E) of ``t`` seen as rows [R, W, E]: NCHW rows of
    one element a column, or channels_last rows of C; raises for any other
    layout."""
    B, C, H, _ = t.shape
    if t.is_contiguous():
        return torch.contiguous_format, B * C * H, 1
    if t.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last, B * H, C
    raise ValueError(f"wrap pad: strides {t.stride()} of {tuple(t.shape)} "
                     "are neither dense NCHW nor dense channels_last")


def _unit(col_bytes, *tensors):
    """The widest access, 16 to 2 bytes, that divides a column and the
    tensors' addresses."""
    for u in (16, 8, 4, 2):
        if col_bytes % u == 0 and all(t.data_ptr() % u == 0
                                      for t in tensors):
            return u
    raise ValueError(f"wrap pad: a column of {col_bytes} bytes")


def _library():
    from ._build import load_kernel_library

    lib = load_kernel_library("wrap_pad")
    for fn in (lib.wrap_pad_fwd, lib.wrap_fold_bwd):
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.wrap_pad_error_string.argtypes = [ctypes.c_int]
    lib.wrap_pad_error_string.restype = ctypes.c_char_p
    return lib


def build():
    """Build (or load the cached build of) the kernel library."""
    _library()


def _launch(name, src, dst, R, W, pad, E, arg):
    """Launch ``name`` on the current stream from src into dst; raises on
    any failure."""
    if not src.is_cuda:
        raise ValueError(f"{name} takes a CUDA tensor")
    unit = _unit(E * src.element_size(), src, dst)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    lib = _library()
    with torch.cuda.device(src.device):
        err = getattr(lib, name)(src.data_ptr(), dst.data_ptr(), R, W, pad,
                                 E, arg, unit, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.wrap_pad_error_string(err).decode())


def wrap_pad_cuda(x, pad):
    """K5's pad: x [B, C, H, W] -> [B, C, H, W + 2 pad] in x's layout."""
    global fwd_launches
    _check(x, x.shape[-1], pad)
    B, C, H, W = x.shape
    fmt, R, E = _layout(x)
    out = torch.empty((B, C, H, W + 2 * pad), dtype=x.dtype,
                      device=x.device, memory_format=fmt)
    _launch("wrap_pad_fwd", x, out, R, W, pad, E, x.element_size())
    fwd_launches += 1
    return out


def wrap_fold_cuda(dpad, pad):
    """K5's fold: the gradient of ``wrap_pad_cuda`` at dpad [B, C, H, W + 2
    pad] -> [B, C, H, W] in dpad's layout."""
    global bwd_launches
    _check(dpad, dpad.shape[-1] - 2 * pad, pad)
    B, C, H, W = dpad.shape[:3] + (dpad.shape[3] - 2 * pad,)
    fmt, R, E = _layout(dpad)
    dx = torch.empty((B, C, H, W), dtype=dpad.dtype, device=dpad.device,
                     memory_format=fmt)
    _launch("wrap_fold_bwd", dpad, dx, R, W, pad, E,
            int(dpad.dtype == torch.bfloat16))
    bwd_launches += 1
    return dx


def wrap_pad_plain(x, pad):
    """Plain twin of K5's pad: the two edge runs around x, by torch.cat."""
    W = x.shape[3]
    return torch.cat([x.narrow(3, W - pad, pad), x, x.narrow(3, 0, pad)],
                     dim=3)


def wrap_fold_plain(dpad, pad):
    """Plain twin of K5's fold: each column's gradient plus the left pad's
    copy of it, plus the right pad's (+0 where no copy lands), summed in
    float32 in that order and rounded once."""
    W = dpad.shape[3] - 2 * pad
    d = dpad.float()
    left = torch.nn.functional.pad(d[..., :pad], (W - pad, 0))
    right = torch.nn.functional.pad(d[..., W + pad:], (0, W - pad))
    return ((d[..., pad:pad + W] + left) + right).to(dpad.dtype)


class WrapPadFunction(torch.autograd.Function):
    """The wrap pad of dim 3 and its fold; keeps nothing for the backward
    but the pad."""

    @staticmethod
    def forward(ctx, x, pad):
        ctx.pad = pad
        if x.device.type == "cuda":
            return wrap_pad_cuda(x, pad)
        return wrap_pad_plain(x, pad)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dpad):
        if dpad.device.type == "cuda":
            return wrap_fold_cuda(dpad, ctx.pad), None
        return wrap_fold_plain(dpad, ctx.pad), None


def wrap_pad_width(x, pad: int, dim: int = -1):
    """Circularly pad ``x`` [B, C, H, W] (float32 or bfloat16) along its
    width (``dim`` 3 or -1) by ``pad`` on each side: the left pad is a
    copy of the rightmost columns and vice versa; 0 <= pad <= W."""
    if pad == 0:
        return x
    if x.dim() != 4 or dim not in (3, -1):
        raise ValueError(f"wrap_pad_width pads dim 3 of a 4-D tensor, not "
                         f"dim {dim} of {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"wrap_pad_width: {x.dtype}; float32 or bfloat16")
    return WrapPadFunction.apply(x, pad)


def seam_layout(W: int, kw: int, sw: int, pw: int):
    """Geometry of the seam-correction strip for a width-wrapped conv
    (copied from horizonnet_tpu/ops/pad.py::seam_layout).

    For a conv of kernel width ``kw``, width stride ``sw`` and symmetric
    wrap padding ``pw`` over input width ``W``, the zero-padded conv
    already gives the right output everywhere except the output columns
    whose window crosses the seam. Those are exactly the outputs of one
    unpadded conv over the wrapped strip ``cat(x[..., W-a:], x[..., :b])``,
    in the order [right-edge columns..., left-edge columns...].

    Returns (n_left, n_right, a, b), or None when the preconditions do not
    hold (the caller then takes the materialized wrap pad):
    - pw == (kw-1)/2 (odd kernel, torch-style symmetric padding), and
    - W % sw == 0, so the strip's stride phase continues the main conv's.
    """
    if pw <= 0 or kw % 2 == 0 or 2 * pw != kw - 1 or W % sw != 0:
        return None
    w_out = (W + 2 * pw - kw) // sw + 1
    if w_out * sw != W:
        return None
    n_left = -(-pw // sw)                       # ceil(pw / sw)
    j_r0 = (W - kw + pw) // sw + 1              # first seam-crossing right col
    n_right = w_out - j_r0
    a = W - (j_r0 * sw - pw)                    # right-end input cols
    b = (n_left - 1) * sw - pw + kw             # wrapped left input cols
    if n_left + n_right >= w_out or a > W or b > W or a < 0 or b < 0:
        return None
    assert a + b == (n_left + n_right - 1) * sw + kw, (a, b, n_left, n_right)
    return n_left, n_right, a, b
