"""Fused bidirectional LSTM recurrence: the CUDA kernel and its plain twin.

Counterpart of horizonnet_tpu/ops/pallas_lstm.py::bilstm_recurrence_pallas
(the serving forward, K1). The kernel is ``csrc/bilstm_fwd.cu``; its
header says what bounds it on the H100 and how it is laid out.

Contract, shared by the kernel and the twin:
  xw     [T, D, B, 4H]  hoisted input projections + bias, direction 1
                        already time-reversed (ops/lstm.py builds them)
  w_hh_t [D, H, 4H]     recurrent weights, transposed
  ->     [T, D, B, H]   per-step hidden states in xw's dtype
Gate order i, f, g, o, zero initial state; h and c in f32, W converted
to f32 before the product. The kernel is one cooperative launch per
recurrence whose (H / 8, D) CTAs must all be resident at once; a launch
the card refuses raises. For bf16 it runs the products on the tensor cores
with h split exactly into three bf16 terms (``split_bf16x3`` spells the
split out; nothing on the main path calls it).

``bilstm_recurrence`` launches the kernel for a CUDA tensor and runs the
twin for a CPU tensor; there is no fallback from one to the other.
"""

import ctypes

import torch

#: Number of calls that launched the CUDA kernel (one per recurrence).
launches = 0

_SMEM_LIMIT = 232448  # bytes of dynamic shared memory a Hopper CTA may use


def bilstm_recurrence_plain(xw, w_hh_t):
    """Plain PyTorch twin of the kernel: a Python loop over T, f32 cell.
    Differentiable by autograd (the "plain" training path)."""
    T, D, B, G = xw.shape
    H = G // 4
    if w_hh_t.shape != (D, H, G):
        raise ValueError(f"w_hh_t {tuple(w_hh_t.shape)} != {(D, H, G)}")
    w = w_hh_t.float()
    h = torch.zeros(D, B, H, dtype=torch.float32, device=xw.device)
    c = torch.zeros_like(h)
    ys = []
    for t in range(T):
        gates = xw[t].float() + torch.bmm(h, w)
        i, f, g, o = gates.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys).to(xw.dtype)


def split_bf16x3(h):
    """The kernel's exact split of f32 ``h`` into three bfloat16 terms.

    hi = bf16(h), mid = bf16(h - hi), lo = bf16(h - hi - mid), each rounded
    to nearest. Three 8-bit significands cover f32's 24, so
    hi + mid + lo == h exactly (down to where lo would fall below bf16's
    smallest normal), and with a bf16 W each of the three products
    W^T term is exact: the kernel sums them in f32 on the tensor cores.
    """
    h = h.float()
    hi = h.to(torch.bfloat16)
    r = h - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def _library():
    from ._build import load_kernel_library

    lib = load_kernel_library("bilstm_fwd")
    lib.bilstm_fwd.argtypes = ([ctypes.c_void_p] * 6
                               + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.bilstm_fwd.restype = ctypes.c_int
    lib.bilstm_fwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.bilstm_fwd_smem_bytes.restype = ctypes.c_size_t
    for fn in (lib.bilstm_fwd_h_multiple, lib.bilstm_fwd_max_h):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    lib.bilstm_fwd_error_string.argtypes = [ctypes.c_int]
    lib.bilstm_fwd_error_string.restype = ctypes.c_char_p
    return lib


def build():
    """Build (or load the cached build of) the kernel library."""
    _library()


def bilstm_recurrence_cuda(xw, w_hh_t):
    """Launch the kernel on the current stream. Raises on any failure."""
    global launches
    if not (xw.is_cuda and w_hh_t.is_cuda and xw.device == w_hh_t.device):
        raise ValueError("bilstm_recurrence_cuda takes CUDA tensors on one "
                         "device")
    if xw.dtype not in (torch.float32, torch.bfloat16) \
            or w_hh_t.dtype != xw.dtype:
        raise TypeError(f"xw {xw.dtype} / w_hh_t {w_hh_t.dtype}: both must "
                        "be float32 or both bfloat16")
    T, D, B, G = xw.shape
    H = G // 4
    if G != 4 * H or w_hh_t.shape != (D, H, G):
        raise ValueError(f"shapes xw {tuple(xw.shape)}, w_hh_t "
                         f"{tuple(w_hh_t.shape)} break the [T,D,B,4H] / "
                         "[D,H,4H] contract")
    lib = _library()
    is_bf16 = int(xw.dtype == torch.bfloat16)
    if H % lib.bilstm_fwd_h_multiple() or H > lib.bilstm_fwd_max_h():
        raise ValueError(f"hidden size {H} must be a multiple of "
                         f"{lib.bilstm_fwd_h_multiple()} and at most "
                         f"{lib.bilstm_fwd_max_h()}")
    if lib.bilstm_fwd_smem_bytes(H, is_bf16) > _SMEM_LIMIT:
        raise ValueError(f"hidden size {H} needs more shared memory than a "
                         "CTA has")
    xw = xw.contiguous()
    w_hh_t = w_hh_t.contiguous()
    ys = torch.empty(T, D, B, H, dtype=xw.dtype, device=xw.device)
    h_buf = torch.empty(2, D, B, H, dtype=torch.float32, device=xw.device)
    c_buf = torch.empty(D, B, H, dtype=torch.float32, device=xw.device)
    flags = torch.empty(D, dtype=torch.int32, device=xw.device)
    stream = torch.cuda.current_stream(xw.device).cuda_stream
    with torch.cuda.device(xw.device):
        err = lib.bilstm_fwd(xw.data_ptr(), w_hh_t.data_ptr(), ys.data_ptr(),
                             h_buf.data_ptr(), c_buf.data_ptr(),
                             flags.data_ptr(), T, D, B, H, is_bf16, stream)
    if err != 0:
        raise RuntimeError("bilstm_fwd launch failed: "
                           + lib.bilstm_fwd_error_string(err).decode())
    launches += 1
    return ys


def bilstm_recurrence(xw, w_hh_t):
    """The kernel for a CUDA tensor, the plain twin for a CPU tensor."""
    if xw.device.type == "cuda":
        return bilstm_recurrence_cuda(xw, w_hh_t)
    if xw.device.type == "cpu":
        return bilstm_recurrence_plain(xw, w_hh_t)
    raise ValueError(f"no bilstm recurrence for device {xw.device}")
