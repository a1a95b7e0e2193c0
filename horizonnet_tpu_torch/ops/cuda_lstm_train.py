"""The LSTM recurrence for training: K2, K3, their plain twins, and the
autograd.Function that joins them.

Counterpart of horizonnet_tpu/ops/pallas_lstm.py::bilstm_recurrence_trainable,
the custom_vjp whose forward is ``_train_fwd`` (K2,
``_bilstm_train_fwd_kernel``) and whose backward is ``_train_bwd`` (K3,
``_bilstm_bwd_kernel``, plus the weight gradient as one product). The
kernels are ``csrc/bilstm_train.cu``; its header says what bounds them on
the H100 and how they are laid out.

Contract, shared by the kernels and the twins (the serving contract of
ops/cuda_lstm.py, plus residuals):
  xw     [T, D, B, 4H]  hoisted input projections + bias, direction 1
                        already time-reversed
  w_hh_t [D, H, 4H]     recurrent weights, transposed, xw's dtype
  K2 ->  ys [T, D, B, H], gates [T, D, B, 4H] (post-activation i, f, g, o)
         and cs [T, D, B, H] (cell states), all in xw's dtype
  K3:    gates, cs, dys [T, D, B, H] (gates' dtype) -> dxw [T, D, B, 4H]
         in the gates' dtype; dh and dc carried in f32
  dW [D, H, 4H] = sum over (t, b) of h_{t-1} da_t, in f32, cast to
  w_hh_t's dtype (a torch.einsum, as JAX leaves it to XLA).

Each kernel is one cooperative launch per recurrence whose CTAs ((H / 8, D)
for K2, (H / 16, D) for K3) must all be resident at once; a launch the
card refuses raises. In bf16 both run their products on the tensor cores
with the f32 operand (h in K2, da in K3) split exactly into three bf16
terms (``cuda_lstm.split_bf16x3``), which keeps the f32 contract.

``bilstm_recurrence_trainable`` launches the kernels for CUDA tensors and
runs the twins for CPU tensors; there is no fallback from one to the other.
Both launches are stream operations (as K1's, ops/cuda_lstm.py), so a CUDA
graph of the train step captures K2 in the forward and K3 inside the
backward, which autograd runs on the forward's stream.
"""

import ctypes

import torch

from . import launch_counts

#: Number of times K2 was launched (one per forward recurrence) and K3
#: (one per backward recurrence): a call that launches one adds one; a
#: captured train step (program.py) adds its captured launches on each
#: replay, and none while it is captured.
fwd_launches = 0
bwd_launches = 0
launch_counts.register(__name__, "fwd_launches")
launch_counts.register(__name__, "bwd_launches")

def _check_shapes(xw_like, w_hh_t):
    T, D, B, G = xw_like.shape
    H = G // 4
    if G != 4 * H or w_hh_t.shape != (D, H, G):
        raise ValueError(f"shapes {tuple(xw_like.shape)}, w_hh_t "
                         f"{tuple(w_hh_t.shape)} break the [T,D,B,4H] / "
                         "[D,H,4H] contract")
    return T, D, B, H


def train_fwd_plain(xw, w_hh_t):
    """Plain twin of K2: (ys, gates, cs) in xw's dtype, f32 cell."""
    T, D, B, H = _check_shapes(xw, w_hh_t)
    w = w_hh_t.float()
    h = torch.zeros(D, B, H, dtype=torch.float32, device=xw.device)
    c = torch.zeros_like(h)
    ys, gates, cs = [], [], []
    for t in range(T):
        a = xw[t].float() + torch.bmm(h, w)
        i, f, g, o = a.split(H, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
        gates.append(torch.cat([i, f, g, o], dim=-1))
        cs.append(c)
    return tuple(torch.stack(s).to(xw.dtype) for s in (ys, gates, cs))


def train_bwd_plain(gates, cs, dys, w_hh_t):
    """Plain twin of K3: dxw in the gates' dtype, reverse time, f32
    carries (pallas_lstm.py:87-134)."""
    T, D, B, H = _check_shapes(gates, w_hh_t)
    w_t = w_hh_t.float().transpose(1, 2)                 # [D, 4H, H]
    dh_carry = torch.zeros(D, B, H, dtype=torch.float32, device=gates.device)
    dc_carry = torch.zeros_like(dh_carry)
    dxw = [None] * T
    for t in range(T - 1, -1, -1):
        i, f, g, o = gates[t].float().split(H, dim=-1)
        c_t = cs[t].float()
        c_prev = cs[t - 1].float() if t > 0 else torch.zeros_like(c_t)
        dh = dys[t].float() + dh_carry
        tc = torch.tanh(c_t)
        da_o = dh * tc * o * (1.0 - o)
        dc = dh * o * (1.0 - tc * tc) + dc_carry
        da_f = dc * c_prev * f * (1.0 - f)
        da_i = dc * g * i * (1.0 - i)
        da_g = dc * i * (1.0 - g * g)
        da = torch.cat([da_i, da_f, da_g, da_o], dim=-1)
        dxw[t] = da
        dh_carry = torch.bmm(da, w_t)
        dc_carry = dc * f
    return torch.stack(dxw).to(gates.dtype)


def weight_grad(ys, dxw, w_hh_t):
    """dW[d, h, g] = sum over (t, b) of h_{t-1}[t, d, b, h] dxw[t, d, b, g]
    in f32 (h_{-1} = 0), cast to w_hh_t's dtype (pallas_lstm.py:204-210)."""
    h_prev = torch.cat([torch.zeros_like(ys[:1]), ys[:-1]]).float()
    return torch.einsum("tdbh,tdbg->dhg", h_prev,
                        dxw.float()).to(w_hh_t.dtype)


def bind(lib):
    """Declare the C interface of a loaded ``bilstm_train`` library."""
    lib.bilstm_train_fwd.argtypes = ([ctypes.c_void_p] * 8
                                     + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.bilstm_train_fwd.restype = ctypes.c_int
    lib.bilstm_bwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                               + [ctypes.c_void_p])
    lib.bilstm_bwd.restype = ctypes.c_int
    for fn in (lib.bilstm_train_fwd_max_h, lib.bilstm_bwd_max_h):
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_int
    lib.bilstm_train_h_multiple.argtypes = []
    lib.bilstm_train_h_multiple.restype = ctypes.c_int
    lib.bilstm_train_error_string.argtypes = [ctypes.c_int]
    lib.bilstm_train_error_string.restype = ctypes.c_char_p
    return lib


def _library():
    from ._build import load_kernel_library

    return bind(load_kernel_library("bilstm_train"))


def build():
    """Build (or load the cached build of) the kernel library."""
    _library()


def _check_tensors(tensors):
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError("the LSTM training kernels take CUDA tensors on one "
                         "device")
    dtype = tensors[0].dtype
    if dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"dtypes {[t.dtype for t in tensors]}: all must be "
                        "float32 or all bfloat16")


def _check_hidden(H, lib, max_h, is_bf16):
    """Refuse, before launching, a hidden size the kernel does not take:
    a multiple of the bf16 products' K slice, at most what W's slice fits
    in (registers in bf16, the device's shared memory in f32)."""
    m, top = lib.bilstm_train_h_multiple(), max_h(is_bf16)
    if H % m or H > top:
        raise ValueError(f"hidden size {H} must be a multiple of {m} and at "
                         f"most {top}")


def _raise_on(err, lib, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.bilstm_train_error_string(err).decode())


def train_fwd_cuda(xw, w_hh_t):
    """Launch K2 on the current stream -> (ys, gates, cs). Raises on any
    failure."""
    global fwd_launches
    T, D, B, H = _check_shapes(xw, w_hh_t)
    _check_tensors((xw, w_hh_t))
    lib = _library()
    is_bf16 = int(xw.dtype == torch.bfloat16)
    with torch.cuda.device(xw.device):
        _check_hidden(H, lib, lib.bilstm_train_fwd_max_h, is_bf16)
    xw, w_hh_t = xw.contiguous(), w_hh_t.contiguous()
    new = lambda *s, dtype=xw.dtype: torch.empty(  # noqa: E731
        *s, dtype=dtype, device=xw.device)
    ys, gates, cs = new(T, D, B, H), new(T, D, B, 4 * H), new(T, D, B, H)
    h_buf = new(2, D, B, H, dtype=torch.float32)
    c_buf = new(D, B, H, dtype=torch.float32)
    flags = new(D, dtype=torch.int32)
    stream = torch.cuda.current_stream(xw.device).cuda_stream
    with torch.cuda.device(xw.device):
        err = lib.bilstm_train_fwd(
            xw.data_ptr(), w_hh_t.data_ptr(), ys.data_ptr(), gates.data_ptr(),
            cs.data_ptr(), h_buf.data_ptr(), c_buf.data_ptr(),
            flags.data_ptr(), T, D, B, H, is_bf16, stream)
    _raise_on(err, lib, "bilstm_train_fwd")
    fwd_launches += 1
    return ys, gates, cs


def train_bwd_cuda(gates, cs, dys, w_hh_t):
    """Launch K3 on the current stream -> dxw. Raises on any failure."""
    global bwd_launches
    T, D, B, H = _check_shapes(gates, w_hh_t)
    if cs.shape != (T, D, B, H) or dys.shape != (T, D, B, H):
        raise ValueError(f"cs {tuple(cs.shape)} / dys {tuple(dys.shape)} != "
                         f"{(T, D, B, H)}")
    _check_tensors((gates, cs, dys, w_hh_t))
    lib = _library()
    is_bf16 = int(gates.dtype == torch.bfloat16)
    with torch.cuda.device(gates.device):
        _check_hidden(H, lib, lib.bilstm_bwd_max_h, is_bf16)
    gates, cs, dys, w_hh_t = (t.contiguous() for t in (gates, cs, dys, w_hh_t))
    dxw = torch.empty_like(gates)
    da_buf = torch.empty(2, D, B, 4 * H, dtype=torch.float32,
                         device=gates.device)
    dc_buf = torch.empty(D, B, H, dtype=torch.float32, device=gates.device)
    flags = torch.empty(D, dtype=torch.int32, device=gates.device)
    stream = torch.cuda.current_stream(gates.device).cuda_stream
    with torch.cuda.device(gates.device):
        err = lib.bilstm_bwd(
            gates.data_ptr(), cs.data_ptr(), dys.data_ptr(),
            w_hh_t.data_ptr(), dxw.data_ptr(), da_buf.data_ptr(),
            dc_buf.data_ptr(), flags.data_ptr(), T, D, B, H, is_bf16, stream)
    _raise_on(err, lib, "bilstm_bwd")
    bwd_launches += 1
    return dxw


def _dispatch(cuda_fn, plain_fn, x, *args):
    if x.device.type == "cuda":
        return cuda_fn(x, *args)
    if x.device.type == "cpu":
        return plain_fn(x, *args)
    raise ValueError(f"no LSTM training recurrence for device {x.device}")


def train_fwd(xw, w_hh_t):
    """K2 for a CUDA tensor, its plain twin for a CPU tensor."""
    return _dispatch(train_fwd_cuda, train_fwd_plain, xw, w_hh_t)


def train_bwd(gates, cs, dys, w_hh_t):
    """K3 for a CUDA tensor, its plain twin for a CPU tensor."""
    return _dispatch(train_bwd_cuda, train_bwd_plain, gates, cs, dys, w_hh_t)


class BiLSTMRecurrence(torch.autograd.Function):
    """Forward K2, keeping (w_hh_t, ys, gates, cs); backward K3 and the
    weight-gradient product (pallas_lstm.py:213-239)."""

    @staticmethod
    def forward(ctx, xw, w_hh_t):
        ys, gates, cs = train_fwd(xw, w_hh_t)
        ctx.save_for_backward(w_hh_t, ys, gates, cs)
        return ys

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dys):
        w_hh_t, ys, gates, cs = ctx.saved_tensors
        dxw = train_bwd(gates, cs, dys.to(gates.dtype).contiguous(), w_hh_t)
        return dxw, weight_grad(ys, dxw, w_hh_t)


def bilstm_recurrence_trainable(xw, w_hh_t):
    """Differentiable recurrence: ys [T, D, B, H] in xw's dtype."""
    return BiLSTMRecurrence.apply(xw, w_hh_t)
