#!/usr/bin/env python3
"""Whether the serving LSTM kernel (K1) keeps the f32 contract in bf16.

    python3 horizonnet_tpu_torch/tools/k1_split_check.py

K1 multiplies f32 h by bf16 W on the tensor cores as three exact bf16
products (h = hi + mid + lo). Its bf16 output should then equal the plain
twin's (an f32 product) bit for bit, except where the two summation orders
straddle a bf16 rounding boundary. This builds copies of
horizonnet_tpu_torch/csrc/bilstm_fwd.cu under build/k1_split/ that keep 3
(the source as it is), 2 (hi + mid) and 1 (hi alone) of the terms, runs
each at the serving shape (bf16, T=256, D=2, B=64, H=512, seed 0) on one
CUDA card, and prints the share of outputs equal to the twin's and the
largest difference. chip_smoke.py and tests/test_torch_cuda.py hold the
kernel to 99.98 %, which three terms reach and one or two do not. Needs
nvcc and a Hopper card.
"""

import ctypes
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)
from horizonnet_tpu_torch.ops import _build, cuda_lstm  # noqa: E402

TERMS = "for (int term = 2; term >= 0; --term)"


def build(terms, out_dir):
    with open(os.path.join(_build.CSRC, "bilstm_fwd.cu")) as f:
        src = f.read()
    if src.count(TERMS) != 1:
        raise RuntimeError(f"bilstm_fwd.cu no longer has one `{TERMS}`")
    src = src.replace(TERMS, TERMS.replace("= 2", f"= {terms - 1}"))
    cu = os.path.join(out_dir, f"bilstm_fwd_{terms}.cu")
    so = cu[:-3] + ".so"
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                   check=True)
    lib = ctypes.CDLL(so)
    lib.bilstm_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                               + [ctypes.c_void_p])
    return lib


def run(lib, xw, w):
    T, D, B, G = xw.shape
    H = G // 4
    ys = torch.empty(T, D, B, H, dtype=xw.dtype, device=xw.device)
    h_buf = torch.empty(2, D, B, H, device=xw.device)
    c_buf = torch.empty(D, B, H, device=xw.device)
    flags = torch.empty(D, dtype=torch.int32, device=xw.device)
    err = lib.bilstm_fwd(xw.data_ptr(), w.data_ptr(), ys.data_ptr(),
                         h_buf.data_ptr(), c_buf.data_ptr(), flags.data_ptr(),
                         T, D, B, H, 1,
                         torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"bilstm_fwd launch failed ({err})")
    return ys


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = os.path.join(REPO, "build", "k1_split")
    os.makedirs(out_dir, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    T, D, B, H = 256, 2, 64, 512
    g = torch.Generator().manual_seed(0)
    xw = torch.randn(T, D, B, 4 * H, generator=g).cuda().bfloat16()
    w = ((torch.rand(D, H, 4 * H, generator=g) * 2 - 1)
         * H ** -0.5).cuda().bfloat16()
    want = cuda_lstm.bilstm_recurrence_plain(xw, w)
    for terms in (3, 2, 1):
        ys = run(build(terms, out_dir), xw, w)
        torch.cuda.synchronize()
        same = (ys == want).float().mean().item()
        diff = (ys.float() - want.float()).abs().max().item()
        print(f"K1 bf16 [T={T},D={D},B={B},H={H}] with {terms} of the 3 "
              f"terms of h: {100 * same:.4f} % of outputs equal the twin's, "
              f"max|kernel - twin| {diff:.3e} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
