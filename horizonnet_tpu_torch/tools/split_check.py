#!/usr/bin/env python3
"""Whether the bf16 LSTM kernels (K1, K2, K3) keep the f32 contract.

    python3 horizonnet_tpu_torch/tools/split_check.py

Each kernel multiplies an f32 operand (h in K1 and K2, da in K3) by bf16 W
on the tensor cores as three exact bf16 products (x = hi + mid + lo). Its
bf16 outputs should then equal the plain twin's (an f32 product) bit for
bit, except where the two summation orders straddle a bf16 rounding
boundary. This copies horizonnet_tpu_torch/csrc's LSTM sources to
build/split/<n>/ keeping n = 3 (the sources as they are), 2 (hi + mid) and
1 (hi alone) of the terms, builds each copy, and runs K1 at the serving
shape (bf16, T=256, D=2, B=64, H=512) and K2 and K3 at the training shape
(B=8), seed 0, on one CUDA card. It prints the share of each output equal
to the twin's and the largest difference. chip_smoke.py and
tests/test_torch_cuda.py hold the kernels to bars that three terms reach
and one does not. Needs nvcc and a Hopper card.
"""

import ctypes
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)
from horizonnet_tpu_torch.ops import _build, cuda_lstm  # noqa: E402
from horizonnet_tpu_torch.ops import cuda_lstm_train as clt  # noqa: E402

TERMS = "for (int term = 2; term >= 0; --term)"
# the sources that hold a product loop over the terms (K1 and K2 share the
# header's), and the libraries built from them
PATCHED = ("bilstm_persistent.cuh", "bilstm_train.cu")
LIBS = ("bilstm_fwd", "bilstm_train")


def build(terms, root):
    out = os.path.join(root, str(terms))
    os.makedirs(out, exist_ok=True)
    for name in PATCHED + ("bilstm_fwd.cu",):
        with open(os.path.join(_build.CSRC, name)) as f:
            src = f.read()
        if name in PATCHED:
            if src.count(TERMS) != 1:
                raise RuntimeError(f"{name} no longer has one `{TERMS}`")
            src = src.replace(TERMS, TERMS.replace("= 2", f"= {terms - 1}"))
        with open(os.path.join(out, name), "w") as f:
            f.write(src)

    def nvcc(lib):
        so = os.path.join(out, f"lib{lib}.so")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
                        os.path.join(out, lib + ".cu")], check=True)
        return ctypes.CDLL(so)

    with ThreadPoolExecutor(len(LIBS)) as pool:
        k1, k23 = pool.map(nvcc, LIBS)
    k1.bilstm_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                              + [ctypes.c_void_p])
    return k1, clt.bind(k23)


def run_k1(lib, xw, w):
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


def compare(got, want):
    same = (got == want).float().mean().item()
    diff = (got.float() - want.float()).abs().max().item()
    return f"{100 * same:.4f} % ({diff:.2e})"


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    root = os.path.join(REPO, "build", "split")
    shutil.rmtree(root, ignore_errors=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    g = torch.Generator().manual_seed(0)
    T, D, H = 256, 2, 512

    def inputs(B):
        xw = torch.randn(T, D, B, 4 * H, generator=g)
        w = (torch.rand(D, H, 4 * H, generator=g) * 2 - 1) * H ** -0.5
        dys = torch.randn(T, D, B, H, generator=g)
        return [t.cuda().bfloat16() for t in (xw, w, dys)]

    xw1, w1, _ = inputs(64)
    want1 = cuda_lstm.bilstm_recurrence_plain(xw1, w1)
    xw, w, dys = inputs(8)
    want2 = clt.train_fwd_plain(xw, w)
    _, gates, cs = want2
    want3 = clt.train_bwd_plain(gates, cs, dys, w)
    for terms in (3, 2, 1):
        k1, k23 = build(terms, root)
        ys1 = run_k1(k1, xw1, w1)
        clt._library = lambda: k23  # noqa: E731 (this copy's K2/K3)
        got2 = clt.train_fwd_cuda(xw, w)
        got3 = clt.train_bwd_cuda(gates, cs, dys, w)
        torch.cuda.synchronize()
        print(f"{terms} of the 3 terms: outputs equal to the twin's bit for "
              f"bit (max |kernel - twin|): K1 ys {compare(ys1, want1)} "
              f"[T={T},D={D},B=64,H={H}]; K2 ys, gates, cs "
              f"{', '.join(compare(a, b) for a, b in zip(got2, want2))}; "
              f"K3 dxw {compare(got3, want3)} [T={T},D={D},B=8,H={H}]; bf16 "
              f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
