#!/usr/bin/env python3
"""Where the bf16 fused bottleneck (K4) spends its time, phase by phase.

    python3 horizonnet_tpu_torch/tools/k4_phase_trace.py

Writes an instrumented copy of horizonnet_tpu_torch/csrc/fused_bottleneck.cu
to build/k4_trace/ (the first consumer thread of each CTA stamps
%globaltimer at the start, after conv1, after conv2 and at the end, and
sums its waits on the weight ring and on x's halo stages; the producer
sums its waits for free slots), builds it with nvcc, runs it at the four
resnet50 stage shapes (B=64, 512x1024 input) on one CUDA card, and prints
per-CTA means of each phase in microseconds beside the instrumented
kernel's time (CUDA events). Needs nvcc and a Hopper card. The patches
below are matched against the source text and fail loudly if it moved.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)
from horizonnet_tpu_torch.ops import fused_block as fb  # noqa: E402

PATCHES = []


def rep(old, new):
    PATCHES.append((old, new))


rep('namespace wg {\n', '''namespace wg {
__device__ unsigned long long g_trace[8192][8];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t; }
''')
rep('''    int it = 0;  // slices consumed, in the producer's order
    auto wait_full = [&]() {
      mbar_wait(full_s + 8 * (it % P::S), (it / P::S) & 1);
    };''', '''    int it = 0;  // slices consumed, in the producer's order
    const int cta = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    unsigned long long* tr = (ct == 0 && cta < 8192) ? g_trace[cta] : nullptr;
    unsigned long long wfull = 0, wx = 0;
    if (tr) tr[0] = gtime();
    auto wait_full = [&]() {
      unsigned long long a = tr ? gtime() : 0;
      mbar_wait(full_s + 8 * (it % P::S), (it / P::S) & 1);
      if (tr) wfull += gtime() - a;
    };''')
rep('''            cp_wait<P::XN - 2>();
            bar_consumers();  // stage q landed; stage q - 1 is free''', '''            unsigned long long xa = tr ? gtime() : 0;
            cp_wait<P::XN - 2>();
            bar_consumers();  // stage q landed; stage q - 1 is free
            if (tr) wx += gtime() - xa;''')
rep('''    bar_consumers();  // m complete; x's stages free for m2
''', '''    bar_consumers();  // m complete; x's stages free for m2
    if (tr) tr[1] = gtime();
''')
rep('''    // conv3 + b3 + residual -> y, N3 output channels a pass, through the''', '''    if (tr) tr[2] = gtime();
    // conv3 + b3 + residual -> y, N3 output channels a pass, through the''')
rep('''      }
    }
  }
  // no CTA leaves while another may still multicast into it or arrive on''', '''      }
    }
    if (tr) { tr[3] = gtime(); tr[4] = wfull; tr[5] = wx; tr[6] = it; }
  }
  // no CTA leaves while another may still multicast into it or arrive on''')
rep('''extern "C" {

// Bytes of dynamic shared memory''', '''extern "C" {
int fb_trace_clear() {
  static unsigned long long z[8192][8];
  return (int)cudaMemcpyToSymbol(wg::g_trace, z, sizeof(z));
}
int fb_trace_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, wg::g_trace, sizeof(wg::g_trace));
}
// Bytes of dynamic shared memory''')
rep('''      int i = 0;
      auto next = [&](int rows, auto issue) {
        const int slot = i % P::S;
        mbar_wait(empty_s + 8 * slot, ((i / P::S) & 1) ^ 1);''', '''      int i = 0;
      const int pcta = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
      unsigned long long wempty = 0;
      auto next = [&](int rows, auto issue) {
        const int slot = i % P::S;
        unsigned long long ea = gtime();
        mbar_wait(empty_s + 8 * slot, ((i / P::S) & 1) ^ 1);
        wempty += gtime() - ea;''')
rep('''            tma_2d<P::CL>(dst, &tm3, kc * 64, nc + r0, bar);
          });
''', '''            tma_2d<P::CL>(dst, &tm3, kc * 64, nc + r0, bar);
          });
      if (pcta < 8192) g_trace[pcta][7] = wempty;
''')


def instrumented_source():
    path = os.path.join(REPO, "horizonnet_tpu_torch", "csrc",
                        "fused_bottleneck.cu")
    with open(path) as f:
        src = f.read()
    for old, new in PATCHES:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    return src


def main():
    out_dir = os.path.join(REPO, "build", "k4_trace")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "fb_trace.cu")
    so = os.path.join(out_dir, "fb_trace.so")
    with open(cu, "w") as f:
        f.write(instrumented_source())
    r = subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode:
        print(r.stderr[-4000:], file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    lib.fused_bottleneck.argtypes = ([ctypes.c_void_p] * 8
                                     + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.fused_bottleneck_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fused_bottleneck_smem_bytes.restype = ctypes.c_size_t
    lib.fused_bottleneck_error_string.argtypes = [ctypes.c_int]
    lib.fused_bottleneck_error_string.restype = ctypes.c_char_p
    lib.fb_trace_read.argtypes = [ctypes.c_void_p]
    lib.fb_trace_clear.argtypes = []
    fb._library = lambda: lib
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    g = torch.Generator().manual_seed(0)
    for B, H, W, C in ((64, 128, 256, 256), (64, 64, 128, 512),
                       (64, 32, 64, 1024), (64, 16, 32, 2048)):
        Wd = C // 4
        x = torch.randn(B, H, W, C, generator=g).cuda().bfloat16()
        wts = [torch.randn(C, Wd, generator=g) / C ** .5,
               torch.randn(Wd, generator=g) * .1,
               torch.randn(3, 3, Wd, Wd, generator=g) / (9 * Wd) ** .5,
               torch.randn(Wd, generator=g) * .1,
               torch.randn(Wd, C, generator=g) / Wd ** .5,
               torch.randn(C, generator=g) * .1]
        wts = [w.cuda() for w in wts]
        for _ in range(3):
            fb.fused_bottleneck_cuda(x, *wts)
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(10):
            fb.fused_bottleneck_cuda(x, *wts)
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1]) / 10
        assert lib.fb_trace_clear() == 0
        fb.fused_bottleneck_cuda(x, *wts)
        torch.cuda.synchronize()
        buf = np.zeros((8192, 8), np.uint64)
        assert lib.fb_trace_read(buf.ctypes.data) == 0
        t = buf[buf[:, 3] > 0].astype(np.float64)
        c1, c2, c3 = ((t[:, i + 1] - t[:, i]) / 1e3 for i in range(3))
        mid = (t[:, 0].min() + t[:, 3].max()) / 2
        resident = int(((t[:, 0] <= mid) & (t[:, 3] >= mid)).sum())
        print(f"K4 bf16 [{B},{H},{W},{C}]: instrumented kernel {ms:.3f} ms; "
              f"{len(t)} CTAs, {resident} resident at mid-run; per CTA "
              f"(us): conv1 {c1.mean():.1f}, conv2 {c2.mean():.1f}, conv3 "
              f"{c3.mean():.1f}; waits: weight ring {t[:, 4].mean() / 1e3:.1f},"
              f" x stages {t[:, 5].mean() / 1e3:.1f}, producer for free slots "
              f"{t[:, 7].mean() / 1e3:.1f}; {t[:, 6].mean():.0f} slices "
              f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
