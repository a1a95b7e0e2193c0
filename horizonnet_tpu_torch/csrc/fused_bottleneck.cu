// One stride-1 identity ResNet bottleneck (1x1 -> 3x3 -> 1x1, batch norm
// folded, ReLUs, residual, final ReLU) as one kernel, written by hand for
// Hopper (sm_90a).
//
// Replaces horizonnet_tpu/ops/pallas_block.py::_block_kernel (wrapped there
// by fused_bottleneck). Same contract, NHWC:
//   x   [B, H, W, C]     f32 or bf16
//   w1t [Wd, C]          conv1, output channel major (the wrapper transposes
//                        the JAX layout [C, Wd]); x's dtype
//   w2t [3, 3, Wd, Wd]   conv2 as [kh, kw, out, in]; x's dtype
//   w3t [C, Wd]          conv3, output channel major; x's dtype
//   b1 [Wd], b2 [Wd], b3 [C]  f32 folded biases
//   y   [B, H, W, C]     x's dtype
//   m  = relu(x w1 + b1) rounded to the dtype; rows above and below the
//        image are zero in m's space (pallas_block.py:72-79)
//   m2 = relu(conv3x3(m) + b2) rounded; columns wrap around W
//   y  = relu(m2 w3 + b3 + x), summed in f32 and rounded once
//
// What bounds it on the H100: 34 Wd^2 FLOPs per pixel against 2 C bytes per
// pixel in and out (bf16). With Wd = C / 4 that is 8.5 Wd operations per
// byte: below the card's ~295 bf16 operations per byte at the first two
// resnet50 stages (Wd 64, 128: bytes bound), above it at the last two
// (Wd 256, 512: operations bound). The unfused block writes and reads m
// and m2 and runs batch norm, ReLU and the residual add as separate passes
// over device memory; this kernel keeps m and m2 in shared memory.
//
// Design. The TPU kernel takes full-width tiles of 16 rows in VMEM; one
// 256-px row of C=256 bf16 is already 128 KiB, more than half of what a CTA
// has, so here a CTA owns a 2-D tile of TH x TW output pixels (8 x 8 in
// bf16, 4 x 8 in f32) and recomputes conv1 over its (TH+2) x (TW+2) haloed
// pixels (the halo is 56 % more conv1 work at 8 x 8, 17 % more work over
// the block). Halo columns wrap modulo W; halo rows outside the image are
// zero in x and set to zero in m. The three products are tiled matrix
// products out of shared memory, 8 warps as 2 (rows) x 4 (32 output
// columns each), output columns in passes of 128:
//   conv1: [haloed pixels, C] x [C, Wd]; x's halo rows and w1's columns are
//          staged k-slice by k-slice; the result goes to m (smem).
//   conv2: 9 taps x [TH*TW, Wd] x [Wd, Wd]; A rows are gathered from m by
//          the tap's offset, w2's slices are staged.
//   conv3: [TH*TW, Wd] x [Wd, C], in passes of 128 output channels whose
//          epilogue adds b3 and the residual (read from x) and stores y.
// bf16 products run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// sums; fragments by ldmatrix); f32 products run as CUDA-core FMAs over the
// same tiles, so both types share the staging and the epilogues. At Wd=512
// bf16 a CTA holds m (100 x 520 bf16), m2 (64 x 520) and the staging
// buffers: 227 KB. Weights come from L2 (17 Wd^2 values per block). Every
// k-slice (32 bf16 or 16 f32 deep) is staged by cp.async through a ring of
// 2-4 buffers (as deep as shared memory allows without losing a CTA per
// SM), and conv3's residual is loaded into registers before its products.
// wgmma, TMA and a persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fb {

constexpr int kThreads = 256;  // 8 warps: 2 along the pixels x 4 along N
constexpr int kNC = 128;       // output columns per pass (4 warps x 32)
constexpr int kNT = 4;         // n8 tiles per warp

template <typename T>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int TH = 8, TW = 8, KC = 32, PAD = 8;
};
template <>
struct Tile<float> {
  static constexpr int TH = 4, TW = 8, KC = 16, PAD = 4;
};

template <typename T>
struct Geo {
  static constexpr int TH = Tile<T>::TH, TW = Tile<T>::TW;
  static constexpr int KC = Tile<T>::KC;    // k-slice staged per step
  static constexpr int PAD = Tile<T>::PAD;  // 16 bytes of row padding
  static constexpr int P1 = (TH + 2) * (TW + 2);  // haloed pixels
  static constexpr int M1 = (P1 + 31) / 32 * 32;  // conv1 rows computed
  static constexpr int M2 = TH * TW;              // output pixels
  static constexpr int MT1 = M1 / 32;  // m16 tiles per warp, conv1
  static constexpr int MT2 = M2 / 32;  // m16 tiles per warp, conv2/conv3
  static constexpr int SK = KC + PAD;  // row stride of the staging buffers
};

// S staging buffers of [M1 + kNC, SK] beside m and m2.
template <typename T>
size_t smem_bytes(int Wd, int S) {
  using G = Geo<T>;
  return ((size_t)(G::P1 + G::M2) * (Wd + G::PAD) +
          S * (size_t)(G::M1 + kNC) * G::SK) *
         sizeof(T);
}

constexpr size_t kSmemLimit = 232448;  // a Hopper CTA's shared memory

// Pipeline depth: as deep as 4 where it keeps two CTAs on an SM that two
// buffers would allow (the registers allow two), else as deep as fits.
template <typename T>
int stages(int Wd) {
  const bool two = smem_bytes<T>(Wd, 2) <= kSmemLimit / 2;
  for (int S = 4; S > 2; --S)
    if (smem_bytes<T>(Wd, S) <= (two ? kSmemLimit / 2 : kSmemLimit)) return S;
  return 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mt][nt] += A[m0 + 16 mt .. +16, 16 k] x B^T[n0 + 8 nt .. +8, 16 k].
// arow(r) points at row r of A at the slice's first k; b at row 0 of the
// staged B^T chunk at the slice's first k. Thread (g = lane/4, t = lane%4)
// holds, per tile, rows g and g+8 and columns 2t and 2t+1 (mma's layout).
template <int MT, typename RowFn>
__device__ __forceinline__ void k16_step(float (&acc)[MT][kNT][4], RowFn arow,
                                         int m0, const __nv_bfloat16* b,
                                         int bstride, int n0, int lane) {
  uint32_t a[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    ldsm_x4(a[mt], arow(m0 + mt * 16 + (lane & 15)) + (lane >> 4) * 8);
#pragma unroll
  for (int np = 0; np < kNT / 2; ++np) {
    uint32_t bf[4];
    ldsm_x4(bf, b + (n0 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * bstride +
                    ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_bf16(acc[mt][2 * np], a[mt], bf[0], bf[1]);
      mma_bf16(acc[mt][2 * np + 1], a[mt], bf[2], bf[3]);
    }
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float c) {
  c = fmaf(a.x, b.x, c);
  c = fmaf(a.y, b.y, c);
  c = fmaf(a.z, b.z, c);
  return fmaf(a.w, b.w, c);
}

template <int MT, typename RowFn>
__device__ __forceinline__ void k16_step(float (&acc)[MT][kNT][4], RowFn arow,
                                         int m0, const float* b, int bstride,
                                         int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kq = 0; kq < 16; kq += 4) {
    float4 bv[kNT][2];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float* p = b + (n0 + nt * 8 + 2 * t) * bstride + kq;
      bv[nt][0] = *reinterpret_cast<const float4*>(p);
      bv[nt][1] = *reinterpret_cast<const float4*>(p + bstride);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float4 lo =
          *reinterpret_cast<const float4*>(arow(m0 + mt * 16 + g) + kq);
      const float4 hi =
          *reinterpret_cast<const float4*>(arow(m0 + mt * 16 + g + 8) + kq);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        acc[mt][nt][0] = dot4(lo, bv[nt][0], acc[mt][nt][0]);
        acc[mt][nt][1] = dot4(lo, bv[nt][1], acc[mt][nt][1]);
        acc[mt][nt][2] = dot4(hi, bv[nt][0], acc[mt][nt][2]);
        acc[mt][nt][3] = dot4(hi, bv[nt][1], acc[mt][nt][3]);
      }
    }
  }
}

// fn(row, col, v[col], v[col + 1]) over this thread's accumulators.
template <int MT, typename Fn>
__device__ __forceinline__ void for_each_pair(const float (&acc)[MT][kNT][4],
                                              int m0, int n0, int lane,
                                              Fn fn) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int r = m0 + mt * 16 + g, n = n0 + nt * 8 + 2 * t;
      fn(r, n, acc[mt][nt][0], acc[mt][nt][1]);
      fn(r + 8, n, acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// 16-byte asynchronous copy global -> shared; src_bytes 0 writes zeros
// (src is then not read, but must still be a global address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Queues the copy of rows [0, nrows) x k [0, kc) into dst (row stride
// dstride), 16 bytes per thread and step, from src(r) (already offset to
// the slice's first k); a null row is written as zeros.
template <typename T, typename SrcFn>
__device__ __forceinline__ void stage(T* dst, int dstride, int nrows, int kc,
                                      SrcFn src, const T* any) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = kc / V;
  for (int v = threadIdx.x; v < nrows * per_row; v += kThreads) {
    const int r = v / per_row, c = (v - r * per_row) * V;
    const T* s = src(r);
    cp_async16(dst + r * dstride + c, s ? s + c : any, s ? 16 : 0);
  }
}

// n k-slices through an S-stage cp.async pipeline: issue(c, buf) queues
// slice c into staging buffer buf, S - 1 slices ahead of compute(buf).
// One barrier per slice: it both publishes slice c and frees the buffer
// of slice c - 1, which the issue after it refills. Leaves every buffer
// free and every thread synchronised.
template <int S, typename Issue, typename Compute>
__device__ __forceinline__ void pipeline(int n, Issue issue,
                                         Compute compute) {
#pragma unroll
  for (int c = 0; c < S - 1; ++c) {
    if (c < n) issue(c, c);
    cp_commit();  // possibly empty: keeps one group per slice
  }
  for (int c = 0; c < n; ++c) {
    cp_wait<S - 2>();  // this thread's copies of slice c have landed
    __syncthreads();
    if (c + S - 1 < n) issue(c + S - 1, (c + S - 1) % S);
    cp_commit();
    compute(c % S);
  }
  __syncthreads();
}

// Two neighbouring channels of one pixel, as stored.
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
  static __device__ __forceinline__ float2 f(float2 v) { return v; }
};
template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ float2 f(__nv_bfloat162 v) {
    return __bfloat1622float2(v);
  }
};
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
    bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w1t,
                      const float* __restrict__ b1, const T* __restrict__ w2t,
                      const float* __restrict__ b2, const T* __restrict__ w3t,
                      const float* __restrict__ b3, T* __restrict__ y, int H,
                      int W, int C, int Wd) {
  using G = Geo<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int SM = Wd + G::PAD;  // row stride of m and m2
  T* sm = reinterpret_cast<T*>(smem_raw);  // m    [P1, Wd]
  T* sm2 = sm + G::P1 * SM;                // m2   [M2, Wd]
  // S staging buffers, each x [M1, KC] then w^T [kNC, KC]
  T* const stage0 = sm2 + G::M2 * SM;
  auto sA = [&](int buf) { return stage0 + buf * (G::M1 + kNC) * G::SK; };
  auto sB = [&](int buf) { return sA(buf) + G::M1 * G::SK; };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = (warp & 3) * 32;  // this warp's columns within a pass
  const int j0 = blockIdx.x * G::TW, i0 = blockIdx.y * G::TH;
  const size_t img = (size_t)blockIdx.z * H * W;
  // k-slice for conv2 and conv3, whose depth is Wd (a multiple of 16)
  const int kc2 = Wd % G::KC == 0 ? G::KC : 16;
  const int nk2 = Wd / kc2;

  // haloed pixel r (row-major over (TH+2) x (TW+2)): image row, or -1
  auto halo_row = [&](int r) {
    const int gi = i0 + r / (G::TW + 2) - 1;
    return (r < G::P1 && gi >= 0 && gi < H) ? gi : -1;
  };

  // conv1 over the haloed pixels -> m
  {
    const int m0 = (warp >> 2) * G::MT1 * 16;
    for (int nc = 0; nc < Wd; nc += kNC) {
      float acc[G::MT1][kNT][4] = {};
      pipeline<S>(
          C / G::KC,
          [&](int c, int buf) {
            const int k0 = c * G::KC;
            stage(sA(buf), G::SK, G::M1, G::KC, [&](int r) -> const T* {
              const int gi = halo_row(r);
              if (gi < 0) return nullptr;
              const int gj = ((j0 + r % (G::TW + 2) - 1) % W + W) % W;
              return x + (img + (size_t)gi * W + gj) * C + k0;
            }, w1t);
            stage(sB(buf), G::SK, kNC, G::KC, [&](int r) -> const T* {
              return nc + r < Wd ? w1t + (size_t)(nc + r) * C + k0 : nullptr;
            }, w1t);
          },
          [&](int buf) {
#pragma unroll
            for (int kk = 0; kk < G::KC; kk += 16)
              k16_step(acc, [&](int r) { return sA(buf) + r * G::SK + kk; },
                       m0, sB(buf) + kk, G::SK, n0, lane);
          });
      for_each_pair(acc, m0, n0, lane, [&](int r, int n, float v0, float v1) {
        const int col = nc + n;
        if (r >= G::P1 || col >= Wd) return;
        const bool inside = halo_row(r) >= 0;
        store2(sm + r * SM + col, inside ? fmaxf(v0 + b1[col], 0.f) : 0.f,
               inside ? fmaxf(v1 + b1[col + 1], 0.f) : 0.f);
      });
    }
  }
  __syncthreads();

  const int m0 = (warp >> 2) * G::MT2 * 16;
  // conv2: 9 taps, A rows gathered from m -> m2
  for (int nc = 0; nc < Wd; nc += kNC) {
    float acc[G::MT2][kNT][4] = {};
    int tap = 0, k0 = 0;  // of the slice being computed
    pipeline<S>(
        9 * nk2,
        [&](int c, int buf) {
          const T* wt = w2t + (size_t)(c / nk2) * Wd * Wd + (c % nk2) * kc2;
          stage(sB(buf), G::SK, kNC, kc2, [&](int r) -> const T* {
            return nc + r < Wd ? wt + (size_t)(nc + r) * Wd : nullptr;
          }, w2t);
        },
        [&](int buf) {
          const int dy = tap / 3, dx = tap % 3;
          for (int kk = 0; kk < kc2; kk += 16)
            k16_step(
                acc,
                [&](int p) {
                  return sm +
                         ((p / G::TW + dy) * (G::TW + 2) + p % G::TW + dx) *
                             SM +
                         k0 + kk;
                },
                m0, sB(buf) + kk, G::SK, n0, lane);
          k0 += kc2;
          if (k0 == Wd) k0 = 0, ++tap;
        });
    for_each_pair(acc, m0, n0, lane, [&](int p, int n, float v0, float v1) {
      const int col = nc + n;
      if (col >= Wd) return;
      store2(sm2 + p * SM + col, fmaxf(v0 + b2[col], 0.f),
             fmaxf(v1 + b2[col + 1], 0.f));
    });
  }
  __syncthreads();

  // conv3 + b3 + residual -> y, in passes of kNC output channels
  using P = Pair<T>;
  for (int nc = 0; nc < C; nc += kNC) {
    float acc[G::MT2][kNT][4] = {};
    // this thread's residual pairs, loaded before the products so their
    // latency hides behind them
    typename P::type res[G::MT2][kNT][2];
    {
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int mt = 0; mt < G::MT2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = m0 + mt * 16 + g + 8 * h;
            const int col = nc + n0 + nt * 8 + 2 * t;
            const int gi = i0 + p / G::TW, gj = j0 + p % G::TW;
            if (col < C && gi < H && gj < W)
              res[mt][nt][h] = *reinterpret_cast<const typename P::type*>(
                  x + (img + (size_t)gi * W + gj) * C + col);
          }
    }
    int k0 = 0;  // of the slice being computed
    pipeline<S>(
        nk2,
        [&](int c, int buf) {
          stage(sB(buf), G::SK, kNC, kc2, [&](int r) -> const T* {
            return nc + r < C ? w3t + (size_t)(nc + r) * Wd + c * kc2
                              : nullptr;
          }, w3t);
        },
        [&](int buf) {
          for (int kk = 0; kk < kc2; kk += 16)
            k16_step(acc, [&](int p) { return sm2 + p * SM + k0 + kk; }, m0,
                     sB(buf) + kk, G::SK, n0, lane);
          k0 += kc2;
        });
    {
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int mt = 0; mt < G::MT2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = m0 + mt * 16 + g + 8 * h;
            const int col = nc + n0 + nt * 8 + 2 * t;
            const int gi = i0 + p / G::TW, gj = j0 + p % G::TW;
            if (col >= C || gi >= H || gj >= W) continue;
            const float2 r = P::f(res[mt][nt][h]);
            store2(y + (img + (size_t)gi * W + gj) * C + col,
                   fmaxf(acc[mt][nt][2 * h] + b3[col] + r.x, 0.f),
                   fmaxf(acc[mt][nt][2 * h + 1] + b3[col + 1] + r.y, 0.f));
          }
    }
  }
}

template <typename T, int S>
int launch_s(const void* x, const void* w1t, const void* b1, const void* w2t,
             const void* b2, const void* w3t, const void* b3, void* y, int B,
             int H, int W, int C, int Wd, cudaStream_t s) {
  using G = Geo<T>;
  const size_t smem = smem_bytes<T>(Wd, S);
  cudaError_t e = cudaFuncSetAttribute(
      bottleneck_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + G::TW - 1) / G::TW, (H + G::TH - 1) / G::TH, B);
  bottleneck_kernel<T, S><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1t),
      static_cast<const float*>(b1), static_cast<const T*>(w2t),
      static_cast<const float*>(b2), static_cast<const T*>(w3t),
      static_cast<const float*>(b3), static_cast<T*>(y), H, W, C, Wd);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w1t, const void* b1, const void* w2t,
           const void* b2, const void* w3t, const void* b3, void* y, int B,
           int H, int W, int C, int Wd, cudaStream_t s) {
  switch (stages<T>(Wd)) {
    case 4:
      return launch_s<T, 4>(x, w1t, b1, w2t, b2, w3t, b3, y, B, H, W, C, Wd,
                            s);
    case 3:
      return launch_s<T, 3>(x, w1t, b1, w2t, b2, w3t, b3, y, B, H, W, C, Wd,
                            s);
    default:
      return launch_s<T, 2>(x, w1t, b1, w2t, b2, w3t, b3, y, B, H, W, C, Wd,
                            s);
  }
}

}  // namespace fb

extern "C" {

// Bytes of dynamic shared memory one CTA needs at width Wd.
size_t fused_bottleneck_smem_bytes(int Wd, int is_bf16) {
  return is_bf16 ? fb::smem_bytes<__nv_bfloat16>(
                       Wd, fb::stages<__nv_bfloat16>(Wd))
                 : fb::smem_bytes<float>(Wd, fb::stages<float>(Wd));
}

// One block on `stream`. Pointers are 16-byte aligned and contiguous in
// the layouts above. Returns cudaGetLastError() of the launch (0 on
// success).
int fused_bottleneck(const void* x, const void* w1t, const void* b1,
                     const void* w2t, const void* b2, const void* w3t,
                     const void* b3, void* y, int B, int H, int W, int C,
                     int Wd, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Wd <= 0 || Wd % 16 != 0 || C != 4 * Wd)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return fb::launch<__nv_bfloat16>(x, w1t, b1, w2t, b2, w3t, b3, y, B, H, W,
                                     C, Wd, s);
  return fb::launch<float>(x, w1t, b1, w2t, b2, w3t, b3, y, B, H, W, C, Wd,
                           s);
}

const char* fused_bottleneck_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
