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
// bf16 design (bottleneck_wgmma). The TPU kernel takes full-width tiles of
// 16 rows in VMEM; here a CTA owns a TH x TW tile of output pixels,
// recomputes conv1 over its (TH+2) x (TW+2) halo (halo columns wrap modulo
// W, halo rows outside the image are set to zero in m) and keeps m and m2
// in shared memory. The folded weights (17 Wd^2 values) stream from L2
// through a ring of shared-memory slots, one 64-deep k-slice of up to 128
// output channels per slot, loaded by TMA in the 128-byte swizzled layout
// that wgmma's descriptor names. Every slice fetched from L2 serves at least
// 256 output pixels:
//   width (Wd)  tile    cluster  pixels/fetch  N (conv1/2/3)  ring       x
//   <= 64       16x16   1        256           64/64/128      4 x 16 KB  3
//   128         16x16   1        256           64/128/128     3 x 16 KB  3
//   192, 256    8x16    2        256           128/128/128    4 x 16 KB  3
//   320 - 512   8x8     4        256           128/128/128    3 x 16 KB  4
// (x: stages of x's halo in flight. At 8x16, slots of 128 rows in a
// 4-deep ring measured faster than 256 rows in a 2-deep one.) One
// CTA of 288 threads per SM: 168 registers a thread (nine warps share four
// register files) and a few bytes of spills (ptxas -v).
// At Wd >= 256 m and m2 of a larger tile do not fit a CTA, so a cluster of
// 2 or 4 CTAs along W shares each slice: each CTA loads 1/CL of the slice
// and multicasts it into every CTA of the cluster. Weight bytes read from
// L2 per launch at the resnet50 stage shapes (B=64, 512x1024 input):
// 1.14 GB at each stage (17 Wd^2 x 2 B per 256 pixels; 64-pixel tiles
// would read 4.6 GB). N matches the width (no products on
// padding columns at the stage widths; a width that is not a multiple of
// 64 pads its last slice with TMA's zero fill).
// Warp roles: one producer warp keeps the TMA ring full (an mbarrier per
// slot for "full", one for "empty" that every consumer warp of the cluster
// arrives on); two consumer warpgroups run wgmma (m64nNk16, bf16 in, f32
// accumulators in registers). The pixel operand A comes from registers:
// ldmatrix gathers the rows of x's staged halo (conv1), the tap-shifted
// rows of m (conv2) and the rows of m2 (conv3), which no fixed-stride
// descriptor could name. A conv with one 64-row M tile splits N between the
// two warpgroups, else M. x's halo is staged 32 channels deep by cp.async,
// double-buffered in m2's space (m2 is not live during conv1). conv3's
// epilogue goes through shared memory: the residual tile comes in by
// 16-byte cp.async, y = relu(acc + b3 + x) is formed in place, and leaves
// in 16-byte stores. Each consumer warp releases a slot once its next
// slice's products are in flight (wgmma.wait_group 1), lane c arriving on
// cluster CTA c's barrier; no branch surrounds a wgmma (ptxas serializes
// wgmma on paths it cannot prove uniform), so conv1's odd M tile is padded.
//
// f32 (bottleneck_kernel, CUDA-core code for the 2e-5 parity checks): 4 x 8 output tiles, products as CUDA-core FMAs laid
// out like mma.sync's accumulators, k-slices staged by cp.async through a
// 2-4 deep ring.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_attr.cuh"

namespace fb {

constexpr int kThreads = 256;  // 8 warps: 2 along the pixels x 4 along N
constexpr int kNC = 128;       // output columns per pass (4 warps x 32)
constexpr int kNT = 4;         // n8 tiles per warp

// f32 tile: 4 x 8 output pixels, k-slices 16 deep, 16 bytes of padding
struct Geo {
  static constexpr int TH = 4, TW = 8, KC = 16, PAD = 4;
  static constexpr int P1 = (TH + 2) * (TW + 2);  // haloed pixels
  static constexpr int M1 = (P1 + 31) / 32 * 32;  // conv1 rows computed
  static constexpr int M2 = TH * TW;              // output pixels
  static constexpr int MT1 = M1 / 32;  // m16 tiles per warp, conv1
  static constexpr int MT2 = M2 / 32;  // m16 tiles per warp, conv2/conv3
  static constexpr int SK = KC + PAD;  // row stride of the staging buffers
};

// S staging buffers of [M1 + kNC, SK] beside m and m2.
inline size_t smem_bytes(int Wd, int S) {
  using G = Geo;
  return ((size_t)(G::P1 + G::M2) * (Wd + G::PAD) +
          S * (size_t)(G::M1 + kNC) * G::SK) *
         sizeof(float);
}

constexpr size_t kSmemLimit = 232448;  // a Hopper CTA's shared memory

// Pipeline depth: as deep as 4 where it keeps two CTAs on an SM that two
// buffers would allow, else as deep as fits.
inline int stages(int Wd) {
  const bool two = smem_bytes(Wd, 2) <= kSmemLimit / 2;
  for (int S = 4; S > 2; --S)
    if (smem_bytes(Wd, S) <= (two ? kSmemLimit / 2 : kSmemLimit)) return S;
  return 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float c) {
  c = fmaf(a.x, b.x, c);
  c = fmaf(a.y, b.y, c);
  c = fmaf(a.z, b.z, c);
  return fmaf(a.w, b.w, c);
}

// acc[mt][nt] += A[m0 + 16 mt .. +16, 16 k] x B^T[n0 + 8 nt .. +8, 16 k] in
// f32 FMAs. Thread (g = lane/4, t = lane%4) holds, per tile, rows g and
// g+8 and columns 2t and 2t+1 (mma.sync's layout).
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
template <typename SrcFn>
__device__ __forceinline__ void stage(float* dst, int dstride, int nrows,
                                      int kc, SrcFn src, const float* any) {
  const int per_row = kc / 4;
  for (int v = threadIdx.x; v < nrows * per_row; v += kThreads) {
    const int r = v / per_row, c = (v - r * per_row) * 4;
    const float* s = src(r);
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

template <int S>
__global__ void __launch_bounds__(kThreads)
    bottleneck_kernel(const float* __restrict__ x, const float* __restrict__ w1t,
                      const float* __restrict__ b1, const float* __restrict__ w2t,
                      const float* __restrict__ b2, const float* __restrict__ w3t,
                      const float* __restrict__ b3, float* __restrict__ y, int H,
                      int W, int C, int Wd) {
  using G = Geo;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int SM = Wd + G::PAD;  // row stride of m and m2
  float* sm = reinterpret_cast<float*>(smem_raw);  // m    [P1, Wd]
  float* sm2 = sm + G::P1 * SM;                    // m2   [M2, Wd]
  // S staging buffers, each x [M1, KC] then w^T [kNC, KC]
  float* const stage0 = sm2 + G::M2 * SM;
  auto sA = [&](int buf) { return stage0 + buf * (G::M1 + kNC) * G::SK; };
  auto sB = [&](int buf) { return sA(buf) + G::M1 * G::SK; };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = (warp & 3) * 32;  // this warp's columns within a pass
  const int j0 = blockIdx.x * G::TW, i0 = blockIdx.y * G::TH;
  const size_t img = (size_t)blockIdx.z * H * W;
  // k-slice for conv2 and conv3, whose depth is Wd (a multiple of 16)
  const int kc2 = G::KC;
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
            stage(sA(buf), G::SK, G::M1, G::KC, [&](int r) -> const float* {
              const int gi = halo_row(r);
              if (gi < 0) return nullptr;
              const int gj = ((j0 + r % (G::TW + 2) - 1) % W + W) % W;
              return x + (img + (size_t)gi * W + gj) * C + k0;
            }, w1t);
            stage(sB(buf), G::SK, kNC, G::KC, [&](int r) -> const float* {
              return nc + r < Wd ? w1t + (size_t)(nc + r) * C + k0 : nullptr;
            }, w1t);
          },
          [&](int buf) {
            k16_step(acc, [&](int r) { return sA(buf) + r * G::SK; }, m0,
                     sB(buf), G::SK, n0, lane);
          });
      for_each_pair(acc, m0, n0, lane, [&](int r, int n, float v0, float v1) {
        const int col = nc + n;
        if (r >= G::P1 || col >= Wd) return;
        const bool inside = halo_row(r) >= 0;
        *reinterpret_cast<float2*>(sm + r * SM + col) =
            make_float2(inside ? fmaxf(v0 + b1[col], 0.f) : 0.f,
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
          const float* wt =
              w2t + (size_t)(c / nk2) * Wd * Wd + (c % nk2) * kc2;
          stage(sB(buf), G::SK, kNC, kc2, [&](int r) -> const float* {
            return nc + r < Wd ? wt + (size_t)(nc + r) * Wd : nullptr;
          }, w2t);
        },
        [&](int buf) {
          const int dy = tap / 3, dx = tap % 3;
          k16_step(
              acc,
              [&](int p) {
                return sm + ((p / G::TW + dy) * (G::TW + 2) + p % G::TW + dx) *
                                SM +
                       k0;
              },
              m0, sB(buf), G::SK, n0, lane);
          k0 += kc2;
          if (k0 == Wd) k0 = 0, ++tap;
        });
    for_each_pair(acc, m0, n0, lane, [&](int p, int n, float v0, float v1) {
      const int col = nc + n;
      if (col >= Wd) return;
      *reinterpret_cast<float2*>(sm2 + p * SM + col) =
          make_float2(fmaxf(v0 + b2[col], 0.f), fmaxf(v1 + b2[col + 1], 0.f));
    });
  }
  __syncthreads();

  // conv3 + b3 + residual -> y, in passes of kNC output channels
  for (int nc = 0; nc < C; nc += kNC) {
    float acc[G::MT2][kNT][4] = {};
    int k0 = 0;  // of the slice being computed
    pipeline<S>(
        nk2,
        [&](int c, int buf) {
          stage(sB(buf), G::SK, kNC, kc2, [&](int r) -> const float* {
            return nc + r < C ? w3t + (size_t)(nc + r) * Wd + c * kc2
                              : nullptr;
          }, w3t);
        },
        [&](int buf) {
          k16_step(acc, [&](int p) { return sm2 + p * SM + k0; }, m0, sB(buf),
                   G::SK, n0, lane);
          k0 += kc2;
        });
    for_each_pair(acc, m0, n0, lane, [&](int p, int n, float v0, float v1) {
      const int col = nc + n;
      const int gi = i0 + p / G::TW, gj = j0 + p % G::TW;
      if (col >= C || gi >= H || gj >= W) return;
      float* o = y + (img + (size_t)gi * W + gj) * C + col;
      const float2 r = *reinterpret_cast<const float2*>(
          x + (img + (size_t)gi * W + gj) * C + col);
      *reinterpret_cast<float2*>(o) =
          make_float2(fmaxf(v0 + b3[col] + r.x, 0.f),
                      fmaxf(v1 + b3[col + 1] + r.y, 0.f));
    });
  }
}

template <int S>
int launch_s(const float* x, const float* w1t, const float* b1,
             const float* w2t, const float* b2, const float* w3t,
             const float* b3, float* y, int B, int H, int W, int C, int Wd,
             cudaStream_t s) {
  using G = Geo;
  const size_t smem = smem_bytes(Wd, S);
  cudaError_t e =
      smem_attr::ensure((const void*)bottleneck_kernel<S>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + G::TW - 1) / G::TW, (H + G::TH - 1) / G::TH, B);
  bottleneck_kernel<S><<<grid, kThreads, smem, s>>>(x, w1t, b1, w2t, b2, w3t,
                                                    b3, y, H, W, C, Wd);
  return (int)cudaGetLastError();
}

int launch_f32(const float* x, const float* w1t, const float* b1,
               const float* w2t, const float* b2, const float* w3t,
               const float* b3, float* y, int B, int H, int W, int C, int Wd,
               cudaStream_t s) {
  switch (stages(Wd)) {
    case 4:
      return launch_s<4>(x, w1t, b1, w2t, b2, w3t, b3, y, B, H, W, C, Wd, s);
    case 3:
      return launch_s<3>(x, w1t, b1, w2t, b2, w3t, b3, y, B, H, W, C, Wd, s);
    default:
      return launch_s<2>(x, w1t, b1, w2t, b2, w3t, b3, y, B, H, W, C, Wd, s);
  }
}

}  // namespace fb

namespace wg {

using bf16 = __nv_bfloat16;
using fb::cp_async16;
using fb::cp_commit;
using fb::cp_wait;
using fb::smem_u32;

constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kXK = 32;                    // x's halo staged 32 channels deep
constexpr int kXS = kXK + 8;               // its row stride (80 bytes)
static_assert(kXK / 8 * 64 == kConsumers, "one 16-byte copy a thread per 64 rows");

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// How a conv's MT m64 tiles and N slot columns divide between the two
// consumer warpgroups: by M, or by N when there is one M tile.
template <int MT, int N>
struct Split {
  static constexpr bool kByN = MT == 1;
  static constexpr int MTW = kByN ? 1 : (MT + 1) / 2;  // m tiles a group
  static constexpr int MTP = kByN ? 1 : 2 * MTW;  // with the odd one padded
  static constexpr int NI = kByN ? N / 2 : N;          // columns a group
  static constexpr int NW = NI < 128 ? NI : 128;       // per instruction
  static constexpr int NACC = NI / 2;                  // f32 a thread
};

// A tile plan: TH x TW output pixels per CTA, CL CTAs per cluster along W,
// widths up to KP, slot rows (N) of conv1/2/3, S ring slots, XN stages of
// x's halo in flight.
template <int TH_, int TW_, int CL_, int KP_, int N1_, int N2_, int N3_,
          int S_, int XN_>
struct Plan {
  static constexpr int TH = TH_, TW = TW_, CL = CL_, KP = KP_;
  static constexpr int N1 = N1_, N2 = N2_, N3 = N3_, S = S_, XN = XN_;
  static constexpr int P1 = (TH + 2) * (TW + 2);  // haloed pixels
  static constexpr int M2 = TH * TW;              // output pixels
  static constexpr int MT1 = (P1 + 63) / 64;      // conv1's m64 tiles
  static constexpr int MT2 = M2 / 64;             // conv2's and conv3's
  static constexpr int SM = KP + 8;               // row stride of m and m2
  static constexpr int SY = N3 + 8;               // row stride of the y tile
  static constexpr int SLOT = cmax(N1, cmax(N2, N3)) * 128;  // 64 k x N
  static constexpr int RING = S * SLOT;
  // m, later the y tile; x's halo stages, later m2
  static constexpr int M_BYTES = cmax(P1 * SM * 2, M2 * SY * 2);
  // elements of one x stage: conv1's rows, padded to whole m64 tiles for
  // both warpgroups, so that every wgmma is issued unconditionally
  static constexpr int XSTAGE = Split<MT1, N1>::MTP * 64 * kXS;
  static constexpr int M2_BYTES = cmax(M2 * SM * 2, XN * XSTAGE * 2);
  static constexpr int SMEM = 1024 + RING + M_BYTES + M2_BYTES + 2 * S * 8;
  static_assert(M2 % 64 == 0, "output tile of whole m64 tiles");
  static_assert(SMEM <= 232448, "plan exceeds a CTA's shared memory");
};
using P64 = Plan<16, 16, 1, 64, 64, 64, 128, 4, 3>;
using P128 = Plan<16, 16, 1, 128, 64, 128, 128, 3, 3>;
using P256 = Plan<8, 16, 2, 256, 128, 128, 128, 4, 3>;
using P512 = Plan<8, 8, 4, 512, 128, 128, 128, 3, 4>;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Arrives on the barrier at the same offset in cluster CTA `cta`.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
template <int CL>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (CL == 1) {
    __syncthreads();
  } else {
    asm volatile(
        "barrier.cluster.arrive.release.aligned;\n"
        "barrier.cluster.wait.acquire.aligned;\n" ::
            : "memory");
  }
}
// The consumers' own barrier (named barrier 1; the producer warp never
// joins it).
__device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// TMA tile loads into this CTA's shared memory, or, in a cluster, into the
// same offset of every CTA of the cluster; completion is counted in bytes
// on the barrier at the same offset in each destination.
template <int CL>
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, uint32_t bar) {
  if constexpr (CL == 1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
            dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar),
        "h"((uint16_t)((1 << CL) - 1))
        : "memory");
  }
}
template <int CL>
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, int c2, uint32_t bar) {
  if constexpr (CL == 1) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
        "r"(bar)
        : "memory");
  } else {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes.multicast::cluster [%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::
            "r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
        "r"(bar), "h"((uint16_t)((1 << CL) - 1))
        : "memory");
  }
}

// wgmma descriptor of a K-major tile in the 128-byte swizzle: rows of 64
// bf16 (128 bytes), 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// m64n64k16, A from registers, B by descriptor: d += A B
__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
// m64n128k16, A from registers, B by descriptor: d += A B
__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int NW>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4],
                                         uint64_t desc) {
  if constexpr (NW == 128)
    wgmma_n128(d, a, desc);
  else
    wgmma_n64(d, a, desc);
}

// One 16-deep step of a warpgroup's product: A rows gathered by
// arow(row) (pointing at the step's first k), B from the slot's
// descriptor (already advanced to the step and this group's columns).
// mt0: the group's first m64 tile. No branch surrounds a wgmma: ptxas
// serializes wgmma on paths it cannot prove uniform.
template <class SP, typename RowFn>
__device__ __forceinline__ void k16_wgmma(float (&acc)[SP::MTW][SP::NACC],
                                          RowFn arow, int mt0, uint64_t desc,
                                          int wi, int lane) {
  uint32_t a[SP::MTW][4];
#pragma unroll
  for (int mt = 0; mt < SP::MTW; ++mt)
    ldsm_x4(a[mt], arow((mt0 + mt) * 64 + wi * 16 + (lane & 15)) +
                       (lane >> 4) * 8);
  wgmma_fence();
#pragma unroll
  for (int mt = 0; mt < SP::MTW; ++mt)
#pragma unroll
    for (int ins = 0; ins < SP::NI / SP::NW; ++ins)
      wgmma_rs<SP::NW>(&acc[mt][ins * SP::NW / 2], a[mt],
                       desc + ins * (SP::NW * 128 >> 4));
}

// fn(row, col, v[col], v[col + 1]) over a warpgroup's accumulators (wgmma's
// layout: warp wi of the group holds rows 16 wi + g and 16 wi + g + 8 of
// each m64 tile, columns 8 j + 2 t and 8 j + 2 t + 1).
template <class SP, typename Fn>
__device__ __forceinline__ void for_each_acc(
    const float (&acc)[SP::MTW][SP::NACC], int mt0, int n0, int wi, int lane,
    Fn fn) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < SP::MTW; ++mt) {
    const int r = (mt0 + mt) * 64 + wi * 16 + g;
#pragma unroll
    for (int j = 0; j < SP::NI / 8; ++j) {
      const int n = n0 + j * 8 + 2 * t;
      fn(r, n, acc[mt][4 * j], acc[mt][4 * j + 1]);
      fn(r + 8, n, acc[mt][4 * j + 2], acc[mt][4 * j + 3]);
    }
  }
}

template <class SP>
__device__ __forceinline__ void zero(float (&acc)[SP::MTW][SP::NACC]) {
#pragma unroll
  for (int mt = 0; mt < SP::MTW; ++mt)
#pragma unroll
    for (int i = 0; i < SP::NACC; ++i) acc[mt][i] = 0.0f;
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <class P>
__global__ void __launch_bounds__(kThreads, 1)
    bottleneck_wgmma(const __grid_constant__ CUtensorMap tm1,
                     const __grid_constant__ CUtensorMap tm2,
                     const __grid_constant__ CUtensorMap tm3,
                     const bf16* __restrict__ x, const float* __restrict__ b1,
                     const float* __restrict__ b2,
                     const float* __restrict__ b3, bf16* __restrict__ y, int H,
                     int W, int C, int Wd) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t ring_s = (raw_s + 1023) & ~1023u;  // swizzle wants 1024
  unsigned char* base = smem_raw + (ring_s - raw_s);
  bf16* const sm = reinterpret_cast<bf16*>(base + P::RING);  // m; y tile
  bf16* const sm2 =
      reinterpret_cast<bf16*>(base + P::RING + P::M_BYTES);  // x; m2
  const uint32_t full_s = ring_s + P::RING + P::M_BYTES + P::M2_BYTES;
  const uint32_t empty_s = full_s + P::S * 8;

  const int nk1 = C / 64, nk2 = (Wd + 63) / 64;  // 64-deep k-slices

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::S; ++s) {
      mbar_init(full_s + 8 * s, 1);
      mbar_init(empty_s + 8 * s, (kConsumers / 32) * P::CL);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync<P::CL>();

  if (threadIdx.x >= kConsumers) {
    // producer: one thread walks the slices in the consumers' order
    if (threadIdx.x == kConsumers) {
      const uint32_t rank = P::CL == 1 ? 0 : cluster_rank();
      int i = 0;
      auto next = [&](int rows, auto issue) {
        const int slot = i % P::S;
        mbar_wait(empty_s + 8 * slot, ((i / P::S) & 1) ^ 1);
        mbar_expect_tx(full_s + 8 * slot, rows * 128);
        const int part = rows / P::CL;  // this CTA's share of the slice
        issue(ring_s + slot * P::SLOT + rank * part * 128,
              full_s + 8 * slot, (int)rank * part);
        ++i;
      };
      for (int nc = 0; nc < Wd; nc += P::N1)
        for (int kc = 0; kc < nk1; ++kc)
          next(P::N1, [&](uint32_t dst, uint32_t bar, int r0) {
            tma_2d<P::CL>(dst, &tm1, kc * 64, nc + r0, bar);
          });
      for (int nc = 0; nc < Wd; nc += P::N2)
        for (int tap = 0; tap < 9; ++tap)
          for (int kc = 0; kc < nk2; ++kc)
            next(P::N2, [&](uint32_t dst, uint32_t bar, int r0) {
              tma_3d<P::CL>(dst, &tm2, kc * 64, nc + r0, tap, bar);
            });
      for (int nc = 0; nc < C; nc += P::N3)
        for (int kc = 0; kc < nk2; ++kc)
          next(P::N3, [&](uint32_t dst, uint32_t bar, int r0) {
            tma_2d<P::CL>(dst, &tm3, kc * 64, nc + r0, bar);
          });
    }
    __syncwarp();
  } else {
    const int ct = threadIdx.x, wgi = ct >> 7, wi = (ct >> 5) & 3;
    const int lane = ct & 31;
    const int i0 = blockIdx.y * P::TH, j0 = blockIdx.x * P::TW;
    const size_t img = (size_t)blockIdx.z * H * W;
    int it = 0;  // slices consumed, in the producer's order
    auto wait_full = [&]() {
      mbar_wait(full_s + 8 * (it % P::S), (it / P::S) & 1);
    };
    auto slot_desc = [&](int col0) {  // the slot's descriptor at column col0
      return desc_sw128(ring_s + (it % P::S) * P::SLOT + col0 * 128);
    };
    // A slice's products are committed as one group; its slot is
    // released once the next slice's group is in flight (or at drain(),
    // before the accumulators are read), in every CTA of the cluster.
    bool pending = false;
    // (lane c of each warp arrives for cluster CTA c: the CL remote
    // arrivals go out in parallel)
    auto release_slot = [&](int i) {
      if constexpr (P::CL == 1) {
        if (lane == 0) mbar_arrive(empty_s + 8 * (i % P::S));
      } else {
        if (lane < P::CL) mbar_arrive_cluster(empty_s + 8 * (i % P::S), lane);
      }
    };
    auto release = [&]() {
      wgmma_commit();
      wgmma_wait<1>();
      if (pending) release_slot(it - 1);
      pending = true;
      ++it;
    };
    auto drain = [&]() {
      wgmma_wait<0>();
      if (pending) release_slot(it - 1);
      pending = false;
    };
    // haloed pixel r (row-major over (TH+2) x (TW+2)): image row or -1,
    // and its column (wrapped)
    auto halo_gi = [&](int r) {
      const int gi = i0 + r / (P::TW + 2) - 1;
      return (r < P::P1 && gi >= 0 && gi < H) ? gi : -1;
    };
    auto halo_gj = [&](int r) {
      return ((j0 + r % (P::TW + 2) - 1) % W + W) % W;
    };

    // conv1 over the haloed pixels -> m
    {
      using SP = Split<P::MT1, P::N1>;
      const int mt0 = SP::kByN ? 0 : wgi * SP::MTW;
      const int n0 = SP::kByN ? wgi * SP::NI : 0;
      constexpr int XB = P::XSTAGE;
      // this thread's rows of every x stage (r = ct / 4 + 64 i, 8 channels
      // at (ct % 4) * 8): their pixel offsets in x, or -1 outside the image
      constexpr int XR = SP::MTP;
      long long xsrc[XR];
#pragma unroll
      for (int i = 0; i < XR; ++i) {
        const int r = ct / 4 + 64 * i, gi = halo_gi(r);
        xsrc[i] = gi >= 0 ? (long long)(img + (size_t)gi * W + halo_gj(r)) * C +
                                (ct % 4) * 8
                          : -1;
      }
      for (int nc = 0; nc < Wd; nc += P::N1) {
        float acc[SP::MTW][SP::NACC];
        zero<SP>(acc);
        auto stage_x = [&](int q) {  // channels [32 q, 32 q + 32)
          bf16* dst = sm2 + (q % P::XN) * XB + (ct / 4) * kXS + (ct % 4) * 8;
#pragma unroll
          for (int i = 0; i < XR; ++i)
            cp_async16(dst + 64 * i * kXS,
                       xsrc[i] >= 0 ? x + xsrc[i] + q * kXK : x,
                       xsrc[i] >= 0 ? 16 : 0);
          cp_commit();
        };
        const int nq = 2 * nk1;  // x stages, XN - 1 of them ahead
        bar_consumers();  // the last pass is done with every stage
        for (int q = 0; q < P::XN - 1; ++q)
          if (q < nq)
            stage_x(q);
          else
            cp_commit();
        for (int s = 0; s < nk1; ++s) {
          wait_full();
          const uint64_t desc = slot_desc(n0);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = 2 * s + h;
            cp_wait<P::XN - 2>();
            bar_consumers();  // stage q landed; stage q - 1 is free
            if (q + P::XN - 1 < nq)
              stage_x(q + P::XN - 1);
            else
              cp_commit();
            const bf16* xs = sm2 + (q % P::XN) * XB;
#pragma unroll
            for (int kk = 0; kk < 2; ++kk)
              k16_wgmma<SP>(
                  acc, [&](int r) { return xs + r * kXS + kk * 16; }, mt0,
                  desc + (2 * h + kk) * 2, wi, lane);
          }
          release();
        }
        drain();
        for_each_acc<SP>(acc, mt0, n0, wi, lane,
                         [&](int r, int n, float v0, float v1) {
                           const int col = nc + n;
                           if (r >= P::P1) return;
                           const bool in = halo_gi(r) >= 0 && col < Wd;
                           store_bf16x2(sm + r * P::SM + col,
                                        in ? fmaxf(v0 + b1[col], 0.f) : 0.f,
                                        in ? fmaxf(v1 + b1[col + 1], 0.f)
                                           : 0.f);
                         });
      }
    }
    bar_consumers();  // m complete; x's stages free for m2

    // conv2: 9 taps, A rows gathered from m -> m2
    {
      using SP = Split<P::MT2, P::N2>;
      const int mt0 = SP::kByN ? 0 : wgi * SP::MTW;
      const int n0 = SP::kByN ? wgi * SP::NI : 0;
      for (int nc = 0; nc < Wd; nc += P::N2) {
        float acc[SP::MTW][SP::NACC];
        zero<SP>(acc);
        for (int tap = 0; tap < 9; ++tap) {
          const int dy = tap / 3, dx = tap % 3;
          for (int kc = 0; kc < nk2; ++kc) {
            wait_full();
            const uint64_t desc = slot_desc(n0);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              k16_wgmma<SP>(
                  acc,
                  [&](int p) {
                    return sm +
                           ((p / P::TW + dy) * (P::TW + 2) + p % P::TW + dx) *
                               P::SM +
                           kc * 64 + kk * 16;
                  },
                  mt0, desc + kk * 2, wi, lane);
            release();
          }
        }
        drain();
        for_each_acc<SP>(acc, mt0, n0, wi, lane,
                         [&](int p, int n, float v0, float v1) {
                           const int col = nc + n;
                           const bool in = col < Wd;
                           store_bf16x2(sm2 + p * P::SM + col,
                                        in ? fmaxf(v0 + b2[col], 0.f) : 0.f,
                                        in ? fmaxf(v1 + b2[col + 1], 0.f)
                                           : 0.f);
                         });
      }
    }

    // conv3 + b3 + residual -> y, N3 output channels a pass, through the
    // y tile in m's space (m is dead after conv2)
    {
      using SP = Split<P::MT2, P::N3>;
      const int mt0 = SP::kByN ? 0 : wgi * SP::MTW;
      const int n0 = SP::kByN ? wgi * SP::NI : 0;
      bf16* const yt = sm;
      constexpr int VR = P::N3 / 8;  // 16-byte vectors per tile row
      auto pixel = [&](int p, int nc, int c) -> size_t {  // or ~0 if outside
        const int gi = i0 + p / P::TW, gj = j0 + p % P::TW;
        if (gi >= H || gj >= W || nc + c >= C) return ~(size_t)0;
        return (img + (size_t)gi * W + gj) * C + nc + c;
      };
      for (int nc = 0; nc < C; nc += P::N3) {
        bar_consumers();  // m2 complete / the last pass's stores are out
        for (int v = ct; v < P::M2 * VR; v += kConsumers) {
          const int p = v / VR, c = (v % VR) * 8;
          const size_t o = pixel(p, nc, c);
          const bool in = o != ~(size_t)0;
          cp_async16(yt + p * P::SY + c, in ? x + o : x, in ? 16 : 0);
        }
        cp_commit();
        float acc[SP::MTW][SP::NACC];
        zero<SP>(acc);
        for (int kc = 0; kc < nk2; ++kc) {
          wait_full();
          const uint64_t desc = slot_desc(n0);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            k16_wgmma<SP>(
                acc,
                [&](int p) { return sm2 + p * P::SM + kc * 64 + kk * 16; },
                mt0, desc + kk * 2, wi, lane);
          release();
        }
        drain();
        cp_wait<0>();
        bar_consumers();  // the residual tile has landed
        for_each_acc<SP>(
            acc, mt0, n0, wi, lane,
            [&](int p, int n, float v0, float v1) {
              if (nc + n >= C) return;
              bf16* t = yt + p * P::SY + n;
              const float2 r =
                  __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(t));
              store_bf16x2(t, fmaxf(v0 + b3[nc + n] + r.x, 0.f),
                           fmaxf(v1 + b3[nc + n + 1] + r.y, 0.f));
            });
        bar_consumers();  // the y tile is complete
        for (int v = ct; v < P::M2 * VR; v += kConsumers) {
          const int p = v / VR, c = (v % VR) * 8;
          const size_t o = pixel(p, nc, c);
          if (o != ~(size_t)0)
            *reinterpret_cast<uint4*>(y + o) =
                *reinterpret_cast<const uint4*>(yt + p * P::SY + c);
        }
      }
    }
  }
  // no CTA leaves while another may still multicast into it or arrive on
  // its barriers
  cluster_sync<P::CL>();
}

// cuTensorMapEncodeTiled, looked up at run time so that the library need
// not link libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 weight map of `rank` dims (innermost first) with boxes of 64 x
// rows (x 1), swizzled for wgmma; reads past the tensor fill zeros.
bool weight_map(CUtensorMap* m, const void* ptr, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides, int rows) {
  EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
             const_cast<void*>(ptr), dims, strides, box, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class P>
dim3 grid_of(int B, int H, int W) {
  const int gx = (W + P::TW - 1) / P::TW;
  return dim3((gx + P::CL - 1) / P::CL * P::CL, (H + P::TH - 1) / P::TH, B);
}

// Weight bytes one CTA's slices bring in (in a cluster, each CTA loads
// 1/CL of them from L2 and receives the rest).
template <class P>
size_t slice_bytes(int Wd) {
  const size_t nk1 = Wd / 16, nk2 = (Wd + 63) / 64;  // C = 4 Wd
  const size_t np1 = (Wd + P::N1 - 1) / P::N1, np2 = (Wd + P::N2 - 1) / P::N2;
  const size_t np3 = (4 * Wd + P::N3 - 1) / P::N3;
  return 128 * (np1 * nk1 * P::N1 + np2 * 9 * nk2 * P::N2 + np3 * nk2 * P::N3);
}

// The tensor maps carry w1t's, w2t's and w3t's addresses into the kernel's
// parameters, and a CUDA graph that captures this launch keeps them. The
// wrapper (ops/fused_block.py) lays the weights out inside the program it
// serves, so under capture they come from the graph's own pool and stay at
// those addresses on every replay.
template <class P>
int launch(const void* x, const void* w1t, const void* b1, const void* w2t,
           const void* b2, const void* w3t, const void* b3, void* y, int B,
           int H, int W, int C, int Wd, cudaStream_t s) {
  CUtensorMap tm1, tm2, tm3;
  const cuuint64_t d1[2] = {(cuuint64_t)C, (cuuint64_t)Wd};
  const cuuint64_t s1[1] = {(cuuint64_t)C * 2};
  const cuuint64_t d2[3] = {(cuuint64_t)Wd, (cuuint64_t)Wd, 9};
  const cuuint64_t s2[2] = {(cuuint64_t)Wd * 2, (cuuint64_t)Wd * Wd * 2};
  const cuuint64_t d3[2] = {(cuuint64_t)Wd, (cuuint64_t)C};
  const cuuint64_t s3[1] = {(cuuint64_t)Wd * 2};
  if (!weight_map(&tm1, w1t, 2, d1, s1, P::N1 / P::CL) ||
      !weight_map(&tm2, w2t, 3, d2, s2, P::N2 / P::CL) ||
      !weight_map(&tm3, w3t, 2, d3, s3, P::N3 / P::CL))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = smem_attr::ensure((const void*)bottleneck_wgmma<P>,
                                    (size_t)P::SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid_of<P>(B, H, W);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = P::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P::CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, bottleneck_wgmma<P>, tm1, tm2, tm3,
                         static_cast<const bf16*>(x),
                         static_cast<const float*>(b1),
                         static_cast<const float*>(b2),
                         static_cast<const float*>(b3), static_cast<bf16*>(y),
                         H, W, C, Wd);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The plan for width Wd: fn.template operator()<P>() of the one that takes
// it, or `none` if no plan does.
constexpr int kMaxWd = 512;  // the widest plan's width
template <typename Fn, typename R>
R with_plan(int Wd, Fn fn, R none) {
  const int kp = (Wd + 63) / 64 * 64;
  if (kp <= 64) return fn(P64());
  if (kp <= 128) return fn(P128());
  if (kp <= 256) return fn(P256());
  if (kp <= kMaxWd) return fn(P512());
  return none;
}

}  // namespace wg

extern "C" {

// Bytes of dynamic shared memory one CTA needs at width Wd (0 for a bf16
// width that no tile plan takes).
size_t fused_bottleneck_smem_bytes(int Wd, int is_bf16) {
  if (!is_bf16) return fb::smem_bytes(Wd, fb::stages(Wd));
  return wg::with_plan(
      Wd, [](auto p) { return (size_t)decltype(p)::SMEM; }, (size_t)0);
}

// The widest bf16 width a tile plan takes.
int fused_bottleneck_bf16_max_width() { return wg::kMaxWd; }

// Weight bytes a bf16 launch reads from L2 (each slice once per cluster).
size_t fused_bottleneck_weight_bytes(int B, int H, int W, int Wd) {
  return wg::with_plan(
      Wd,
      [&](auto p) {
        using P = decltype(p);
        const dim3 g = wg::grid_of<P>(B, H, W);
        return (size_t)g.x * g.y * g.z / P::CL * wg::slice_bytes<P>(Wd);
      },
      (size_t)0);
}

// One block on `stream`. Pointers are 16-byte aligned and contiguous in
// the layouts above. Returns the CUDA error of the launch (0 on success);
// a cluster or TMA launch the card refuses returns its error.
int fused_bottleneck(const void* x, const void* w1t, const void* b1,
                     const void* w2t, const void* b2, const void* w3t,
                     const void* b3, void* y, int B, int H, int W, int C,
                     int Wd, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Wd <= 0 || Wd % 16 != 0 || C != 4 * Wd)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return fb::launch_f32(
        static_cast<const float*>(x), static_cast<const float*>(w1t),
        static_cast<const float*>(b1), static_cast<const float*>(w2t),
        static_cast<const float*>(b2), static_cast<const float*>(w3t),
        static_cast<const float*>(b3), static_cast<float*>(y), B, H, W, C, Wd,
        s);
  return wg::with_plan(
      Wd,
      [&](auto p) {
        return wg::launch<decltype(p)>(x, w1t, b1, w2t, b2, w3t, b3, y, B, H,
                                       W, C, Wd, s);
      },
      (int)cudaErrorInvalidValue);
}

const char* fused_bottleneck_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
