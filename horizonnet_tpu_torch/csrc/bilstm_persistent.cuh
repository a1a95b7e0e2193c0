// The persistent forward recurrence of the bidirectional LSTM, shared by the
// serving kernel (K1, bilstm_fwd.cu) and the training forward (K2,
// bilstm_train.cu), which is the same recurrence plus the residuals of the
// backward: with kRes the cell also stores the post-activation gates
// [T, D, B, 4H] (i, f, g, o) and the cell states [T, D, B, H] in the
// outputs' type. bilstm_fwd.cu's header gives the contract and the design.
// direction_barrier, split3, mma_bf16 and ld_acquire also serve K3's
// backward recurrence in bilstm_train.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace bilstm {

constexpr int kUnits = 8;      // hidden units per CTA
constexpr int kGateRows = 32;  // 4 gates x kUnits: the product's M
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBT = 64;        // batch rows per tile
constexpr int kPartStride = kBT + 4;
constexpr int kMaxH = 1024;    // W fragments in registers: H / 16 a thread
// f32 path
constexpr int kRows = 4;       // batch rows per thread
constexpr int kGroup = 128;    // threads per K half
constexpr int kPad = 4;        // floats of row padding in shared memory

__host__ __device__ constexpr size_t smem_bf16() {
  return (size_t)kWarps * kGateRows * kPartStride * sizeof(float);
}
__host__ __device__ constexpr size_t smem_f32(int H) {
  return ((size_t)(kGateRows + kBT) * (H + kPad) + (size_t)kBT * kGateRows) *
         sizeof(float);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 a,
                                              __nv_bfloat16 b) {
  __nv_bfloat162 v;
  v.x = a;
  v.y = b;
  return *reinterpret_cast<uint32_t*>(&v);
}

// The exact split of two f32 values into three bf16 pairs: hi + mid + lo.
__device__ __forceinline__ void split3(float2 v, uint32_t (&out)[3]) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(v.x);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(v.y);
  const float r0 = v.x - __bfloat162float(h0);
  const float r1 = v.y - __bfloat162float(h1);
  const __nv_bfloat16 m0 = __float2bfloat16_rn(r0);
  const __nv_bfloat16 m1 = __float2bfloat16_rn(r1);
  out[0] = pack_bf16(h0, h1);
  out[1] = pack_bf16(m0, m1);
  out[2] = pack_bf16(r0 - __bfloat162float(m0), r1 - __bfloat162float(m1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Publishes this CTA's part of step t's exchange and waits until all CTAs
// of this direction have published theirs; `meanwhile` (loads that do not
// depend on the exchange) runs after the arrival and before the wait.
template <typename Fn>
__device__ __forceinline__ void direction_barrier(unsigned* flag, int t,
                                                  Fn meanwhile) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(flag, 1u);
  }
  meanwhile();
  if (threadIdx.x == 0) {
    const unsigned target = (unsigned)(t + 1) * gridDim.x;
    while (ld_acquire(flag) < target) {
    }
  }
  __syncthreads();
}

// Cell update of (unit u, batch row b) at step t from the pre-activations;
// with kRes it also stores the gates and the cell state.
template <bool kRes, typename T>
__device__ __forceinline__ void cell(const float (&s)[4], int t, int d, int D,
                                     int b, int B, int H, int j, float* c,
                                     float* h_next, T* ys, T* gates, T* cs) {
  const float gi = sigmoid(s[0]), gf = sigmoid(s[1]), gg = tanhf(s[2]),
              go = sigmoid(s[3]);
  const size_t o = (size_t)b * H + j;
  const float cn = gf * (t > 0 ? c[o] : 0.0f) + gi * gg;
  const float hn = go * tanhf(cn);
  c[o] = cn;
  h_next[o] = hn;
  const size_t yo = ((size_t)t * D + d) * B * H + o;
  store(ys + yo, hn);
  if constexpr (kRes) {
    T* g = gates + (((size_t)t * D + d) * B + b) * 4 * H + j;
    store(g, gi);
    store(g + H, gf);
    store(g + 2 * H, gg);
    store(g + 3 * H, go);
    store(cs + yo, cn);
  }
}

template <int KS, bool kRes>
__global__ void __launch_bounds__(kThreads, 1)
    recurrence_bf16(const __nv_bfloat16* __restrict__ xw,
                    const __nv_bfloat16* __restrict__ w_hh_t,
                    __nv_bfloat16* __restrict__ ys, float* h_buf,
                    float* __restrict__ c_buf, unsigned* flags, int T_, int B,
                    int H, __nv_bfloat16* __restrict__ gates,
                    __nv_bfloat16* __restrict__ cs) {
  extern __shared__ float4 smem4[];
  float* part = reinterpret_cast<float*>(smem4);  // [warp][32][kPartStride]
  const int D = gridDim.y, d = blockIdx.y, j0 = blockIdx.x * kUnits;
  const int G = 4 * H, nk = H / 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;

  // This CTA's W^T rows (gate * kUnits + u) as resident A fragments; warp
  // w owns the 16-deep K slices w, w + 8, ...
  uint32_t a[KS][2][4];
  {
    const __nv_bfloat16* w = w_hh_t + (size_t)d * H * G + j0;
    auto wv = [&](int r, int k) {
      return w[(size_t)k * G + (r / kUnits) * H + r % kUnits];
    };
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int kk = warp + kWarps * ks;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = mt * 16 + g, k = kk * 16 + 2 * tq;
        if (kk < nk) {
          a[ks][mt][0] = pack_bf16(wv(r, k), wv(r, k + 1));
          a[ks][mt][1] = pack_bf16(wv(r + 8, k), wv(r + 8, k + 1));
          a[ks][mt][2] = pack_bf16(wv(r, k + 8), wv(r, k + 9));
          a[ks][mt][3] = pack_bf16(wv(r + 8, k + 8), wv(r + 8, k + 9));
        } else {
          a[ks][mt][0] = a[ks][mt][1] = a[ks][mt][2] = a[ks][mt][3] = 0u;
        }
      }
    }
  }

  const size_t plane = (size_t)D * B * H;
  float* c = c_buf + (size_t)d * B * H;
  // this thread's cell pairs: (u, row) = (p % 8, p / 8), p = tid + 256 q;
  // their gate inputs at step t
  float s_next[2][4];
  auto load_x = [&](int t, int b0, int nb, float (&sx)[2][4]) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int p = tid + kThreads * q, bl = p / kUnits;
      if (bl < nb) {
        const __nv_bfloat16* x = xw + ((size_t)t * D + d) * B * G +
                                 (size_t)(b0 + bl) * G + j0 + p % kUnits;
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
          sx[q][gate] = __bfloat162float(x[gate * H]);
      }
    }
  };
  for (int t = 0; t < T_; ++t) {
    const float* h_prev = h_buf + ((t + 1) & 1) * plane + (size_t)d * B * H;
    float* h_next = h_buf + (t & 1) * plane + (size_t)d * B * H;
    for (int b0 = 0; b0 < B; b0 += kBT) {
      const int nb = min(kBT, B - b0);
      // with one batch tile, step t's inputs were loaded before the last
      // barrier
      if (B > kBT || t == 0) load_x(t, b0, nb, s_next);
      float s[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) s[q][gate] = s_next[q][gate];
      if (t > 0) {
        float acc[2][kBT / 8][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < kBT / 8; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
        // h_{t-1} at this warp's K slice ks for every n8 tile of the batch
        // tile, read past L1; slice ks + 1's loads go out before slice ks's
        // products, so one L2 round trip is exposed per step, not one per
        // n8 tile
        float2 hv[2][kBT / 8][2];
        auto load = [&](int ks, float2 (&v)[kBT / 8][2]) {
          const bool kin = warp + kWarps * ks < nk;
          const int k = (warp + kWarps * ks) * 16 + 2 * tq;
#pragma unroll
          for (int nt = 0; nt < kBT / 8; ++nt) {
            const int bl = nt * 8 + g;
            v[nt][0] = v[nt][1] = make_float2(0.f, 0.f);
            if (kin && bl < nb) {
              const float* hp = h_prev + (size_t)(b0 + bl) * H + k;
              v[nt][0] = __ldcg(reinterpret_cast<const float2*>(hp));
              v[nt][1] = __ldcg(reinterpret_cast<const float2*>(hp + 8));
            }
          }
        };
        load(0, hv[0]);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          if (ks + 1 < KS) load(ks + 1, hv[(ks + 1) & 1]);
          if (warp + kWarps * ks >= nk) continue;
#pragma unroll
          for (int nt = 0; nt < kBT / 8; ++nt) {
            if (nt * 8 >= nb) continue;
            uint32_t b_lo[3], b_hi[3];
            split3(hv[ks & 1][nt][0], b_lo);
            split3(hv[ks & 1][nt][1], b_hi);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int term = 2; term >= 0; --term)
                mma_bf16(acc[mt][nt], a[ks][mt], b_lo[term], b_hi[term]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < kBT / 8; ++nt) {
            float* p = part + (warp * kGateRows + mt * 16 + g) * kPartStride +
                       nt * 8 + 2 * tq;
            *reinterpret_cast<float2*>(p) =
                make_float2(acc[mt][nt][0], acc[mt][nt][1]);
            *reinterpret_cast<float2*>(p + 8 * kPartStride) =
                make_float2(acc[mt][nt][2], acc[mt][nt][3]);
          }
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int p = tid + kThreads * q, bl = p / kUnits, u = p % kUnits;
        if (bl >= nb) continue;
        if (t > 0) {
#pragma unroll
          for (int gate = 0; gate < 4; ++gate)
#pragma unroll
            for (int w = 0; w < kWarps; ++w)
              s[q][gate] +=
                  part[(w * kGateRows + gate * kUnits + u) * kPartStride + bl];
        }
        cell<kRes>(s[q], t, d, D, b0 + bl, B, H, j0 + u, c, h_next, ys, gates,
                   cs);
      }
      __syncthreads();  // the next tile rewrites part
    }
    if (t + 1 < T_)
      direction_barrier(flags + d, t, [&] {
        if (B <= kBT) load_x(t + 1, 0, B, s_next);
      });
  }
}

template <bool kRes>
__global__ void __launch_bounds__(kThreads, 1)
    recurrence_f32(const float* __restrict__ xw, const float* __restrict__ w_hh_t,
                   float* __restrict__ ys, float* h_buf,
                   float* __restrict__ c_buf, unsigned* flags, int T_, int B,
                   int H, float* __restrict__ gates, float* __restrict__ cs) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = gridDim.y, d = blockIdx.y, j0 = blockIdx.x * kUnits;
  const int G = 4 * H, stride = H + kPad;
  float* w_s = smem;                        // [32][stride], gate-major
  float* h_s = w_s + kGateRows * stride;    // [kBT][stride]
  float* part = h_s + kBT * stride;         // [kBT][32]
  const int tid = threadIdx.x, half = tid / kGroup, j = tid % kUnits;
  const int rq = (tid % kGroup) / kUnits, k_lo = half * (H / 2);

  {
    const float* w = w_hh_t + (size_t)d * H * G + j0;
    for (int idx = tid; idx < kGateRows * H; idx += kThreads) {
      const int r = idx / H, k = idx % H;
      w_s[r * stride + k] = w[(size_t)k * G + (r / kUnits) * H + r % kUnits];
    }
  }
  const size_t plane = (size_t)D * B * H;
  float* c = c_buf + (size_t)d * B * H;
  for (int t = 0; t < T_; ++t) {
    const float* h_prev = h_buf + ((t + 1) & 1) * plane + (size_t)d * B * H;
    float* h_next = h_buf + (t & 1) * plane + (size_t)d * B * H;
    for (int b0 = 0; b0 < B; b0 += kBT) {
      const int nb = min(kBT, B - b0);
      float acc[kRows][4] = {};
      __syncthreads();  // w_s written, or the previous tile done with h_s
      if (t > 0) {
        const int h4 = H / 4;
        for (int idx = tid; idx < kBT * h4; idx += kThreads) {
          const int r = idx / h4, k4 = idx % h4;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r < nb)
            v = __ldcg(reinterpret_cast<const float4*>(h_prev +
                                                       (size_t)(b0 + r) * H) +
                       k4);
          reinterpret_cast<float4*>(h_s + r * stride)[k4] = v;
        }
        __syncthreads();
        for (int k = k_lo; k < k_lo + H / 2; k += 4) {
          float4 w4[4];
#pragma unroll
          for (int gate = 0; gate < 4; ++gate)
            w4[gate] = *reinterpret_cast<const float4*>(
                w_s + (gate * kUnits + j) * stride + k);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float4 hv = *reinterpret_cast<const float4*>(
                h_s + (rq * kRows + r) * stride + k);
#pragma unroll
            for (int gate = 0; gate < 4; ++gate) {
              float x = acc[r][gate];
              x = fmaf(hv.x, w4[gate].x, x);
              x = fmaf(hv.y, w4[gate].y, x);
              x = fmaf(hv.z, w4[gate].z, x);
              x = fmaf(hv.w, w4[gate].w, x);
              acc[r][gate] = x;
            }
          }
        }
        if (half == 1) {
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int gate = 0; gate < 4; ++gate)
              part[(rq * kRows + r) * kGateRows + gate * kUnits + j] =
                  acc[r][gate];
        }
        __syncthreads();
      }
      if (half != 0) continue;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int bl = rq * kRows + r;
        if (bl >= nb) continue;
        const float* x = xw + ((size_t)t * D + d) * B * G +
                         (size_t)(b0 + bl) * G + j0 + j;
        float s[4];
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
          s[gate] = x[gate * H] + acc[r][gate] +
                    (t > 0 ? part[bl * kGateRows + gate * kUnits + j] : 0.f);
        cell<kRes>(s, t, d, D, b0 + bl, B, H, j0 + j, c, h_next, ys, gates,
                   cs);
      }
    }
    if (t + 1 < T_) direction_barrier(flags + d, t, [] {});
  }
}

// A cooperative launch of (grid_x, D) CTAs of kThreads: refused, and the
// error returned, unless the card can hold them all at once.
template <typename Kernel>
int launch(Kernel kernel, size_t smem, void** args, int grid_x, int D,
           cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaLaunchCooperativeKernel((const void*)kernel,
                                          dim3(grid_x, D), dim3(kThreads),
                                          args, smem, s);
}

}  // namespace bilstm
