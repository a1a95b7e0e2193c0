// Training pair of the bidirectional LSTM recurrence, written by hand for
// Hopper (sm_90a): the forward that keeps the residuals of the backward
// (K2) and the reverse-time backward (K3).
//
// K2 replaces horizonnet_tpu/ops/pallas_lstm.py::_bilstm_train_fwd_kernel
// (wrapped there by _train_fwd): one launch per time step (bilstm_step
// below), which also stores the residuals of the backward:
//   xw     [T, D, B, 4H]  hoisted input projection + bias, f32 or bf16
//   w_hh_t [D, H, 4H]     recurrent weights, transposed; xw's type
//   ys     [T, D, B, H]   hidden states          } all three in xw's type,
//   gates  [T, D, B, 4H]  post-activation i,f,g,o } as the TPU kernel
//   cs     [T, D, B, H]   cell states            } stores them
//
// K3 replaces horizonnet_tpu/ops/pallas_lstm.py::_bilstm_bwd_kernel
// (wrapped by _train_bwd). Grid step j visits t = T-1-j:
//   dh   = dy_t + dh_carry,   dh_carry = da_{t+1} @ W^T   (zero at t = T-1)
//   tc   = tanh(c_t)
//   da_o = dh tc o(1-o)
//   dc   = dh o (1-tc^2) + dc_carry,   dc_carry = dc_{t+1} f_{t+1}
//   da_f = dc c_{t-1} f(1-f),  da_i = dc g i(1-i),  da_g = dc i (1-g^2)
//   dxw_t = [da_i, da_f, da_g, da_o]   in the gates' type
// It reads c_{t-1} from cs itself (zero at t = 0) where the TPU kernel
// takes a shifted copy. dW = sum over (t, b) of h_{t-1} da_t is one large
// product outside the kernel (ops/cuda_lstm_train.py), as in JAX.
//
// What bounds them on the H100: each is a chain of T = 256 dependent steps.
// At the training shape (B = 8, H = 512, D = 2) a step is a [8, 512] x
// [512, 2048] product per direction in K2 and [8, 2048] x [2048, 512] in
// K3, 34 MFLOP per step and 8.6 GFLOP per call: 0.13 ms at the 67 TFLOP/s
// f32 CUDA-core peak, against some 2 ms of per-step latency (launch, the
// reload of this CTA's slice of W from L2, the exchange of h or da through
// global memory). The contract (W widened to f32, h, c, dh, dc carried in
// f32) keeps the products on CUDA cores.
//
// K3's design is K2's step transposed. A CTA owns kUnits hidden units of one
// direction: grid (H / kUnits, D) = 128 CTAs at H = 512. Per step it
// stages its rows of W^T (w_hh_t[d, j0:j0+8, :], 8 x 4H f32, 64 KB at
// H = 512) and a tile of kBwdRows batch rows of da_{t+1} (the whole 4H
// width, f32) in shared memory. Each of its 8 warps owns 2 batch rows x 4
// units and splits the 4H-long contraction over its 32 lanes (float4
// reads, neighbouring lanes on neighbouring addresses), then reduces
// across lanes with shuffles. Eight lanes of the warp then run the cell
// backward of its 8 (row, unit) pairs: they write dxw_t and their columns
// of the next da buffer. da lives in a double-buffered f32 array in global
// memory, because every CTA reads all 4H columns of it; dc stays in this
// CTA's slice of a second array. One launch per step orders the steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace bilstm {

constexpr int kUnits = 8;                              // hidden units per CTA
constexpr int kRows = 4;                               // batch rows per thread
constexpr int kSplit = 2;                              // K halves per CTA
constexpr int kGroup = 128;                            // threads per K half
constexpr int kThreads = kSplit * kGroup;
constexpr int kBatchTile = kGroup / kUnits * kRows;    // 64 rows per pass
constexpr int kPad = 4;                                // floats per smem row

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Dynamic shared memory of the forward step: W slice, h tile, and the
// split-K partial sums.
__host__ __device__ constexpr size_t fwd_smem_floats(int H) {
  return (size_t)(4 * kUnits + kBatchTile) * (H + kPad)
         + (size_t)kBatchTile * 4 * kUnits;
}

// Step t of K2: h_t, and the post-activation gates [T, D, B, 4H] (i, f, g,
// o) and the cell states [T, D, B, H] as residuals, all in T's type.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bilstm_step(const T* __restrict__ xw, const T* __restrict__ w_hh_t,
                T* __restrict__ ys, T* __restrict__ gates, T* __restrict__ cs,
                float* __restrict__ h_buf, float* __restrict__ c_buf, int B,
                int H, int t) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int D = gridDim.y;
  const int d = blockIdx.y;
  const int j0 = blockIdx.x * kUnits;
  const int G = 4 * H;
  const int stride = H + kPad;
  float* w_s = smem;                         // [4 * kUnits][stride]
  float* h_s = w_s + 4 * kUnits * stride;    // [kBatchTile][stride]
  float* part = h_s + kBatchTile * stride;   // [kBatchTile][4 * kUnits]
  const int tid = threadIdx.x;
  const int half = tid / kGroup;             // which half of K
  const int j = tid % kUnits;
  const int rq = (tid % kGroup) / kUnits;
  const int k_lo = half * (H / kSplit);

  const size_t plane = (size_t)D * B * H;
  const float* h_prev = h_buf + ((t + 1) & 1) * plane + (size_t)d * B * H;
  float* h_next = h_buf + (t & 1) * plane + (size_t)d * B * H;
  float* c = c_buf + (size_t)d * B * H;

  if (t > 0) {
    // This CTA's columns of W_hh^T, gate-major: w_s[gate*kUnits + u][k],
    // 8 units (16 bytes of bf16) per load
    const T* w = w_hh_t + (size_t)d * H * G + j0;
    for (int idx = tid; idx < 4 * H; idx += kThreads) {
      const int k = idx % H;
      const int gate = idx / H;
      float v[kUnits];
      load8(w + (size_t)k * G + gate * H, v);
#pragma unroll
      for (int u = 0; u < kUnits; ++u)
        w_s[(gate * kUnits + u) * stride + k] = v[u];
    }
  }

  for (int b0 = 0; b0 < B; b0 += kBatchTile) {
    const int nb = min(kBatchTile, B - b0);
    float acc[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;

    if (t > 0) {
      __syncthreads();  // w_s written, or the previous pass done with h_s
      const int h4 = H / 4;
      for (int idx = tid; idx < kBatchTile * h4; idx += kThreads) {
        const int r = idx / h4;
        const int k4 = idx % h4;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (r < nb)
          v = reinterpret_cast<const float4*>(h_prev +
                                              (size_t)(b0 + r) * H)[k4];
        reinterpret_cast<float4*>(h_s + r * stride)[k4] = v;
      }
      __syncthreads();

      for (int k = k_lo; k < k_lo + H / kSplit; k += 4) {
        float4 w4[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          w4[g] = *reinterpret_cast<const float4*>(
              w_s + (g * kUnits + j) * stride + k);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 hv = *reinterpret_cast<const float4*>(
              h_s + (rq * kRows + r) * stride + k);
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            float a = acc[r][g];
            a = fmaf(hv.x, w4[g].x, a);
            a = fmaf(hv.y, w4[g].y, a);
            a = fmaf(hv.z, w4[g].z, a);
            a = fmaf(hv.w, w4[g].w, a);
            acc[r][g] = a;
          }
        }
      }
      // the upper K half hands its partial sums to the lower half
      if (half == 1) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            part[(rq * kRows + r) * 4 * kUnits + g * kUnits + j] = acc[r][g];
      }
      __syncthreads();
      if (half == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            acc[r][g] += part[(rq * kRows + r) * 4 * kUnits + g * kUnits + j];
      }
    }
    if (half != 0) continue;

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = b0 + rq * kRows + r;
      if (b >= B) continue;
      const size_t xo = ((size_t)t * D + d) * B * G + (size_t)b * G + j0 + j;
      const T* x = xw + xo;
      const float gi = sigmoid(to_f32(x[0]) + acc[r][0]);
      const float gf = sigmoid(to_f32(x[H]) + acc[r][1]);
      const float gg = tanhf(to_f32(x[2 * H]) + acc[r][2]);
      const float go = sigmoid(to_f32(x[3 * H]) + acc[r][3]);
      const size_t o = (size_t)b * H + j0 + j;
      const float c_prev = t > 0 ? c[o] : 0.0f;
      const float cn = gf * c_prev + gi * gg;
      const float hn = go * tanhf(cn);
      c[o] = cn;
      h_next[o] = hn;
      const size_t yo = ((size_t)t * D + d) * B * H + o;
      store(ys + yo, hn);
      store(gates + xo, gi);
      store(gates + xo + H, gf);
      store(gates + xo + 2 * H, gg);
      store(gates + xo + 3 * H, go);
      store(cs + yo, cn);
    }
  }
}

// The whole forward recurrence on `stream`, one launch per step. h_buf is
// [2, D, B, H] f32 and c_buf [D, B, H] f32 scratch; neither needs
// initialising. Returns cudaGetLastError() of the launches.
template <typename T>
int run_forward(const void* xw, const void* w_hh_t, void* ys, void* gates,
                void* cs, void* h_buf, void* c_buf, int T_, int D, int B,
                int H, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats(H) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      bilstm_step<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H / kUnits, D);
  for (int t = 0; t < T_; ++t) {
    bilstm_step<T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(xw), static_cast<const T*>(w_hh_t),
        static_cast<T*>(ys), static_cast<T*>(gates), static_cast<T*>(cs),
        static_cast<float*>(h_buf), static_cast<float*>(c_buf), B, H, t);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

constexpr int kBwdRows = 8;                  // batch rows per pass
constexpr int kWarps = kThreads / 32;        // 8
constexpr int kUnitQuads = kUnits / 4;       // 2
static_assert(kWarps == (kBwdRows / 2) * kUnitQuads,
              "one warp per 2 rows x 4 units");

__host__ __device__ constexpr size_t bwd_smem_floats(int H) {
  return (size_t)(kUnits + kBwdRows) * (4 * H + kPad);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bilstm_bwd_step(const T* __restrict__ gates, const T* __restrict__ cs,
                    const T* __restrict__ dy, const T* __restrict__ w_hh_t,
                    T* __restrict__ dxw, float* __restrict__ da_buf,
                    float* __restrict__ dc_buf, int B, int H, int T_,
                    int step) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int t = T_ - 1 - step;
  const int D = gridDim.y;
  const int d = blockIdx.y;
  const int j0 = blockIdx.x * kUnits;
  const int G = 4 * H;
  const int stride = G + kPad;
  float* w_s = smem;                        // [kUnits][stride]
  float* da_s = w_s + kUnits * stride;      // [kBwdRows][stride]
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int rp = warp / kUnitQuads;         // rows 2 rp, 2 rp + 1 of a pass
  const int uq = warp % kUnitQuads;         // units 4 uq .. 4 uq + 3

  const size_t plane = (size_t)D * B * G;
  const float* da_prev = da_buf + ((step + 1) & 1) * plane + (size_t)d * B * G;
  float* da_next = da_buf + (step & 1) * plane + (size_t)d * B * G;
  float* dc = dc_buf + (size_t)d * B * H;

  if (step > 0) {
    // rows j0 .. j0+7 of w_hh_t[d] (= columns of W^T), widened to f32
    const T* w = w_hh_t + ((size_t)d * H + j0) * G;
    const int g8 = G / 8;
    for (int idx = tid; idx < kUnits * g8; idx += kThreads) {
      const int u = idx / g8;
      const int k = (idx % g8) * 8;
      float v[8];
      load8(w + (size_t)u * G + k, v);
      float4* dst = reinterpret_cast<float4*>(w_s + u * stride + k);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }

  for (int b0 = 0; b0 < B; b0 += kBwdRows) {
    const int nb = min(kBwdRows, B - b0);
    float acc[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;

    if (step > 0) {
      __syncthreads();  // w_s written, or the previous pass done with da_s
      const int g4 = G / 4;
      for (int idx = tid; idx < kBwdRows * g4; idx += kThreads) {
        const int r = idx / g4;
        const int k4 = idx % g4;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (r < nb)
          v = reinterpret_cast<const float4*>(da_prev +
                                              (size_t)(b0 + r) * G)[k4];
        reinterpret_cast<float4*>(da_s + r * stride)[k4] = v;
      }
      __syncthreads();

      const float* a_row0 = da_s + (2 * rp) * stride;
      const float* a_row1 = a_row0 + stride;
      for (int k = 4 * lane; k < G; k += 128) {
        const float4 a0 = *reinterpret_cast<const float4*>(a_row0 + k);
        const float4 a1 = *reinterpret_cast<const float4*>(a_row1 + k);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 w4 = *reinterpret_cast<const float4*>(
              w_s + (4 * uq + q) * stride + k);
          float s0 = acc[0][q], s1 = acc[1][q];
          s0 = fmaf(a0.x, w4.x, s0); s1 = fmaf(a1.x, w4.x, s1);
          s0 = fmaf(a0.y, w4.y, s0); s1 = fmaf(a1.y, w4.y, s1);
          s0 = fmaf(a0.z, w4.z, s0); s1 = fmaf(a1.z, w4.z, s1);
          s0 = fmaf(a0.w, w4.w, s0); s1 = fmaf(a1.w, w4.w, s1);
          acc[0][q] = s0;
          acc[1][q] = s1;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[r][q] += __shfl_xor_sync(0xffffffffu, acc[r][q], off);
    }

    // lane l < 8 finishes row 2 rp + l / 4, unit 4 uq + l % 4
    if (lane >= 8) continue;
    const int r = lane / 4;
    const int q = lane % 4;
    const int b = b0 + 2 * rp + r;
    if (b >= B) continue;
    float dh_carry = 0.0f;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int qq = 0; qq < 4; ++qq)
        if (rr == r && qq == q) dh_carry = acc[rr][qq];

    const int u = j0 + 4 * uq + q;
    const size_t go = ((size_t)t * D + d) * B * G + (size_t)b * G + u;
    const size_t ho = ((size_t)t * D + d) * B * H + (size_t)b * H + u;
    const float gi = to_f32(gates[go]);
    const float gf = to_f32(gates[go + H]);
    const float gg = to_f32(gates[go + 2 * H]);
    const float gout = to_f32(gates[go + 3 * H]);
    const float c_t = to_f32(cs[ho]);
    const float c_prev = t > 0 ? to_f32(cs[ho - (size_t)D * B * H]) : 0.0f;
    const size_t co = (size_t)b * H + u;

    const float dh = to_f32(dy[ho]) + dh_carry;
    const float tc = tanhf(c_t);
    const float da_o = dh * tc * gout * (1.0f - gout);
    const float dcv =
        dh * gout * (1.0f - tc * tc) + (step > 0 ? dc[co] : 0.0f);
    const float da_f = dcv * c_prev * gf * (1.0f - gf);
    const float da_i = dcv * gg * gi * (1.0f - gi);
    const float da_g = dcv * gi * (1.0f - gg * gg);
    store(dxw + go, da_i);
    store(dxw + go + H, da_f);
    store(dxw + go + 2 * H, da_g);
    store(dxw + go + 3 * H, da_o);
    float* dn = da_next + (size_t)b * G + u;
    dn[0] = da_i;
    dn[H] = da_f;
    dn[2 * H] = da_g;
    dn[3 * H] = da_o;
    dc[co] = dcv * gf;
  }
}

template <typename T>
int run_backward(const void* gates, const void* cs, const void* dy,
                 const void* w_hh_t, void* dxw, void* da_buf, void* dc_buf,
                 int T_, int D, int B, int H, cudaStream_t stream) {
  const size_t smem = bwd_smem_floats(H) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      bilstm_bwd_step<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H / kUnits, D);
  for (int step = 0; step < T_; ++step) {
    bilstm_bwd_step<T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(gates), static_cast<const T*>(cs),
        static_cast<const T*>(dy), static_cast<const T*>(w_hh_t),
        static_cast<T*>(dxw), static_cast<float*>(da_buf),
        static_cast<float*>(dc_buf), B, H, T_, step);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

bool bad_shape(int T, int D, int B, int H) {
  // K3's lanes stride the 4H contraction by 128: H a multiple of 32
  return T < 0 || D <= 0 || B <= 0 || H <= 0 || H % 32 != 0;
}

}  // namespace bilstm

extern "C" {

size_t bilstm_train_fwd_smem_bytes(int H) {
  return bilstm::fwd_smem_floats(H) * sizeof(float);
}

size_t bilstm_bwd_smem_bytes(int H) {
  return bilstm::bwd_smem_floats(H) * sizeof(float);
}

// Hidden sizes the pair takes are multiples of this.
int bilstm_train_hidden_multiple() { return 32; }

// K2 on `stream`. h_buf [2, D, B, H] and c_buf [D, B, H] are f32 scratch;
// neither needs initialising. Returns cudaGetLastError() of the launches.
int bilstm_train_fwd(const void* xw, const void* w_hh_t, void* ys,
                     void* gates, void* cs, void* h_buf, void* c_buf, int T,
                     int D, int B, int H, int is_bf16, void* stream) {
  if (bilstm::bad_shape(T, D, B, H)) return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return bilstm::run_forward<__nv_bfloat16>(
        xw, w_hh_t, ys, gates, cs, h_buf, c_buf, T, D, B, H, s);
  return bilstm::run_forward<float>(xw, w_hh_t, ys, gates, cs, h_buf, c_buf,
                                    T, D, B, H, s);
}

// K3 on `stream`. da_buf [2, D, B, 4H] and dc_buf [D, B, H] are f32
// scratch; neither needs initialising. Returns cudaGetLastError().
int bilstm_bwd(const void* gates, const void* cs, const void* dy,
               const void* w_hh_t, void* dxw, void* da_buf, void* dc_buf,
               int T, int D, int B, int H, int is_bf16, void* stream) {
  if (bilstm::bad_shape(T, D, B, H)) return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return bilstm::run_backward<__nv_bfloat16>(gates, cs, dy, w_hh_t, dxw,
                                               da_buf, dc_buf, T, D, B, H, s);
  return bilstm::run_backward<float>(gates, cs, dy, w_hh_t, dxw, da_buf,
                                     dc_buf, T, D, B, H, s);
}

const char* bilstm_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
