// Serving forward of the bidirectional LSTM recurrence, written by hand for
// Hopper (sm_90a).
//
// Replaces horizonnet_tpu/ops/pallas_lstm.py::_bilstm_kernel (wrapped there
// by bilstm_recurrence_pallas). Same contract:
//   xw     [T, D, B, 4H]  hoisted input projection + bias, direction 1
//                         already time-reversed; f32 or bf16
//   w_hh_t [D, H, 4H]     recurrent weights, transposed; same dtype as xw
//   ys     [T, D, B, H]   per-step hidden states, in xw's dtype
// Gate order i, f, g, o, zero initial state. h and c are carried in f32 and
// W is converted to f32 before it multiplies h (pallas_lstm.py:42-44).
//
// What bounds it on the H100: a serial chain of T=256 steps per layer, each
// a small [B, H] x [H, 4H] product per direction (B=64, H=512 when
// serving) followed by the cell update. The product is ~134 MFLOP per step
// and direction, too little to fill the card for one step and impossible to
// batch across steps, so latency per step (launch, the reload of h_{t-1}
// from L2, the dot products on CUDA cores in f32) is what counts.
//
// Design: the TPU kernel keeps all of W_hh (2 x 512 x 2048 bf16, 4 MiB)
// resident in VMEM; one SM's 227 KB of shared memory cannot, so W_hh is cut
// across CTAs. Each CTA owns kUnits hidden units of one direction with all
// four of their gate columns, so the cell update needs no exchange between
// CTAs: grid (H / kUnits, D) = 128 CTAs at H=512. Per step the CTA stages
// its W_hh slice (widened to f32, 16-byte loads) and a 64-row tile of
// h_{t-1} (f32) in shared memory. Its 8 warps form two groups that each
// take half of the K range; a thread accumulates 4 batch rows x 4 gates of
// one unit with float4 reads (rows padded by 4 floats, so the 8 units of a
// quarter-warp hit distinct banks), and the upper group hands its partial
// sums to the lower one through shared memory, which runs the cell update.
// h_{t-1} lives in a double-buffered f32 scratch array in global memory,
// because every CTA reads all H units of it; c stays in a per-CTA slice of
// a second scratch array. The time loop is one launch per step from the C
// entry point, which orders the steps on the stream. Keeping W resident
// across steps (a persistent or cluster kernel with h_{t-1} exchanged
// through distributed shared memory) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

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

// Dynamic shared memory: W slice, h tile, and the split-K partial sums.
__host__ __device__ constexpr size_t smem_floats(int H) {
  return (size_t)(4 * kUnits + kBatchTile) * (H + kPad)
         + (size_t)kBatchTile * 4 * kUnits;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bilstm_step(const T* __restrict__ xw, const T* __restrict__ w_hh_t,
                T* __restrict__ ys, float* __restrict__ h_buf,
                float* __restrict__ c_buf, int B, int H, int t) {
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
      const T* x = xw + ((size_t)t * D + d) * B * G + (size_t)b * G + j0 + j;
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
      store(ys + ((size_t)t * D + d) * B * H + o, hn);
    }
  }
}

template <typename T>
int run(const void* xw, const void* w_hh_t, void* ys, void* h_buf,
        void* c_buf, int T_, int D, int B, int H, cudaStream_t stream) {
  const size_t smem = smem_floats(H) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      bilstm_step<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H / kUnits, D);
  for (int t = 0; t < T_; ++t) {
    bilstm_step<T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(xw), static_cast<const T*>(w_hh_t),
        static_cast<T*>(ys), static_cast<float*>(h_buf),
        static_cast<float*>(c_buf), B, H, t);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs at hidden size H.
size_t bilstm_fwd_smem_bytes(int H) { return smem_floats(H) * sizeof(float); }

int bilstm_fwd_units_per_cta() { return kUnits; }

// Runs the whole recurrence on `stream`. h_buf is [2, D, B, H] f32 and
// c_buf [D, B, H] f32 scratch; neither needs initialising. Returns
// cudaGetLastError() of the launches (0 on success).
int bilstm_fwd(const void* xw, const void* w_hh_t, void* ys, void* h_buf,
               void* c_buf, int T, int D, int B, int H, int is_bf16,
               void* stream) {
  if (T < 0 || D <= 0 || B <= 0 || H <= 0 || H % kUnits != 0 ||
      H % (4 * kSplit) != 0)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return run<__nv_bfloat16>(xw, w_hh_t, ys, h_buf, c_buf, T, D, B, H, s);
  return run<float>(xw, w_hh_t, ys, h_buf, c_buf, T, D, B, H, s);
}

const char* bilstm_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
