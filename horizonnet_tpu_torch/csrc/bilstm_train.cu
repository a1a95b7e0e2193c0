// Training pair of the bidirectional LSTM recurrence, written by hand for
// Hopper (sm_90a): the forward that keeps the residuals of the backward
// (K2) and the reverse-time backward (K3).
//
// K2 replaces horizonnet_tpu/ops/pallas_lstm.py::_bilstm_train_fwd_kernel
// (wrapped there by _train_fwd). It is the serving recurrence (K1) with the
// residuals of the backward stored as well:
//   xw     [T, D, B, 4H]  hoisted input projection + bias, f32 or bf16
//   w_hh_t [D, H, 4H]     recurrent weights, transposed; xw's type
//   ys     [T, D, B, H]   hidden states          } all three in xw's type,
//   gates  [T, D, B, 4H]  post-activation i,f,g,o } as the TPU kernel
//   cs     [T, D, B, H]   cell states            } stores them
//
// K3 replaces horizonnet_tpu/ops/pallas_lstm.py::_bilstm_bwd_kernel
// (wrapped by _train_bwd). Step s visits t = T-1-s:
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
// K3, 34 MFLOP per step and 8.6 GFLOP per call, far too little to fill the
// card in one step. What a step costs is latency: the exchange of h_t (K2)
// or da_t (K3) between the CTAs that share a direction, through L2, and
// the barrier that orders it.
//
// Design: both are one persistent cooperative launch per recurrence, with
// the time loop inside the kernel and this CTA's slice of W resident for
// all T steps; a grid the card cannot hold at once is refused and the
// wrapper raises. K2 is K1's kernel (bilstm_persistent.cuh) instantiated
// with the residual stores: grid (H / 8, D), W's slice in registers as
// mma.sync A fragments, h_{t-1} split exactly into three bf16 terms; at
// B = 8 the batch is one n8 tile. K3 below follows the same plan:
//   - A CTA owns kBwdUnits = 16 hidden units of one direction: grid
//     (H / 16, D), 64 CTAs at H = 512. Its rows w_hh_t[d, j0:j0+16, :]
//     (16 x 4H) are the A operand of dh_carry^T [16, B] = W[16, 4H] .
//     da_{t+1}^T [4H, B]. 16 units fill the m16 tile of mma.sync; with 8
//     units half of every product would multiply zero rows, each CTA would
//     still read all of da_{t+1}, and 128 CTAs would read twice the bytes
//     from L2 a step (8 MB instead of 4 at B = 8) and arrive twice as
//     often on each barrier. W costs H / 8 registers a thread (64 at
//     H = 512, 128 at the largest H, 1024).
//   - da_t goes through a double-buffered f32 array [2, D, B, 4H] in global
//     memory: every CTA writes its 4 x 16 columns and reads all 4H. After
//     writing, the CTA arrives on its direction's counter (release) and
//     waits for the direction's other CTAs (acquire): K1's barrier, with
//     K1's argument that one barrier a step suffices.
//   - bf16: the contraction (4H deep) is split over the 8 warps in 16-deep
//     slices. Each warp copies its slices of da_{t+1} (8 rows x 16 columns
//     each) from L2 into shared memory with cp.async.cg (past L1, which is
//     not coherent across SMs), in four commit groups, and multiplies each
//     group as it lands. f32 da splits exactly into three bf16 terms
//     (split3); W is bf16, so each partial product is exact and the three
//     sum in f32: the carry keeps the f32 contract of pallas_lstm.py:132.
//     The warps' partial sums meet in shared memory.
//   - f32: W's slice (16 x 4H f32, 128 KB at H = 512) stays in shared
//     memory; each step all threads copy da_{t+1}'s 8-row tile in, and each
//     warp computes 2 rows x 8 units with its lanes splitting the
//     contraction (float4), reduced by shuffles.
//   - The cell backward of (unit, row) pairs runs on the threads that own
//     them for the whole launch. Between its arrival and its wait, a CTA
//     loads the next step's gates, c_t, c_{t-1} and dy (they do not depend
//     on da); dc carries in f32 through this CTA's slice of dc_buf.
//   - Batches over 8 rows run in passes of 8 within a step.

#include "bilstm_persistent.cuh"

namespace bilstm {

constexpr int kBwdUnits = 16;   // hidden units per K3 CTA: the product's M
constexpr int kBwdRows = 8;     // batch rows per pass: the product's N
constexpr int kBwdMaxH = 1024;  // W fragments in registers: H / 8 a thread
constexpr int kDaPad = 8;       // floats of row padding of the bf16 da tile
constexpr int kBwdPart = 10;    // row stride of the partial sums
constexpr int kBwdGroups = 4;   // cp.async commit groups a step (bf16)

__host__ __device__ constexpr size_t bwd_smem_bf16(int H) {
  return ((size_t)kBwdRows * (4 * H + kDaPad) +
          (size_t)kWarps * kBwdUnits * kBwdPart) *
         sizeof(float);
}
__host__ __device__ constexpr size_t bwd_smem_f32(int H) {
  return (size_t)(kBwdUnits + kBwdRows) * (4 * H + kPad) * sizeof(float);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Waits until at most n (a constant once unrolled, < kBwdGroups) of this
// thread's commit groups are still in flight.
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  if (n <= 0) cp_async_wait<0>();
  else if (n == 1) cp_async_wait<1>();
  else if (n == 2) cp_async_wait<2>();
  else cp_async_wait<3>();
}

// The cell backward's inputs of one (unit, row) pair at one step.
struct BwdIn {
  float i, f, g, o, c, c_prev, dy;
};

template <typename T>
__device__ __forceinline__ BwdIn load_in(const T* gates, const T* cs,
                                         const T* dy, int t, int d, int D,
                                         int b, int B, int H, int j) {
  const size_t ho = (((size_t)t * D + d) * B + b) * H + j;
  const T* gp = gates + (((size_t)t * D + d) * B + b) * 4 * H + j;
  BwdIn v;
  v.i = to_f32(gp[0]);
  v.f = to_f32(gp[H]);
  v.g = to_f32(gp[2 * H]);
  v.o = to_f32(gp[3 * H]);
  v.c = to_f32(cs[ho]);
  v.c_prev = t > 0 ? to_f32(cs[ho - (size_t)D * B * H]) : 0.0f;
  v.dy = to_f32(dy[ho]);
  return v;
}

// Cell backward of (unit j, row b) at step s (t = T-1-s): dxw_t, this
// pair's columns of da_t for the next step, and the dc carry.
template <typename T>
__device__ __forceinline__ void bwd_cell(const BwdIn& v, float dh_carry,
                                         int s, int t, int d, int D, int b,
                                         int B, int H, int j, T* dxw,
                                         float* da_next, float* dc) {
  const float dh = v.dy + dh_carry;
  const float tc = tanhf(v.c);
  const float da_o = dh * tc * v.o * (1.0f - v.o);
  const size_t co = (size_t)b * H + j;
  const float dcv = dh * v.o * (1.0f - tc * tc) + (s > 0 ? dc[co] : 0.0f);
  const float da_f = dcv * v.c_prev * v.f * (1.0f - v.f);
  const float da_i = dcv * v.g * v.i * (1.0f - v.i);
  const float da_g = dcv * v.i * (1.0f - v.g * v.g);
  T* x = dxw + (((size_t)t * D + d) * B + b) * 4 * H + j;
  store(x, da_i);
  store(x + H, da_f);
  store(x + 2 * H, da_g);
  store(x + 3 * H, da_o);
  float* n = da_next + (size_t)b * 4 * H + j;
  n[0] = da_i;
  n[H] = da_f;
  n[2 * H] = da_g;
  n[3 * H] = da_o;
  dc[co] = dcv * v.f;
}

template <int KS>
__global__ void __launch_bounds__(kThreads, 1)
    backward_bf16(const __nv_bfloat16* __restrict__ gates,
                  const __nv_bfloat16* __restrict__ cs,
                  const __nv_bfloat16* __restrict__ dy,
                  const __nv_bfloat16* __restrict__ w_hh_t,
                  __nv_bfloat16* __restrict__ dxw, float* da_buf,
                  float* __restrict__ dc_buf, unsigned* flags, int T_, int B,
                  int H) {
  static_assert(KS % kBwdGroups == 0 || KS < kBwdGroups, "KS per group");
  constexpr int kGroups = KS < kBwdGroups ? KS : kBwdGroups;
  constexpr int kPer = KS / kGroups;  // K slices per commit group
  extern __shared__ float4 smem4[];
  const int G = 4 * H, stride = G + kDaPad;
  float* da_s = reinterpret_cast<float*>(smem4);    // [kBwdRows][stride]
  float* part = da_s + kBwdRows * stride;  // [warp][16][kBwdPart]
  const int D = gridDim.y, d = blockIdx.y, j0 = blockIdx.x * kBwdUnits;
  const int nk = G / 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;

  // W rows j0 .. j0+15 of w_hh_t[d] as resident A fragments; warp w owns
  // the 16-deep K slices w, w + 8, ...
  uint32_t a[KS][4];
  {
    const __nv_bfloat16* w = w_hh_t + ((size_t)d * H + j0) * G;
    auto pair = [&](int r, int k) {
      return *reinterpret_cast<const uint32_t*>(w + (size_t)r * G + k);
    };
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int kk = warp + kWarps * ks, k = kk * 16 + 2 * tq;
      if (kk < nk) {
        a[ks][0] = pair(g, k);
        a[ks][1] = pair(g + 8, k);
        a[ks][2] = pair(g, k + 8);
        a[ks][3] = pair(g + 8, k + 8);
      } else {
        a[ks][0] = a[ks][1] = a[ks][2] = a[ks][3] = 0u;
      }
    }
  }
  // rows of the da tile past the batch stay finite (their products are
  // discarded)
  for (int i = tid; i < kBwdRows * stride; i += kThreads) da_s[i] = 0.0f;

  const size_t plane = (size_t)D * B * G;
  float* dc = dc_buf + (size_t)d * B * H;
  // this thread's cell pair within a pass: unit p % 16, row p / 16
  const bool owner = tid < kBwdUnits * kBwdRows;
  const int u = tid % kBwdUnits, row = tid / kBwdUnits;
  BwdIn next{};
  for (int s = 0; s < T_; ++s) {
    const int t = T_ - 1 - s;
    const float* da_prev =
        da_buf + ((s + 1) & 1) * plane + (size_t)d * B * G;
    float* da_next = da_buf + (s & 1) * plane + (size_t)d * B * G;
    for (int b0 = 0; b0 < B; b0 += kBwdRows) {
      const int nb = min(kBwdRows, B - b0);
      // with one pass, step s's inputs were loaded before the last barrier
      if (owner && row < nb && (B > kBwdRows || s == 0))
        next = load_in(gates, cs, dy, t, d, D, b0 + row, B, H, j0 + u);
      const BwdIn in = next;
      float dh_carry = 0.0f;
      if (s > 0) {
        // this warp's slices of da_{t+1}: lane (row lane / 4, 16 bytes
        // lane % 4) of each, in kGroups commit groups
#pragma unroll
        for (int gi = 0; gi < kGroups; ++gi) {
#pragma unroll
          for (int q = 0; q < kPer; ++q) {
            const int kk = warp + kWarps * (gi * kPer + q);
            const int r = lane >> 2, col = kk * 16 + 4 * (lane & 3);
            if (kk < nk && r < nb)
              cp_async16(da_s + r * stride + col,
                         da_prev + (size_t)(b0 + r) * G + col);
          }
          cp_async_commit();
        }
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int gi = 0; gi < kGroups; ++gi) {
          cp_async_wait_pending(kGroups - 1 - gi);  // group gi has landed
          __syncwarp();
#pragma unroll
          for (int q = 0; q < kPer; ++q) {
            const int ks = gi * kPer + q, kk = warp + kWarps * ks;
            if (kk >= nk) continue;
            const float* bp = da_s + g * stride + kk * 16 + 2 * tq;
            uint32_t b_lo[3], b_hi[3];
            split3(*reinterpret_cast<const float2*>(bp), b_lo);
            split3(*reinterpret_cast<const float2*>(bp + 8), b_hi);
#pragma unroll
            for (int term = 2; term >= 0; --term)
              mma_bf16(acc, a[ks], b_lo[term], b_hi[term]);
          }
        }
        // acc: units g and g + 8, rows 2 tq and 2 tq + 1
        float* p = part + (warp * kBwdUnits + g) * kBwdPart + 2 * tq;
        *reinterpret_cast<float2*>(p) = make_float2(acc[0], acc[1]);
        *reinterpret_cast<float2*>(p + 8 * kBwdPart) =
            make_float2(acc[2], acc[3]);
        __syncthreads();
        if (owner) {
#pragma unroll
          for (int w = 0; w < kWarps; ++w)
            dh_carry += part[(w * kBwdUnits + u) * kBwdPart + row];
        }
      }
      if (owner && row < nb)
        bwd_cell(in, dh_carry, s, t, d, D, b0 + row, B, H, j0 + u, dxw,
                 da_next, dc);
      if (b0 + kBwdRows < B) __syncthreads();  // the next pass rewrites part
    }
    if (s + 1 < T_)
      direction_barrier(flags + d, s, [&] {
        if (owner && B <= kBwdRows && row < B)
          next = load_in(gates, cs, dy, t - 1, d, D, row, B, H, j0 + u);
      });
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    backward_f32(const float* __restrict__ gates, const float* __restrict__ cs,
                 const float* __restrict__ dy,
                 const float* __restrict__ w_hh_t, float* __restrict__ dxw,
                 float* da_buf, float* __restrict__ dc_buf, unsigned* flags,
                 int T_, int B, int H) {
  extern __shared__ float4 smem4[];
  const int G = 4 * H, stride = G + kPad;
  float* w_s = reinterpret_cast<float*>(smem4);  // [16][stride]
  float* da_s = w_s + kBwdUnits * stride;         // [kBwdRows][stride]
  const int D = gridDim.y, d = blockIdx.y, j0 = blockIdx.x * kBwdUnits;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // warp w: rows 2 (w / 2) and 2 (w / 2) + 1, units 8 (w % 2) .. + 7
  const int r0 = 2 * (warp >> 1), u0 = 8 * (warp & 1);
  const int g4 = G / 4;
  {
    const float* w = w_hh_t + ((size_t)d * H + j0) * G;
    for (int i = tid; i < kBwdUnits * g4; i += kThreads) {
      const int r = i / g4, k4 = i % g4;
      reinterpret_cast<float4*>(w_s + r * stride)[k4] =
          reinterpret_cast<const float4*>(w + (size_t)r * G)[k4];
    }
    for (int i = tid; i < kBwdRows * stride; i += kThreads) da_s[i] = 0.0f;
  }
  const size_t plane = (size_t)D * B * G;
  float* dc = dc_buf + (size_t)d * B * H;
  // lanes 0-15 own the cell pair (row r0 + lane / 8, unit u0 + lane % 8)
  const bool owner = lane < 16;
  const int u = u0 + (lane & 7), row = r0 + ((lane >> 3) & 1);
  BwdIn next{};
  for (int s = 0; s < T_; ++s) {
    const int t = T_ - 1 - s;
    const float* da_prev =
        da_buf + ((s + 1) & 1) * plane + (size_t)d * B * G;
    float* da_next = da_buf + (s & 1) * plane + (size_t)d * B * G;
    for (int b0 = 0; b0 < B; b0 += kBwdRows) {
      const int nb = min(kBwdRows, B - b0);
      if (owner && row < nb && (B > kBwdRows || s == 0))
        next = load_in(gates, cs, dy, t, d, D, b0 + row, B, H, j0 + u);
      const BwdIn in = next;
      float dh_carry = 0.0f;
      if (s > 0) {
        __syncthreads();  // the previous pass is done with da_s
        for (int i = tid; i < nb * g4; i += kThreads) {
          const int r = i / g4, k4 = i % g4;
          cp_async16(da_s + r * stride + 4 * k4,
                     da_prev + (size_t)(b0 + r) * G + 4 * k4);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        float acc[2][8] = {};
        const float* a0p = da_s + r0 * stride;
        for (int k = 4 * lane; k < G; k += 128) {
          const float4 a0 = *reinterpret_cast<const float4*>(a0p + k);
          const float4 a1 =
              *reinterpret_cast<const float4*>(a0p + stride + k);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const float4 w4 =
                *reinterpret_cast<const float4*>(w_s + (u0 + q) * stride + k);
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
            for (int q = 0; q < 8; ++q)
              acc[r][q] += __shfl_xor_sync(0xffffffffu, acc[r][q], off);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (r == ((lane >> 3) & 1) && q == (lane & 7))
              dh_carry = acc[r][q];
      }
      if (owner && row < nb)
        bwd_cell(in, dh_carry, s, t, d, D, b0 + row, B, H, j0 + u, dxw,
                 da_next, dc);
    }
    if (s + 1 < T_)
      direction_barrier(flags + d, s, [&] {
        if (owner && B <= kBwdRows && row < B)
          next = load_in(gates, cs, dy, t - 1, d, D, row, B, H, j0 + u);
      });
  }
}

// The opt-in dynamic shared memory a CTA of the current device may use
// (0 if the query fails).
size_t device_smem_limit() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return (size_t)v;
}

// The largest multiple of 16 up to `reg_max` whose shared memory fits a CTA
// of the current device.
template <typename Smem>
int max_h(int reg_max, Smem smem) {
  const size_t limit = device_smem_limit();
  for (int H = reg_max; H >= 16; H -= 16)
    if (smem(H) <= limit) return H;
  return 0;
}

int fwd_max_h(int is_bf16) {
  if (is_bf16) return max_h(kMaxH, [](int) { return smem_bf16(); });
  return max_h(kMaxH, smem_f32);
}

int bwd_max_h(int is_bf16) {
  return is_bf16 ? max_h(kBwdMaxH, bwd_smem_bf16)
                 : max_h(kBwdMaxH, bwd_smem_f32);
}

bool bad_shape(int T, int D, int B, int H, int h_max) {
  return T < 0 || D <= 0 || B <= 0 || H <= 0 || H % 16 != 0 || H > h_max;
}

}  // namespace bilstm

extern "C" {

// Hidden sizes the pair takes are multiples of this (the 16-deep K slice of
// the bf16 products) ...
int bilstm_train_h_multiple() { return 16; }
// ... and at most these on the current device (bf16: W's fragments in
// registers; f32: W's slice in shared memory).
int bilstm_train_fwd_max_h(int is_bf16) { return bilstm::fwd_max_h(is_bf16); }
int bilstm_bwd_max_h(int is_bf16) { return bilstm::bwd_max_h(is_bf16); }

// K2 on `stream`: one cooperative launch of (H / 8, D) CTAs, which must all
// be resident at once. h_buf [2, D, B, H] and c_buf [D, B, H] are f32
// scratch (neither needs initialising); flags is [D] u32 scratch, zeroed
// here. Returns the CUDA error of the launch (0 on success).
int bilstm_train_fwd(const void* xw, const void* w_hh_t, void* ys,
                     void* gates, void* cs, void* h_buf, void* c_buf,
                     void* flags, int T, int D, int B, int H, int is_bf16,
                     void* stream) {
  if (bilstm::bad_shape(T, D, B, H, bilstm::fwd_max_h(is_bf16)))
    return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(flags, 0, D * sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&xw, &w_hh_t, &ys, &h_buf, &c_buf, &flags,
                  &T,  &B,      &H,  &gates, &cs};
  const int gx = H / bilstm::kUnits;
  auto go = [&](auto kernel, size_t smem) {
    return bilstm::launch(kernel, smem, args, gx, D, s);
  };
  if (!is_bf16)
    return go(bilstm::recurrence_f32<true>, bilstm::smem_f32(H));
  const size_t smem = bilstm::smem_bf16();
  const int ks = (H / 16 + bilstm::kWarps - 1) / bilstm::kWarps;
  if (ks <= 1) return go(bilstm::recurrence_bf16<1, true>, smem);
  if (ks <= 2) return go(bilstm::recurrence_bf16<2, true>, smem);
  if (ks <= 4) return go(bilstm::recurrence_bf16<4, true>, smem);
  return go(bilstm::recurrence_bf16<8, true>, smem);
}

// K3 on `stream`: one cooperative launch of (H / 16, D) CTAs, which must
// all be resident at once. da_buf [2, D, B, 4H] and dc_buf [D, B, H] are
// f32 scratch (neither needs initialising); flags is [D] u32 scratch,
// zeroed here. Returns the CUDA error of the launch (0 on success).
int bilstm_bwd(const void* gates, const void* cs, const void* dy,
               const void* w_hh_t, void* dxw, void* da_buf, void* dc_buf,
               void* flags, int T, int D, int B, int H, int is_bf16,
               void* stream) {
  if (bilstm::bad_shape(T, D, B, H, bilstm::bwd_max_h(is_bf16)))
    return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(flags, 0, D * sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&gates, &cs, &dy, &w_hh_t, &dxw, &da_buf,
                  &dc_buf, &flags, &T, &B, &H};
  const int gx = H / bilstm::kBwdUnits;
  auto go = [&](auto kernel, size_t smem) {
    return bilstm::launch(kernel, smem, args, gx, D, s);
  };
  if (!is_bf16) return go(bilstm::backward_f32, bilstm::bwd_smem_f32(H));
  const size_t smem = bilstm::bwd_smem_bf16(H);
  const int ks = (H / 4 + bilstm::kWarps - 1) / bilstm::kWarps;  // a warp's
  if (ks <= 1) return go(bilstm::backward_bf16<1>, smem);        // K slices
  if (ks <= 2) return go(bilstm::backward_bf16<2>, smem);
  if (ks <= 4) return go(bilstm::backward_bf16<4>, smem);
  if (ks <= 8) return go(bilstm::backward_bf16<8>, smem);
  if (ks <= 16) return go(bilstm::backward_bf16<16>, smem);
  return go(bilstm::backward_bf16<32>, smem);
}

const char* bilstm_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
