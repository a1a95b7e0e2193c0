// K5: the circular width pad of the encoder's convs and its gradient,
// written by hand for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package pads with jnp.concatenate
// (horizonnet_tpu/ops/pad.py::wrap_pad_width), which XLA fuses into the
// conv's input. In PyTorch the same concatenation of two narrowed views
// took CUDA's generic strided copy, and its autograd made a zero-filled
// full-size gradient for each narrow and summed three gradients into the
// input, two of those adds with an undense operand: about 20 GB a train
// step of resnet50 at batch 24 where a pad needs 8.
//
// Both kernels view a dense 4-D tensor as rows [R, W, E]: R = B*H and
// E = C for channels_last, R = B*C*H and E = 1 for NCHW. The wrapper
// (ops/pad.py) picks the unit U, the widest of 16, 8, 4 and 2 bytes that
// divides a column (E x the element size) and both base pointers, so every
// access is a U-byte load or store (16-byte vectors on every channels_last
// activation of the encoder; 2 bytes for the stem's 3-channel bf16 image).
//
//   wrap_pad_fwd:  out[r, j] = x[r, (j - p) mod W],  j < W + 2p
//   wrap_fold_bwd: dx[r, i] = (dpad[r, i + p] + L) + R, where
//                  L = dpad[r, i - W + p] for i >= W - p, else +0,
//                  R = dpad[r, W + p + i] for i < p, else +0,
//                  summed in float32 and rounded once.
//
// Both take any 0 < p <= W, so the pad wraps at most once (the deepest maps
// of a 512x32 input are 2 and 1 wide under a pad of 1). With W >= 2p no
// column has both edge terms, so the fold is autograd's sum of the three
// gradients bit for bit: one rounding either way, and an added +0 is exact
// (it turns -0 into +0, as autograd's adds of the zero-filled gradients
// do). With W < 2p a column may take all three, summed in float32 in the
// order above and rounded once (ops/pad.py's twin sums them so). What
// bounds both on the H100 is bytes: one read of the input and one write of
// the output, at 3.35 TB/s.
//
// Grid: blockIdx.y strides over rows (looping past the grid's 65535),
// blockIdx.x * blockDim.x + threadIdx.x over a row's units, so no thread
// divides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace wrap_pad {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

template <int U> struct Unit;
template <> struct Unit<16> { using T = uint4; };
template <> struct Unit<8> { using T = uint2; };
template <> struct Unit<4> { using T = unsigned int; };
template <> struct Unit<2> { using T = unsigned short; };

// n_in units a row in; n_p units of p columns; rows of n_in + 2 n_p out
template <int U>
__global__ void __launch_bounds__(kThreads)
    pad_fwd(const typename Unit<U>::T* __restrict__ x,
            typename Unit<U>::T* __restrict__ out, long long R, int n_in,
            int n_p) {
  const int n_out = n_in + 2 * n_p;
  for (long long r = blockIdx.y; r < R; r += gridDim.y) {
    const typename Unit<U>::T* src = x + r * n_in;
    typename Unit<U>::T* dst = out + r * n_out;
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k < n_out) {
      int s = k - n_p;                  // the middle run
      if (s < 0) s += n_in;             // the left pad: the right columns
      else if (s >= n_in) s -= n_in;    // the right pad: the left columns
      dst[k] = src[s];
    }
  }
}

// an element's bits and its value in float32
template <typename E> struct Elt;
template <> struct Elt<float> {
  using Raw = unsigned int;
  static __device__ __forceinline__ float get(Raw b) {
    return __uint_as_float(b);
  }
  static __device__ __forceinline__ Raw put(float v) {
    return __float_as_uint(v);
  }
};
template <> struct Elt<__nv_bfloat16> {
  using Raw = unsigned short;
  static __device__ __forceinline__ float get(Raw b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
  static __device__ __forceinline__ Raw put(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

template <typename E, int U>
union Pack {
  typename Unit<U>::T v;
  typename Elt<E>::Raw e[U / sizeof(E)];
};

// n_x units a row of dx; n_p units of p columns; dpad rows of n_x + 2 n_p
template <typename E, int U>
__global__ void __launch_bounds__(kThreads)
    fold_bwd(const typename Unit<U>::T* __restrict__ dpad,
             typename Unit<U>::T* __restrict__ dx, long long R, int n_x,
             int n_p) {
  constexpr int N = U / sizeof(E);
  const int n_pad = n_x + 2 * n_p;
  for (long long r = blockIdx.y; r < R; r += gridDim.y) {
    const typename Unit<U>::T* src = dpad + r * n_pad;
    typename Unit<U>::T* dst = dx + r * n_x;
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k < n_x) {
      Pack<E, U> m, l, rt, o;
      l.v = typename Unit<U>::T{};      // +0 where no edge term lands
      rt.v = typename Unit<U>::T{};
      m.v = src[k + n_p];
      if (k >= n_x - n_p) l.v = src[k - (n_x - n_p)];
      if (k < n_p) rt.v = src[k + n_x + n_p];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float acc = Elt<E>::get(m.e[j]) + Elt<E>::get(l.e[j]);
        acc = acc + Elt<E>::get(rt.e[j]);
        o.e[j] = Elt<E>::put(acc);
      }
      dst[k] = o.v;
    }
  }
}

inline dim3 grid_for(long long R, int n) {
  const int gy = R < kMaxGridY ? static_cast<int>(R) : kMaxGridY;
  return dim3((n + kThreads - 1) / kThreads, gy);
}

template <int U>
cudaError_t launch_fwd(const void* x, void* out, long long R, int n_in,
                       int n_p, cudaStream_t s) {
  using T = typename Unit<U>::T;
  pad_fwd<U><<<grid_for(R, n_in + 2 * n_p), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), R, n_in, n_p);
  return cudaGetLastError();
}

template <typename E, int U>
cudaError_t launch_bwd(const void* dpad, void* dx, long long R, int n_x,
                       int n_p, cudaStream_t s) {
  using T = typename Unit<U>::T;
  fold_bwd<E, U><<<grid_for(R, n_x), kThreads, 0, s>>>(
      static_cast<const T*>(dpad), static_cast<T*>(dx), R, n_x, n_p);
  return cudaGetLastError();
}

// a row of W columns of col_bytes bytes, and p columns, in units of U
// bytes; false where the shape is refused
inline bool units(int W, int p, int col_bytes, int U, int* n_w, int* n_p) {
  if (p <= 0 || p > W || col_bytes <= 0 || col_bytes % U) return false;
  const long long w = static_cast<long long>(W) * col_bytes / U;
  if (w + 2LL * p * col_bytes / U >= (1LL << 31)) return false;
  *n_w = static_cast<int>(w);
  *n_p = static_cast<int>(static_cast<long long>(p) * col_bytes / U);
  return true;
}

}  // namespace wrap_pad

extern "C" {

// out [R, W + 2p, E] <- x [R, W, E], both dense, E x elt_bytes bytes a
// column; unit_bytes (16, 8, 4 or 2) must divide a column and both
// pointers. Runs on `stream`; returns the CUDA error of the launch.
int wrap_pad_fwd(const void* x, void* out, long long R, int W, int p, int E,
                 int elt_bytes, int unit_bytes, void* stream) {
  int n_w, n_p;
  if (R < 0 || E <= 0 ||
      !wrap_pad::units(W, p, E * elt_bytes, unit_bytes, &n_w, &n_p))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit_bytes) {
    case 16: return (int)wrap_pad::launch_fwd<16>(x, out, R, n_w, n_p, s);
    case 8: return (int)wrap_pad::launch_fwd<8>(x, out, R, n_w, n_p, s);
    case 4: return (int)wrap_pad::launch_fwd<4>(x, out, R, n_w, n_p, s);
    case 2: return (int)wrap_pad::launch_fwd<2>(x, out, R, n_w, n_p, s);
  }
  return (int)cudaErrorInvalidValue;
}

// dx [R, W, E] <- the fold of dpad [R, W + 2p, E], both dense, bf16
// (is_bf16) or float32; unit_bytes as for wrap_pad_fwd, at least the
// element's size.
int wrap_fold_bwd(const void* dpad, void* dx, long long R, int W, int p,
                  int E, int is_bf16, int unit_bytes, void* stream) {
  const int elt = is_bf16 ? 2 : 4;
  int n_w, n_p;
  if (R < 0 || E <= 0 || unit_bytes < elt ||
      !wrap_pad::units(W, p, E * elt, unit_bytes, &n_w, &n_p))
    return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using wrap_pad::launch_bwd;
  if (is_bf16) {
    switch (unit_bytes) {
      case 16: return (int)launch_bwd<__nv_bfloat16, 16>(dpad, dx, R, n_w, n_p, s);
      case 8: return (int)launch_bwd<__nv_bfloat16, 8>(dpad, dx, R, n_w, n_p, s);
      case 4: return (int)launch_bwd<__nv_bfloat16, 4>(dpad, dx, R, n_w, n_p, s);
      case 2: return (int)launch_bwd<__nv_bfloat16, 2>(dpad, dx, R, n_w, n_p, s);
    }
  } else {
    switch (unit_bytes) {
      case 16: return (int)launch_bwd<float, 16>(dpad, dx, R, n_w, n_p, s);
      case 8: return (int)launch_bwd<float, 8>(dpad, dx, R, n_w, n_p, s);
      case 4: return (int)launch_bwd<float, 4>(dpad, dx, R, n_w, n_p, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

const char* wrap_pad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
