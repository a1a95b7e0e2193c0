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
// batch across steps, so the latency of a step is what counts: the exchange
// of h_{t-1} between the CTAs that own its units, and the products.
//
// Design: one persistent cooperative launch per recurrence. The grid is
// (H / kUnits, D) CTAs (128 at H=512), one per SM, all co-resident; a
// launch the card cannot hold at once is refused (the wrapper raises). The
// time loop runs inside the kernel. Each CTA owns kUnits hidden units of
// one direction with all four of their gate columns, so the cell update
// needs no exchange; its slice of W_hh (32 gate columns x H) is loaded once
// and stays resident for all T steps. h_{t-1} goes through a
// double-buffered f32 array in global memory, read past L1 (ld.global.cg:
// L1 is not coherent across SMs); after writing h_t each CTA arrives on its
// direction's counter with release semantics and waits for the direction's
// other CTAs with an acquire load, so the two directions never wait on
// each other. One barrier per step suffices: a CTA overwrites the buffer it
// read one step earlier only after every CTA of its direction has passed
// the barrier that follows those reads. Between its arrival and its wait a
// CTA loads the next step's gate inputs (they do not depend on h). Within
// a step each warp issues the h loads of its next K slice before the
// products of the current one. (Distributed shared memory within a
// cluster was the alternative; a cluster holds at most 16 CTAs, so one
// direction's 64 CTAs at H=512 could not share one.)
//
// bf16: the products run on the tensor cores (mma.sync m16n8k16) without
// giving up the f32 contract. Computed as W^T h^T, the 32 gate columns are
// the M dimension: W's fragments stay in registers (4 x H/128 per thread).
// f32 h splits exactly into three bf16 terms, hi = bf16(h),
// mid = bf16(h - hi), lo = bf16(h - hi - mid) (3 x 8 significand bits cover
// f32's 24), W is bf16 already, so each partial product is exact and the
// three products sum in f32. The 8 warps split K (16-deep slices
// round-robin) and hand their partial sums through shared memory to the
// cell update. f32: W's slice is widened once into shared memory, h_{t-1}
// is staged per 64-row batch tile, and the products run as CUDA-core FMAs
// (split-K over two halves of the CTA).

// The kernels themselves (recurrence_bf16<KS, false>, recurrence_f32<false>)
// live in bilstm_persistent.cuh, which the training forward (K2,
// bilstm_train.cu) instantiates with the residual stores.

#include "bilstm_persistent.cuh"

extern "C" {

// Bytes of dynamic shared memory one CTA needs at hidden size H.
size_t bilstm_fwd_smem_bytes(int H, int is_bf16) {
  return is_bf16 ? bilstm::smem_bf16() : bilstm::smem_f32(H);
}

// H must be a multiple of this (16: the bf16 products' K slice) ...
int bilstm_fwd_h_multiple() { return 16; }
// ... and at most this (W's fragments live in registers).
int bilstm_fwd_max_h() { return bilstm::kMaxH; }

// Runs the whole recurrence on `stream` as one cooperative launch of
// (H / 8, D) CTAs, which must all be resident on the card at once. h_buf
// is [2, D, B, H] f32 and c_buf [D, B, H] f32 scratch (neither needs
// initialising); flags is [D] u32 scratch, zeroed here. Returns the CUDA
// error of the launch (0 on success).
int bilstm_fwd(const void* xw, const void* w_hh_t, void* ys, void* h_buf,
               void* c_buf, void* flags, int T, int D, int B, int H,
               int is_bf16, void* stream) {
  if (T < 0 || D <= 0 || B <= 0 || H <= 0 || H % 16 != 0 ||
      H > bilstm::kMaxH)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(flags, 0, D * sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  void* none = nullptr;  // no residuals
  void* args[] = {&xw,  &w_hh_t, &ys, &h_buf, &c_buf, &flags,
                  &T,   &B,      &H,  &none,  &none};
  auto go = [&](auto kernel, size_t smem) {
    return bilstm::launch(kernel, smem, args, H / bilstm::kUnits, D, s);
  };
  if (!is_bf16)
    return go(bilstm::recurrence_f32<false>, bilstm::smem_f32(H));
  const size_t smem = bilstm::smem_bf16();
  const int ks = (H / 16 + bilstm::kWarps - 1) / bilstm::kWarps;  // K slices
  if (ks <= 1) return go(bilstm::recurrence_bf16<1, false>, smem);  // a warp
  if (ks <= 2) return go(bilstm::recurrence_bf16<2, false>, smem);
  if (ks <= 4) return go(bilstm::recurrence_bf16<4, false>, smem);
  return go(bilstm::recurrence_bf16<8, false>, smem);
}

const char* bilstm_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
