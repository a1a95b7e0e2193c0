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
//
// The step itself lives in bilstm_fwd_step.cuh, shared with the training
// forward K2 (bilstm_train.cu); this file instantiates it without the
// residual stores.

#include "bilstm_fwd_step.cuh"

extern "C" {

// Bytes of dynamic shared memory one CTA needs at hidden size H.
size_t bilstm_fwd_smem_bytes(int H) {
  return bilstm::fwd_smem_floats(H) * sizeof(float);
}

int bilstm_fwd_units_per_cta() { return bilstm::kUnits; }

// Runs the whole recurrence on `stream`. h_buf is [2, D, B, H] f32 and
// c_buf [D, B, H] f32 scratch; neither needs initialising. Returns
// cudaGetLastError() of the launches (0 on success).
int bilstm_fwd(const void* xw, const void* w_hh_t, void* ys, void* h_buf,
               void* c_buf, int T, int D, int B, int H, int is_bf16,
               void* stream) {
  if (T < 0 || D <= 0 || B <= 0 || H <= 0 || H % bilstm::kUnits != 0 ||
      H % (4 * bilstm::kSplit) != 0)
    return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return bilstm::run_forward<__nv_bfloat16, false>(
        xw, w_hh_t, ys, nullptr, nullptr, h_buf, c_buf, T, D, B, H, s);
  return bilstm::run_forward<float, false>(xw, w_hh_t, ys, nullptr, nullptr,
                                           h_buf, c_buf, T, D, B, H, s);
}

const char* bilstm_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
