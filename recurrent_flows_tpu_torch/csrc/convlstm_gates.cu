// The peephole ConvLSTM update (Hopper, sm_90a).
//
// Replaces the TPU kernel recurrent_flows_tpu/ops/pallas/fused.py
// (_gates_pallas / _gates_kernel): from the fused gate conv's output
// gates [B, H, W, 4*hc] in the order (i, f, o, g), the cell c [B, H, W, hc]
// and the peepholes w_ci, w_cf, w_co [1, H, W, hc] (broadcast over B),
//   i = sigmoid(cc_i + w_ci*c), f = sigmoid(cc_f + w_cf*c), g = tanh(cc_g),
//   c' = f*c + i*g, o = sigmoid(cc_o + w_co*c'), h' = o*tanh(c').
// Computes what convlstm_gates_ref (recurrent_flows_tpu_torch/ops/fused.py)
// computes.
//
// What bounds it on the H100: the launch, and then the length of one
// thread's instruction stream. One pass with no reduction: 5*hc floats in
// and 2*hc out per position, 189 KB at B = 8 and 682 KB at B = 30 for the
// gates [B, 2, 2, 800] of rfn_mnist_production, 0.06-0.2 microseconds at
// the card's memory rate. So a launch costs its fixed latency, one trip to
// L2, and the time one warp takes to run its straight-line code once: that
// time grows with the states each thread computes, not with the number of
// threads. Clocks read inside a launch (NVIDIA H100 80GB HBM3, 700 W;
// scripts/torch_gates_variants.py, PERF.md): ~460-600 from a block's start
// to its loads' return, then ~680 to its last store with one state per
// thread, ~1,100 with 4 (16-byte loads), ~3,050 with 4 and IEEE division.
//
// Design:
//  * One state per thread. Block (p, j, b) takes position p of sample b and
//    the channels [j*threads, (j+1)*threads); at hc = 200 one block of 224
//    threads covers a position, a grid of H*W*B blocks (32 at B = 8, 120 at
//    B = 30) spreads over as many SMs. 4 states per thread by 16-byte loads,
//    2 by 8-byte loads, and 2 samples per thread sharing the peepholes in
//    registers each measured slower or no faster; a warp's 4-byte loads
//    still cover 128 contiguous bytes.
//  * No division in the index math: every offset is a product and a sum of
//    the block and thread indices, in 32 bits (ops/fused.py raises where
//    gates has 2^31 elements or more).
//  * All eight loads issued before any arithmetic, through the read-only
//    path; the peepholes are read once per sample, from L1/L2.
//  * Accurate exponentials in the overflow-free forms: expf (not __expf),
//    sigmoid(v) = 1 / (1 + e^-v), tanh(v) = sign(v) (1 - e^-2|v|) /
//    (1 + e^-2|v|), each quotient by __fdividef (within 2 ulp: the
//    denominators lie in [1, 2] for tanh; for sigmoid a denominator above
//    2^126 gives 0, the value to within 2^-126). IEEE division made the
//    kernel 0.2 microseconds slower. Every output depends only on its own
//    inputs, so two launches agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr unsigned kMaxGrid = 65535;  // the largest grid along y and z

__device__ __forceinline__ float sigmoid(float v) { return __fdividef(1.f, 1.f + expf(-v)); }

__device__ __forceinline__ float tanh_free(float v) {
  const float e = expf(-2.f * fabsf(v));
  const float t = __fdividef(1.f - e, 1.f + e);
  return v >= 0.f ? t : -t;
}

// grid = (hw, ceil(hc / threads), B); see the note above.
__global__ void __launch_bounds__(kMaxThreads)
gates_kernel(const float* __restrict__ gates, const float* __restrict__ c,
             const float* __restrict__ w_ci, const float* __restrict__ w_cf,
             const float* __restrict__ w_co, float* __restrict__ h_out,
             float* __restrict__ c_out, int hw, int hc) {
  const int ch = blockIdx.y * blockDim.x + threadIdx.x;
  if (ch >= hc) return;
  const int p = blockIdx.x;
  const int pos = blockIdx.z * hw + p;
  const float* g = gates + pos * 4 * hc + ch;
  const float wi = __ldg(w_ci + p * hc + ch), wf = __ldg(w_cf + p * hc + ch),
              wo = __ldg(w_co + p * hc + ch);
  const float gi = __ldg(g), gf = __ldg(g + hc), go = __ldg(g + 2 * hc),
              gg = __ldg(g + 3 * hc), cv = __ldg(c + pos * hc + ch);
  const float i = sigmoid(gi + wi * cv);
  const float f = sigmoid(gf + wf * cv);
  const float cn = f * cv + i * tanh_free(gg);
  const float o = sigmoid(go + wo * cn);
  h_out[pos * hc + ch] = o * tanh_free(cn);
  c_out[pos * hc + ch] = cn;
}

}  // namespace

extern "C" {

const char* convlstm_gates_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// h' and c' [B, hw, hc] (contiguous) of the peephole ConvLSTM update on
// `stream`, from gates [B, hw, 4*hc], c [B, hw, hc] and the peepholes
// [hw, hc], with `threads` per block (a multiple of 32, from
// ops/fused.py::gates_plan). Returns the cudaError_t of the launch (0 on
// success).
int convlstm_gates_launch(const float* gates, const float* c, const float* w_ci,
                          const float* w_cf, const float* w_co, float* h,
                          float* cn, int B, int hw, int hc, int threads,
                          void* stream) {
  if (B < 1 || hw < 1 || hc < 1 || threads < 32 || threads > kMaxThreads || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(hw, (hc + threads - 1) / threads, B);
  if (grid.y > kMaxGrid || grid.z > kMaxGrid) return static_cast<int>(cudaErrorInvalidValue);
  gates_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      gates, c, w_ci, w_cf, w_co, h, cn, hw, hc);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
