// K GlowSteps of one flow scale in one launch (Hopper, sm_90a).
//
// Replaces the TPU kernel recurrent_flows_tpu/ops/pallas/glowchain.py
// (_glowchain_pallas / _kernel): the whole K-step chain of a small-spatial
// scale with x kept on chip between the steps. Computes what glowchain_ref
// (recurrent_flows_tpu_torch/ops/glowchain.py) computes, forward and
// reverse, with all four clamps: (y, sum over steps of the coupling logdet).
//
// What bounds it on the H100: latency, not FLOPs or bytes. A scale's K = 10
// steps hold 6.7-35 MB of weights and 0.3-1.3 GFLOP per sample, on maps of
// 2x2 to 16x16 for a batch of 8 to 30: too few rows per sample to fill a
// block, too few samples to fill 132 SMs with a block each, and between the
// phases of every step a barrier. On 16x16 maps the FMA loops reach about a
// third of the FFMA peak; on 2x2 and 4x4 maps a step is mostly barriers and
// the block's 120-440 KB of weights coming from L2.
//
// Design: a cluster of 8 blocks takes a batch tile of whole samples and
// loops over the K steps with x, the coupling input, the hidden maps and the
// partial sums in (distributed) shared memory; the first hidden map of a
// tile of 64 rows or more goes to the peers through L2, which is faster
// there. The weights of all K steps stream through one cp.async ring, step
// k+1's arriving during step k's tail. Every product runs on 4x4 register
// tiles fed by 16-byte loads, with the reduction split over the threads that
// would idle; every sum is added in a fixed order, so results repeat.
//
// The device code is glowstep_body.cuh, shared with the whole-GlowStep
// kernel (glowstep.cu); its header note has the design in full. The launch
// geometry comes from ops/glowstep.py::launch_plan as glowchain_plan_ints()
// ints.

#include "glowstep_body.cuh"

namespace {

template <int IM>
__global__ void __launch_bounds__(kThreads)
glowchain_kernel(const float* __restrict__ x, const float* __restrict__ cond,
                 StepParams P, float* __restrict__ y, float* __restrict__ ld,
                 float* scratch, Dims d, Plan pl, int clamp_type, int reverse) {
  run_tile<IM>(x, cond, P, y, ld, scratch, d, pl, clamp_type, reverse != 0);
}

}  // namespace

extern "C" {

int glowchain_plan_ints() { return kPlanInts; }

#ifdef GLOW_PROFILE
int glowchain_read_profile(long long* out) { return read_profile(out); }
#endif

const char* glowchain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the chain on `stream`. Every param pointer is a stacked [K, ...]
// array in execution order. `scratch` holds clusters * rows * U
// floats where the plan sends the first hidden map through global memory,
// else it may be null. `plan` holds the launch plan's glowchain_plan_ints()
// ints. Returns the cudaError_t of the launch (0 on success).
int glowchain_launch(const float* x, const float* cond, const float* an_bias,
                     const float* an_logs, const float* w1x1, const float* wa,
                     const float* ana_bias, const float* ana_logs,
                     const float* wb, const float* anb_bias,
                     const float* anb_logs, const float* wc,
                     const float* bias_c, const float* clamp_scale,
                     const float* clamp_shift, float* y, float* ld,
                     float* scratch, const int* plan,
                     int B, int H, int W, int C, int Cc, int U,
                     int K, int clamp_type, int reverse, void* stream) {
  const StepParams P{an_bias, an_logs, w1x1, wa, ana_bias, ana_logs, wb,
                     anb_bias, anb_logs, wc, bias_c, clamp_scale, clamp_shift};
  const Dims d{B, H, W, C, Cc, U, K};
  const Plan pl = read_plan(plan, P);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (pl.im) {
    case 1:
      err = launch_clusters(glowchain_kernel<1>, pl, s, x, cond, P, y, ld, scratch,
                            d, pl, clamp_type, reverse);
      break;
    case 2:
      err = launch_clusters(glowchain_kernel<2>, pl, s, x, cond, P, y, ld, scratch,
                            d, pl, clamp_type, reverse);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
