// One whole GlowStep in one launch (Hopper, sm_90a).
//
// Replaces the TPU kernel recurrent_flows_tpu/ops/pallas/glowstep.py
// (_glowstep_pallas / _kernel): actnorm, the assembled 1x1, the coupling net
// (3x3 conv on [z1 | cond], actnorm, relu, 1x1, actnorm, relu, 3x3 zero-conv
// with its gain folded and its outputs 'cross'-permuted), the clamp, the
// affine on z2 and the per-sample sum of s, forward or inverse, with every
// intermediate kept on chip. Computes what glowstep_ref
// (recurrent_flows_tpu_torch/ops/glowstep.py) computes: (y, coupling logdet).
//
// What bounds it on the H100: one step at U=256 is 2*H*W*(9*CA*U + U*U +
// 9*U*C) float32 FLOPs per sample against 0.7-3.5 MB of weights read once:
// operations by the count. But at a batch of 30 on maps of 2x2 to 16x16 the
// launch lasts 35-175 microseconds, of which the set-up, the first weights'
// trip from L2 and the barriers between the phases are a large part on the
// small maps, and the FMA loops' third of the FFMA peak on the large one.
//
// Design: the chain kernel's device code with K = 1: a cluster of 8 blocks
// per batch tile of whole samples, the hidden channels split over the
// blocks, hidden maps and partial sums in distributed shared memory (the
// first hidden map of a tile of 64 rows or more through L2), the weights
// streamed through a cp.async ring whose first chunks are requested before
// the samples are loaded, 4x4 register tiles with the reduction split
// inside a block, sums in a fixed order.
//
// The device code is glowstep_body.cuh, shared with the chain kernel
// (glowchain.cu); its header note has the design in full. The launch
// geometry comes from ops/glowstep.py::launch_plan as glowstep_plan_ints()
// ints.

#include "glowstep_body.cuh"

namespace {

template <int IM>
__global__ void __launch_bounds__(kThreads)
glowstep_kernel(const float* __restrict__ x, const float* __restrict__ cond,
                StepParams P, float* __restrict__ y, float* __restrict__ ld,
                float* scratch, Dims d, Plan pl, int clamp_type, int reverse) {
  run_tile<IM>(x, cond, P, y, ld, scratch, d, pl, clamp_type, reverse != 0);
}

}  // namespace

extern "C" {

int glowstep_plan_ints() { return kPlanInts; }

#ifdef GLOW_PROFILE
int glowstep_read_profile(long long* out) { return read_profile(out); }
#endif

const char* glowstep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches one GlowStep on `stream`. Every param pointer is one step's array
// (not stacked). `scratch` holds clusters * rows * U
// floats where the plan sends the first hidden map through global memory,
// else it may be null. `plan` holds the launch plan's glowstep_plan_ints()
// ints. Returns the cudaError_t of the launch (0 on success).
int glowstep_launch(const float* x, const float* cond, const float* an_bias,
                    const float* an_logs, const float* w1x1, const float* wa,
                    const float* ana_bias, const float* ana_logs,
                    const float* wb, const float* anb_bias,
                    const float* anb_logs, const float* wc,
                    const float* bias_c, const float* clamp_scale,
                    const float* clamp_shift, float* y, float* ld,
                    float* scratch, const int* plan,
                    int B, int H, int W, int C, int Cc, int U,
                    int clamp_type, int reverse, void* stream) {
  const StepParams P{an_bias, an_logs, w1x1, wa, ana_bias, ana_logs, wb,
                     anb_bias, anb_logs, wc, bias_c, clamp_scale, clamp_shift};
  const Dims d{B, H, W, C, Cc, U, 1};
  const Plan pl = read_plan(plan, P);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (pl.im) {
    case 1:
      err = launch_clusters(glowstep_kernel<1>, pl, s, x, cond, P, y, ld, scratch,
                            d, pl, clamp_type, reverse);
      break;
    case 2:
      err = launch_clusters(glowstep_kernel<2>, pl, s, x, cond, P, y, ld, scratch,
                            d, pl, clamp_type, reverse);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
