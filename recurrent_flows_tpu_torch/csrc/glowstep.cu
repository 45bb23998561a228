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
// What bounds it on the H100: operations. One step at U=256 is 2*H*W*(9*CA*U
// + U*U + 9*U*C) float32 FLOPs per sample (0.2 GFLOP at 16x16, far less
// below), against 0.7-3.5 MB of weights read once; at a batch of 30 the
// weights are reread from L2 by every sample's cluster.
//
// Design: the per-step body of the chain kernel (glowstep_body.cuh) on one
// thread-block cluster of kCluster blocks per sample: every block keeps a
// replica of x and of the padded coupling input in shared memory, computes
// 1/kCluster of the hidden channels of the two hidden convs into a global
// scratch buffer and 1/kCluster of the last conv's reduction, and the
// partial sums are added in rank order through distributed shared memory, so
// the logdet is the same from run to run. FMA loops with PT-position
// register tiles; no wgmma, no TMA. The TPU kernel tiles the batch into one
// program (_pick_batch_tile); here a cluster works on one sample, which at
// 2x2 and 4x4 maps leaves most threads of a block idle in the per-position
// phases. Tiling several samples into a cluster is the next step.

#include "glowstep_body.cuh"

namespace {

template <int PT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
glowstep_kernel(const float* __restrict__ x, const float* __restrict__ cond,
                StepParams p, float* __restrict__ y, float* __restrict__ ld,
                float* __restrict__ scratch, Dims d, int clamp_type,
                int reverse) {
  extern __shared__ float smem[];
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int b = blockIdx.x / kCluster;
  const int hw = d.H * d.W;
  const Smem sm = carve_smem(smem, d);
  float* ha = scratch + (size_t)b * 2 * hw * d.U;
  float* hb = ha + (size_t)hw * d.U;
  load_sample(sm, x, cond, d, b);
  float ld_local = 0.0f;
  glowstep_body<PT>(sm, ha, hb, p, d, clamp_type, reverse != 0, rank, ld_local);
  store_sample(sm, y, ld, d, b, rank, ld_local);
}

template <int PT>
cudaError_t launch(const float* x, const float* cond, const StepParams& p,
                   float* y, float* ld, float* scratch, int B, const Dims& d,
                   int clamp_type, int reverse, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      glowstep_kernel<PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  glowstep_kernel<PT><<<B * kCluster, kThreads, smem, stream>>>(
      x, cond, p, y, ld, scratch, d, clamp_type, reverse);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

size_t glowstep_smem_bytes(int H, int W, int C, int Cc) {
  return smem_bytes(H, W, C, Cc);
}

const char* glowstep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches one GlowStep on `stream`. Every param pointer is one step's
// array (not stacked). scratch holds B * 2 * H*W * U floats.
// Returns the cudaError_t of the launch (0 on success).
int glowstep_launch(const float* x, const float* cond, const float* an_bias,
                    const float* an_logs, const float* w1x1, const float* wa,
                    const float* ana_bias, const float* ana_logs,
                    const float* wb, const float* anb_bias,
                    const float* anb_logs, const float* wc,
                    const float* bias_c, const float* clamp_scale,
                    const float* clamp_shift, float* y, float* ld,
                    float* scratch, int B, int H, int W, int C, int Cc, int U,
                    int clamp_type, int reverse, void* stream) {
  StepParams p{an_bias, an_logs, w1x1, wa, ana_bias, ana_logs, wb,
               anb_bias, anb_logs, wc, bias_c, clamp_scale, clamp_shift};
  Dims d{H, W, C, Cc, U};
  const size_t smem = smem_bytes(H, W, C, Cc);
  auto s = static_cast<cudaStream_t>(stream);
  // 8-position tiles, or 4 where a map has fewer than 16 positions
  const cudaError_t err =
      H * W >= 16
          ? launch<8>(x, cond, p, y, ld, scratch, B, d, clamp_type, reverse, smem, s)
          : launch<4>(x, cond, p, y, ld, scratch, B, d, clamp_type, reverse, smem, s);
  return static_cast<int>(err);
}

}  // extern "C"
