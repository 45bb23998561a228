// K GlowSteps of one flow scale in one launch (Hopper, sm_90a).
//
// Replaces the TPU kernel recurrent_flows_tpu/ops/pallas/glowchain.py
// (_glowchain_pallas / _kernel): the whole K-step chain of a small-spatial
// scale with x kept on chip between the steps. Computes what glowchain_ref
// (recurrent_flows_tpu_torch/ops/glowchain.py) computes, forward and
// reverse, with all four clamps: (y, sum over steps of the coupling logdet).
//
// What bounds it on the H100: the coupling net's weights (0.67-3.5 MB per
// step at U=256) and its FMAs, for a batch of only a few samples. With one
// block per sample only B of the 132 SMs work, and each block streams all
// the weights of every step from L2.
//
// Design: one thread-block cluster of kCluster blocks per sample, looping
// over the K steps. Every block of the cluster keeps a replica of x
// ([H*W, C], at most 8 KB), of the zero-padded coupling input [z1 | cond]
// and of the coupling's shift and s in shared memory, and does the cheap
// per-position work (actnorm, the C x C 1x1, the affine) redundantly. The
// heavy work is split: block r computes hidden channels [U*r/n, U*(r+1)/n)
// of the 3x3 conv and of the 1x1 conv (the two [H*W, U] hidden maps go to
// a global scratch buffer, 256 KB per sample at 16x16), so it reads only
// its 1/n of those weights, which then stay in L1; for the last 3x3 it
// sums over its own hidden channels, and every block adds the n partial
// sums through distributed shared memory in the same fixed order, so all
// replicas hold the same shift and s and the logdet is the same from run
// to run. Phases are separated by cluster barriers. The products are FMA
// loops, each thread holding a PT-position register tile so that one
// weight load feeds PT FMAs; no wgmma, no TMA yet.
//
// What still bounds it: every cluster reads all the weights of its scale,
// so each launch re-reads them B times from L2 (and from device memory
// when the other scales' weights have evicted them: ~72 MB per frame at
// rfn_mnist_production, beyond the 50 MB L2). Tiling the rows of several
// samples into one cluster, so that one weight load feeds them all, is the
// next step.
//
// The per-step body and the per-sample load and store are device functions
// in glowstep_body.cuh, shared with the whole-GlowStep kernel (glowstep.cu).

#include "glowstep_body.cuh"

namespace {

template <int PT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
glowchain_kernel(const float* __restrict__ x, const float* __restrict__ cond,
                 StepParams P, float* __restrict__ y, float* __restrict__ ld,
                 float* __restrict__ scratch, Dims d, int K, int clamp_type,
                 int reverse) {
  extern __shared__ float smem[];
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int b = blockIdx.x / kCluster;
  const int hw = d.H * d.W, C = d.C, c2 = C / 2, ca = c2 + d.Cc, U = d.U;
  const Smem sm = carve_smem(smem, d);
  float* ha = scratch + (size_t)b * 2 * hw * U;
  float* hb = ha + (size_t)hw * U;
  load_sample(sm, x, cond, d, b);

  float ld_local = 0.0f;
  for (int k = 0; k < K; ++k) {
    StepParams p;
    p.an_bias = P.an_bias + k * C;
    p.an_logs = P.an_logs + k * C;
    p.w1x1 = P.w1x1 + (size_t)k * C * C;
    p.wa = P.wa + (size_t)k * 9 * ca * U;
    p.ana_bias = P.ana_bias + k * U;
    p.ana_logs = P.ana_logs + k * U;
    p.wb = P.wb + (size_t)k * U * U;
    p.anb_bias = P.anb_bias + k * U;
    p.anb_logs = P.anb_logs + k * U;
    p.wc = P.wc + (size_t)k * 9 * U * C;
    p.bias_c = P.bias_c + k * C;
    p.clamp_scale = P.clamp_scale + k * c2;
    p.clamp_shift = P.clamp_shift + k * c2;
    glowstep_body<PT>(sm, ha, hb, p, d, clamp_type, reverse != 0, rank, ld_local);
  }
  store_sample(sm, y, ld, d, b, rank, ld_local);
}

template <int PT>
cudaError_t launch(const float* x, const float* cond, const StepParams& P,
                   float* y, float* ld, float* scratch, int B, const Dims& d,
                   int K, int clamp_type, int reverse, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      glowchain_kernel<PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  glowchain_kernel<PT><<<B * kCluster, kThreads, smem, stream>>>(
      x, cond, P, y, ld, scratch, d, K, clamp_type, reverse);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

size_t glowchain_smem_bytes(int H, int W, int C, int Cc) {
  return smem_bytes(H, W, C, Cc);
}

const char* glowchain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the chain on `stream`. Every param pointer is a stacked [K, ...]
// array in execution order. scratch holds B * 2 * H*W * U floats.
// Returns the cudaError_t of the launch (0 on success).
int glowchain_launch(const float* x, const float* cond, const float* an_bias,
                     const float* an_logs, const float* w1x1, const float* wa,
                     const float* ana_bias, const float* ana_logs,
                     const float* wb, const float* anb_bias,
                     const float* anb_logs, const float* wc,
                     const float* bias_c, const float* clamp_scale,
                     const float* clamp_shift, float* y, float* ld,
                     float* scratch, int B, int H, int W, int C, int Cc, int U,
                     int K, int clamp_type, int reverse, void* stream) {
  StepParams P{an_bias, an_logs, w1x1, wa, ana_bias, ana_logs, wb,
               anb_bias, anb_logs, wc, bias_c, clamp_scale, clamp_shift};
  Dims d{H, W, C, Cc, U};
  const size_t smem = smem_bytes(H, W, C, Cc);
  auto s = static_cast<cudaStream_t>(stream);
  // 8-position tiles, or 4 where a map has fewer than 16 positions
  const cudaError_t err =
      H * W >= 16
          ? launch<8>(x, cond, P, y, ld, scratch, B, d, K, clamp_type, reverse, smem, s)
          : launch<4>(x, cond, P, y, ld, scratch, B, d, K, clamp_type, reverse, smem, s);
  return static_cast<int>(err);
}

}  // extern "C"
