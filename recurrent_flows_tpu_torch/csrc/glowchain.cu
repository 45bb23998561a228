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
// The per-step body is a device function (glowstep_body) so the
// whole-GlowStep kernel can reuse it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kCluster = 8;  // blocks per sample (the portable maximum)

struct StepParams {
  const float* an_bias;   // [C]
  const float* an_logs;   // [C]
  const float* w1x1;      // [C, C], y = x @ w1x1
  const float* wa;        // [9, CA, U]
  const float* ana_bias;  // [U]
  const float* ana_logs;  // [U]
  const float* wb;        // [U, U]
  const float* anb_bias;  // [U]
  const float* anb_logs;  // [U]
  const float* wc;        // [9, U, C], outputs: shift then raw log-scale
  const float* bias_c;    // [C]
  const float* clamp_scale;  // [C/2]
  const float* clamp_shift;  // [C/2]
};

struct Dims {
  int H, W, C, Cc, U;
};

__device__ __forceinline__ float clamp_s(float v, int clamp_type, float scale,
                                         float shift) {
  switch (clamp_type) {
    case 1:  // glow: log(sigmoid(v + 2))
      return logf(1.0f / (1.0f + expf(-(v + 2.0f))));
    case 2:  // softclamp
      return 2.5f * 0.636f * atanf(v / 2.5f);
    case 3:  // realnvp
      return scale * tanhf(v) + shift;
    default:  // none
      return v;
  }
}

// Shared-memory views of one block.
struct Smem {
  float* xs;     // [HW, C] the chain's carry (replicated in every block)
  float* tmp;    // [HW, C]
  float* part;   // [HW, C] this block's partial sums of the last conv
  float* shs;    // [HW, C/2] coupling shift
  float* ss;     // [HW, C/2] coupling s (clamped)
  float* red;    // [kThreads]
  float* inpad;  // [(H+2)(W+2), CA] zero-padded [z1 | cond]
};

// Barrier over the sample's cluster; the fence publishes this block's
// writes to the global scratch buffer to the other blocks.
__device__ __forceinline__ void cluster_sync() {
  __threadfence();
  cg::this_cluster().sync();
}

// y[p, :] = src[p, :] @ w  ([C, C]), for every position.
__device__ void matmul_c(const float* src, float* dst, const float* w, int hw,
                         int c) {
  for (int i = threadIdx.x; i < hw * c; i += blockDim.x) {
    int p = i / c, d = i - p * c;
    const float* row = src + p * c;
    float acc = 0.0f;
    for (int k = 0; k < c; ++k) acc = fmaf(row[k], w[k * c + d], acc);
    dst[i] = acc;
  }
}

// The coupling net on z1 = xs[:, :C/2] (cond already in inpad): leaves the
// shift and the clamped s in shared memory, identical in every block.
template <int PT>
__device__ void coupling_net(const Smem& sm, float* ha, float* hb,
                             const StepParams& p, const Dims& d,
                             int clamp_type, int rank) {
  const int hw = d.H * d.W, c2 = d.C / 2, ca = c2 + d.Cc, U = d.U;
  const int wp = d.W + 2;
  const int n_tiles = (hw + PT - 1) / PT;
  const int u0 = U * rank / kCluster, nu = U * (rank + 1) / kCluster - u0;

  for (int i = threadIdx.x; i < hw * c2; i += blockDim.x) {
    int q = i / c2, j = i - q * c2;
    int h = q / d.W, w = q - h * d.W;
    sm.inpad[((h + 1) * wp + w + 1) * ca + j] = sm.xs[q * d.C + j];
  }
  __syncthreads();

  // 3x3 conv [z1|cond] -> this block's hidden channels, actnorm, relu -> ha
  for (int item = threadIdx.x; item < n_tiles * nu; item += blockDim.x) {
    const int u = u0 + item % nu, p0 = (item / nu) * PT;
    float acc[PT];
    int hh[PT], ww[PT];
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      acc[j] = 0.0f;
      int q = min(p0 + j, hw - 1);
      hh[j] = q / d.W;
      ww[j] = q - hh[j] * d.W;
    }
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - dy * 3;
      const float* wt = p.wa + tap * ca * U + u;
      int off[PT];
#pragma unroll
      for (int j = 0; j < PT; ++j) off[j] = ((hh[j] + dy) * wp + ww[j] + dx) * ca;
      for (int ci = 0; ci < ca; ++ci) {
        const float wv = wt[ci * U];
#pragma unroll
        for (int j = 0; j < PT; ++j) acc[j] = fmaf(sm.inpad[off[j] + ci], wv, acc[j]);
      }
    }
    const float b = p.ana_bias[u], g = expf(p.ana_logs[u]);
#pragma unroll
    for (int j = 0; j < PT; ++j)
      if (p0 + j < hw) ha[(p0 + j) * U + u] = fmaxf((acc[j] + b) * g, 0.0f);
  }
  cluster_sync();

  // 1x1 conv U -> this block's hidden channels, actnorm, relu -> hb
  for (int item = threadIdx.x; item < n_tiles * nu; item += blockDim.x) {
    const int v = u0 + item % nu, p0 = (item / nu) * PT;
    float acc[PT];
    const float* rows[PT];
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      acc[j] = 0.0f;
      rows[j] = ha + min(p0 + j, hw - 1) * U;
    }
    for (int u = 0; u < U; ++u) {
      const float wv = p.wb[u * U + v];
#pragma unroll
      for (int j = 0; j < PT; ++j) acc[j] = fmaf(rows[j][u], wv, acc[j]);
    }
    const float b = p.anb_bias[v], g = expf(p.anb_logs[v]);
#pragma unroll
    for (int j = 0; j < PT; ++j)
      if (p0 + j < hw) hb[(p0 + j) * U + v] = fmaxf((acc[j] + b) * g, 0.0f);
  }
  cluster_sync();

  // 3x3 zero-conv U -> C (gain folded, 'cross' pre-permuted): this block's
  // share of the sum, over its own hidden channels
  for (int item = threadIdx.x; item < n_tiles * d.C; item += blockDim.x) {
    const int c = item % d.C, p0 = (item / d.C) * PT;
    float acc[PT];
#pragma unroll
    for (int j = 0; j < PT; ++j) acc[j] = 0.0f;
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const float* rows[PT];
      float mask[PT];
#pragma unroll
      for (int j = 0; j < PT; ++j) {
        int q = min(p0 + j, hw - 1);
        int h = q / d.W + dy, w = q % d.W + dx;
        bool ok = h >= 0 && h < d.H && w >= 0 && w < d.W;
        mask[j] = ok ? 1.0f : 0.0f;
        rows[j] = hb + (ok ? h * d.W + w : 0) * U;
      }
      const float* wt = p.wc + tap * U * d.C + c;
      for (int u = u0; u < u0 + nu; ++u) {
        const float wv = wt[u * d.C];
#pragma unroll
        for (int j = 0; j < PT; ++j) acc[j] = fmaf(mask[j] * rows[j][u], wv, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < PT; ++j)
      if (p0 + j < hw) sm.part[(p0 + j) * d.C + c] = acc[j];
  }
  cluster_sync();

  // every block adds the kCluster partial sums in rank order, then clamps
  cg::cluster_group cluster = cg::this_cluster();
  const float* parts[kCluster];
#pragma unroll
  for (int r = 0; r < kCluster; ++r) parts[r] = cluster.map_shared_rank(sm.part, r);
  for (int i = threadIdx.x; i < hw * d.C; i += blockDim.x) {
    const int q = i / d.C, c = i - q * d.C;
    float v = 0.0f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) v += parts[r][i];
    v += p.bias_c[c];
    if (c < c2) {
      sm.shs[q * c2 + c] = v;
    } else {
      const int k = c - c2;
      sm.ss[q * c2 + k] = clamp_s(v, clamp_type, p.clamp_scale[k], p.clamp_shift[k]);
    }
  }
  __syncthreads();
}

// One GlowStep on the block's replica of the carry sm.xs, forward or
// reverse. Adds this thread's share of the coupling logdet to ld_local.
template <int PT>
__device__ void glowstep_body(const Smem& sm, float* ha, float* hb,
                              const StepParams& p, const Dims& d,
                              int clamp_type, bool reverse, int rank,
                              float& ld_local) {
  const int hw = d.H * d.W, C = d.C, c2 = C / 2;
  if (!reverse) {
    for (int i = threadIdx.x; i < hw * C; i += blockDim.x) {
      const int c = i % C;
      sm.tmp[i] = (sm.xs[i] + p.an_bias[c]) * expf(p.an_logs[c]);
    }
    __syncthreads();
    matmul_c(sm.tmp, sm.xs, p.w1x1, hw, C);
    __syncthreads();
  }
  coupling_net<PT>(sm, ha, hb, p, d, clamp_type, rank);
  for (int i = threadIdx.x; i < hw * c2; i += blockDim.x) {
    const int q = i / c2, j = i - q * c2;
    const float s = sm.ss[i], sh = sm.shs[i];
    float* z2 = sm.xs + q * C + c2 + j;
    *z2 = reverse ? *z2 * expf(-s) - sh : (*z2 + sh) * expf(s);
    ld_local += s;
  }
  __syncthreads();
  if (reverse) {
    matmul_c(sm.xs, sm.tmp, p.w1x1, hw, C);
    __syncthreads();
    for (int i = threadIdx.x; i < hw * C; i += blockDim.x) {
      const int c = i % C;
      sm.xs[i] = sm.tmp[i] * expf(-p.an_logs[c]) - p.an_bias[c];
    }
    __syncthreads();
  }
}

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
  const int npad = (d.H + 2) * (d.W + 2) * ca;
  Smem sm;
  sm.xs = smem;
  sm.tmp = sm.xs + hw * C;
  sm.part = sm.tmp + hw * C;
  sm.shs = sm.part + hw * C;
  sm.ss = sm.shs + hw * c2;
  sm.red = sm.ss + hw * c2;
  sm.inpad = sm.red + blockDim.x;
  float* ha = scratch + (size_t)b * 2 * hw * U;
  float* hb = ha + (size_t)hw * U;

  const float* xb = x + (size_t)b * hw * C;
  const float* cb = cond + (size_t)b * hw * d.Cc;
  for (int i = threadIdx.x; i < hw * C; i += blockDim.x) sm.xs[i] = xb[i];
  for (int i = threadIdx.x; i < npad; i += blockDim.x) sm.inpad[i] = 0.0f;
  __syncthreads();
  // cond is the same for all K steps: place it once
  for (int i = threadIdx.x; i < hw * d.Cc; i += blockDim.x) {
    const int q = i / d.Cc, j = i - q * d.Cc;
    const int h = q / d.W, w = q - h * d.W;
    sm.inpad[((h + 1) * (d.W + 2) + w + 1) * ca + c2 + j] = cb[i];
  }
  __syncthreads();

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
  // no block may exit while another still reads its partial sums
  cg::this_cluster().sync();
  if (rank != 0) return;

  float* yb = y + (size_t)b * hw * C;
  for (int i = threadIdx.x; i < hw * C; i += blockDim.x) yb[i] = sm.xs[i];
  // fixed-order tree reduction: the logdet is the same from run to run
  sm.red[threadIdx.x] = ld_local;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sm.red[threadIdx.x] += sm.red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) ld[b] = sm.red[0];
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

// Bytes of dynamic shared memory one block needs.
size_t glowchain_smem_bytes(int H, int W, int C, int Cc) {
  const size_t hw = (size_t)H * W, ca = C / 2 + Cc;
  return sizeof(float) *
         (4 * hw * C + kThreads + (size_t)(H + 2) * (W + 2) * ca);
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
  const size_t smem = glowchain_smem_bytes(H, W, C, Cc);
  auto s = static_cast<cudaStream_t>(stream);
  // 8-position tiles, or 4 where a map has fewer than 16 positions
  const cudaError_t err =
      H * W >= 16
          ? launch<8>(x, cond, P, y, ld, scratch, B, d, K, clamp_type, reverse, smem, s)
          : launch<4>(x, cond, P, y, ld, scratch, B, d, K, clamp_type, reverse, smem, s);
  return static_cast<int>(err);
}

}  // extern "C"
